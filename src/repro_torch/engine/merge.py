"""Merge strategies, the paper's reducing phases.  Counterpart of
``repro/engine/merge.py`` for the two sync strategies.

A strategy is ``merged = strategy(w0, w_local)``: ``w0`` is the window's
shared starting codebook (kappa, d), ``w_local`` the workers' codebooks
after tau local steps, stacked (M, kappa, d).  The strategy decides what
to reduce; its ``Transport`` reduces over the worker dimension and accounts
the bytes.  The reference threads a state through stateful strategies;
neither sync strategy has one, so the port drops it until a stateful one
is ported.
"""

from __future__ import annotations

import torch

from repro_torch import comm


def tree_sub_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` in f32 (the displacement Delta of paper eq. 7)."""
    return a.to(torch.float32) - b.to(torch.float32)


def tree_apply_delta(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``base - delta`` with the subtraction in f32, result in base dtype."""
    return (base.to(torch.float32) - delta).to(base.dtype)


class MergeStrategy:
    """Base strategy over a ``repro_torch.comm`` transport (default: dense)."""

    name = "base"

    def __init__(self, transport: comm.Transport | None = None):
        self.transport = (transport if transport is not None
                          else comm.get_transport("xla"))

    def __call__(self, w0: torch.Tensor, w_local: torch.Tensor
                 ) -> torch.Tensor:
        raise NotImplementedError


class AverageMerge(MergeStrategy):
    """Paper eq. (3): w_srd = mean_i w^i(tau), the scheme that does NOT
    speed convergence up (Section 2's negative result)."""

    name = "average"

    def __call__(self, w0, w_local):
        del w0
        return self.transport.all_reduce(w_local, op="mean")


class DeltaMerge(MergeStrategy):
    """Paper eq. (8): w_srd = w0 - sum_i Delta^i, displacement merging."""

    name = "delta"

    def __call__(self, w0, w_local):
        total = self.transport.all_reduce(tree_sub_f32(w0, w_local), op="sum")
        return tree_apply_delta(w0, total)


_STRATEGIES = {"average": AverageMerge, "delta": DeltaMerge}


def get_merge(name: str, transport: comm.Transport | None = None
              ) -> MergeStrategy:
    """Factory: 'average' | 'delta'."""
    if name not in _STRATEGIES:
        raise ValueError(
            f"unknown merge strategy {name!r}; choose from "
            f"{sorted(_STRATEGIES)}")
    return _STRATEGIES[name](transport)
