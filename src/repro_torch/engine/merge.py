"""Merge strategies, the paper's reducing phases.  Counterpart of
``repro/engine/merge.py`` for the sync strategies and the sparse delta merge.

A strategy is ``(merged, state) = strategy(w0, w_local, state=None)``:
``w0`` is the window's shared starting codebook (kappa, d), ``w_local`` the
workers' codebooks after tau local steps, stacked (M, kappa, d).  The
strategy decides what to reduce; its ``Transport`` reduces over the worker
dimension and accounts the bytes.  ``state`` is the transport's (the sparse
transport's per-worker residual, (M, kappa, d)): a ``stateful`` strategy is
seeded with ``init_state(w_local)`` and fed its state back every window.
No ported strategy owns state of its own yet.
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

    @property
    def stateful(self) -> bool:
        return self.transport.stateful

    def init_state(self, w_local: torch.Tensor):
        """The transport's state for stacked codebooks like ``w_local``."""
        return self.transport.init_state(w_local)

    def __call__(self, w0: torch.Tensor, w_local: torch.Tensor, state=None
                 ) -> tuple[torch.Tensor, object]:
        raise NotImplementedError


class AverageMerge(MergeStrategy):
    """Paper eq. (3): w_srd = mean_i w^i(tau), the scheme that does NOT
    speed convergence up (Section 2's negative result)."""

    name = "average"

    def __call__(self, w0, w_local, state=None):
        del w0
        merged, _ = self.transport.all_reduce(w_local, op="mean")
        # means ride dense on every transport: the state passes through
        return merged, state


class DeltaMerge(MergeStrategy):
    """Paper eq. (8): w_srd = w0 - sum_i Delta^i, displacement merging."""

    name = "delta"

    def __call__(self, w0, w_local, state=None):
        total, state = self.transport.all_reduce(
            tree_sub_f32(w0, w_local), op="sum", state=state)
        return tree_apply_delta(w0, total), state


class SparseDeltaMerge(DeltaMerge):
    """Eq. (8) over the top-k/error-feedback ``SparseTransport``; its state
    is the per-worker residual."""

    name = "delta_sparse"

    def __init__(self, transport: comm.Transport | None = None, *,
                 frac: float | None = None):
        if transport is None:
            transport = comm.get_transport(
                "sparse", frac=0.01 if frac is None else frac)
        elif frac is not None and getattr(transport, "frac", frac) != frac:
            # an explicit transport AND a conflicting frac: refuse rather
            # than compress at a rate the caller did not ask for
            raise ValueError(
                f"frac={frac} conflicts with the supplied transport's "
                f"frac={transport.frac}; configure one place only")
        super().__init__(transport)


_STRATEGIES = {"average": AverageMerge, "delta": DeltaMerge,
               "delta_sparse": SparseDeltaMerge}


def get_merge(name: str, transport: comm.Transport | None = None, **kwargs
              ) -> MergeStrategy:
    """Factory: 'average' | 'delta' | 'delta_sparse' (``frac=``)."""
    if name not in _STRATEGIES:
        raise ValueError(
            f"unknown merge strategy {name!r}; choose from "
            f"{sorted(_STRATEGIES)}")
    return _STRATEGIES[name](transport, **kwargs)
