"""``XlaTransport``: the dense transport, counterpart of ``repro/comm/xla.py``.

The reference reduces with XLA's psum/pmean; here the workers are the
leading dimension of one tensor, so the reduction is a plain f32
``sum``/``mean`` over dimension 0 (stock ops, as the reference's psum is
stock XLA), and the eq.-9 masked sum the same way.  Means cast back to the
input dtype.  The record name stays ``"xla"`` so byte summaries compare
with the reference's one for one.  ``_sum`` and ``_mean`` are the hooks
``RingTransport`` overrides, as the reference's ``_sum_leaf`` and
``_mean_leaf`` are; a tuple payload reduces leaf by leaf under one record
whose wire is the ring's on the leaves' summed bytes.
"""

from __future__ import annotations

import torch

from repro_torch.comm.api import (WORKER_AXIS, CommRecord, Transport,
                                  as_leaves, from_leaves, ring_wire_bytes,
                                  worker_f32_bytes)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32 (itself when it is: the cast's call costs host time on
    every collective)."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


class XlaTransport(Transport):
    """Dense f32 reduction over the stacked worker dimension."""

    name = "xla"

    def _sum(self, x: torch.Tensor, mask: torch.Tensor | None = None
             ) -> torch.Tensor:
        """The f32 sum over workers of x (or of mask[i] * x[i])."""
        if mask is not None:
            x = mask.view(x.shape[0], *(1,) * (x.dim() - 1)) * x
        return torch.sum(_f32(x), dim=0)

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 mean over workers, cast back to x's dtype."""
        out = torch.mean(_f32(x), dim=0)
        return out if x.dtype == torch.float32 else out.to(x.dtype)

    def _record(self, op: str, m: int, logical: int, *, tag: str) -> None:
        self.log.append(CommRecord(
            op=op, transport=self.name, axis=WORKER_AXIS, participants=m,
            logical_bytes=logical, wire_bytes=ring_wire_bytes(logical, m),
            tag=tag))

    def all_reduce(self, x, *, op: str = "sum", state=None,
                   tag: str = "merge"):
        """x (M, ...) or a tuple of them -> (the f32 sum over workers, or
        their mean cast back to x's dtype, per leaf; the state, passed
        through)."""
        leaves, is_tuple = as_leaves(x)
        m = leaves[0].shape[0]
        if op == "sum":
            self._record("sum", m, worker_f32_bytes(x), tag=tag)
            return from_leaves([self._sum(leaf) for leaf in leaves],
                               is_tuple), state
        if op == "mean":
            if not all(leaf.is_floating_point() for leaf in leaves):
                raise ValueError(
                    f"a mean reduces floats, got "
                    f"{[leaf.dtype for leaf in leaves]}")
            self._record("mean", m, worker_f32_bytes(x, floating_only=True),
                         tag=tag)
            return from_leaves([self._mean(leaf) for leaf in leaves],
                               is_tuple), state
        raise ValueError(f"unknown reduce op {op!r}; choose 'sum' or 'mean'")

    def masked_all_reduce(self, x, mask: torch.Tensor, *, state=None,
                          tag: str = "merge"):
        """x (M, ...) or a tuple of them, mask (M,) -> (sum_i mask[i] * x[i]
        in f32 per leaf, the state, passed through)."""
        leaves, is_tuple = as_leaves(x)
        m = leaves[0].shape[0]
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        self._record("masked_sum", m, worker_f32_bytes(x), tag=tag)
        return from_leaves([self._sum(leaf, mask) for leaf in leaves],
                           is_tuple), state
