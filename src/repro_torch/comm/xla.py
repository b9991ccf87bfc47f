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

With ``group=`` (one worker a process, ``distributed.process_group``) a
payload is this rank's rows ``(1, ...)`` and a sum is a ``dist.all_reduce``
over the group, the masked form multiplying by this rank's (1,) mask entry
first.  A mean gathers the group's rows in rank order and takes the stacked
mean over them, so it is the stacked run's bits (the eval's scalars, the
dense sidecar of the sparse transport, a host group's partials).  Records
keep the stacked run's fields: ``participants`` is the group's size, so
the wire bytes equal the stacked run's exactly.
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
    """Dense f32 reduction over the stacked worker dimension, or over a
    process group's ranks (``group=``)."""

    name = "xla"

    def __init__(self, group=None):
        super().__init__()
        self.group = group

    def _workers(self, x: torch.Tensor) -> int:
        """The reduction's participants: the stacked rows, or the group's
        ranks (x holding this rank's one row)."""
        if self.group is None:
            return x.shape[0]
        if x.shape[0] != 1:
            raise ValueError(
                f"over a process group a payload is this rank's rows (1, "
                f"...), got {tuple(x.shape)}")
        from repro_torch.distributed import process_group
        return process_group.group_size(self.group)

    def workers(self, x) -> int:
        return self._workers(as_leaves(x)[0][0])

    def _sum(self, x: torch.Tensor, mask: torch.Tensor | None = None
             ) -> torch.Tensor:
        """The f32 sum over workers of x (or of mask[i] * x[i])."""
        if mask is not None:
            x = mask.view(x.shape[0], *(1,) * (x.dim() - 1)) * x
        if self.group is not None:
            from repro_torch.distributed import process_group
            return process_group.all_reduce(_f32(x[0]).clone(), "sum",
                                            self.group)
        return torch.sum(_f32(x), dim=0)

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 mean over workers, cast back to x's dtype.  A
        non-floating leaf passes through, as in the reference: every worker
        keeps its own, and the result holds worker 0's (this rank's over a
        group)."""
        if not x.is_floating_point():
            return x[0]
        if self.group is not None:
            from repro_torch.distributed import process_group
            self._workers(x)                         # checks x is one row
            x = process_group.all_gather(x[0], self.group)
        out = torch.mean(_f32(x), dim=0)
        return out if x.dtype == torch.float32 else out.to(x.dtype)

    def _record(self, op: str, m: int, logical: int, *, calls: int,
                tag: str) -> None:
        self.log.append(CommRecord(
            op=op, transport=self.name, axis=WORKER_AXIS, participants=m,
            logical_bytes=logical, wire_bytes=ring_wire_bytes(logical, m),
            calls=calls, tag=tag))

    def all_reduce(self, x, *, op: str = "sum", state=None, calls: int = 1,
                   tag: str = "merge"):
        """x (M, ...) or a tuple of them -> (the f32 sum over workers, or
        their mean cast back to x's dtype, per leaf, non-floating leaves
        passing through; the state, passed through)."""
        leaves, is_tuple = as_leaves(x)
        m = self._workers(leaves[0])
        if op == "sum":
            self._record("sum", m, worker_f32_bytes(x), calls=calls, tag=tag)
            return from_leaves([self._sum(leaf) for leaf in leaves],
                               is_tuple), state
        if op == "mean":
            self._record("mean", m, worker_f32_bytes(x, floating_only=True),
                         calls=calls, tag=tag)
            return from_leaves([self._mean(leaf) for leaf in leaves],
                               is_tuple), state
        raise ValueError(f"unknown reduce op {op!r}; choose 'sum' or 'mean'")

    def masked_all_reduce(self, x, mask: torch.Tensor, *, state=None,
                          calls: int = 1, tag: str = "merge"):
        """x (M, ...) or a tuple of them, mask (M,) -> (sum_i mask[i] * x[i]
        in f32 per leaf, the state, passed through)."""
        leaves, is_tuple = as_leaves(x)
        rows = leaves[0].shape[0]
        m = self._workers(leaves[0])
        if mask.shape != (rows,):
            raise ValueError(f"mask must be ({rows},), got "
                             f"{tuple(mask.shape)}")
        self._record("masked_sum", m, worker_f32_bytes(x), calls=calls,
                     tag=tag)
        return from_leaves([self._sum(leaf, mask) for leaf in leaves],
                           is_tuple), state
