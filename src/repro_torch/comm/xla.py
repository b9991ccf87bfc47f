"""``XlaTransport``: the dense transport, counterpart of ``repro/comm/xla.py``.

The reference reduces with XLA's psum/pmean; here the workers are the
leading dimension of one tensor, so the reduction is a plain f32
``sum``/``mean`` over dimension 0 (stock ops, as the reference's psum is
stock XLA), and the eq.-9 masked sum the same way.  Means cast back to the
input dtype.  The record name stays ``"xla"`` so byte summaries compare
with the reference's one for one.
"""

from __future__ import annotations

import torch

from repro_torch.comm.api import (WORKER_AXIS, CommRecord, Transport,
                                  ring_wire_bytes, tree_f32_bytes)


class XlaTransport(Transport):
    """Dense f32 reduction over the stacked worker dimension."""

    name = "xla"

    def _record(self, op: str, m: int, logical: int, *, tag: str) -> None:
        self.log.append(CommRecord(
            op=op, transport=self.name, axis=WORKER_AXIS, participants=m,
            logical_bytes=logical, wire_bytes=ring_wire_bytes(logical, m),
            tag=tag))

    def all_reduce(self, x: torch.Tensor, *, op: str = "sum",
                   tag: str = "merge") -> torch.Tensor:
        """x (M, ...) -> the f32 sum over workers, or their mean cast back
        to x's dtype."""
        m = x.shape[0]
        if op == "sum":
            self._record("sum", m, tree_f32_bytes(x[0]), tag=tag)
            return torch.sum(x.to(torch.float32), dim=0)
        if op == "mean":
            if not x.is_floating_point():
                raise ValueError(f"a mean reduces floats, got {x.dtype}")
            self._record("mean", m, tree_f32_bytes(x[0], floating_only=True),
                         tag=tag)
            return torch.mean(x.to(torch.float32), dim=0).to(x.dtype)
        raise ValueError(f"unknown reduce op {op!r}; choose 'sum' or 'mean'")

    def masked_all_reduce(self, x: torch.Tensor, mask: torch.Tensor, *,
                          tag: str = "merge") -> torch.Tensor:
        """x (M, ...), mask (M,) -> sum_i mask[i] * x[i] in f32."""
        m = x.shape[0]
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        self._record("masked_sum", m, tree_f32_bytes(x[0]), tag=tag)
        masked = mask.view(m, *(1,) * (x.dim() - 1)) * x
        return torch.sum(masked.to(torch.float32), dim=0)
