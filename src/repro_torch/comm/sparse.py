"""``SparseTransport``: top-k + error-feedback compressed sums.

Counterpart of ``repro/comm/sparse.py``.  Each worker keeps only the k
largest-|x| entries of its payload plus its residual; the (value, index)
pairs are what a ring all-gather among M devices would carry, ``(M-1) * k *
8`` bytes per participant instead of the dense ``2 (M-1)/M * N * 4``.  The
entries left out stay in the worker's residual and join the next call's
payload (error feedback), so nothing is lost, only delayed.

  * Only sums are compressed.  ``op="mean"`` rides a dense ``XlaTransport``
    that shares this transport's log, so ``AverageMerge`` and the eval
    reduce over this transport are the dense ones, recorded under
    ``"xla"``.
  * The transport is stateful: ``init_state(x)`` is the f32 residual,
    shaped like the stacked payload (M, ...), one per worker.  A
    ``state=None`` call runs without a residual and returns ``None``.
  * ``masked_all_reduce`` is eq. 9's masked merge: every worker selects (the
    wire is paid either way), a worker whose bit is 0 contributes zeros and
    keeps its residual.

The reference all-gathers the pairs and scatter-adds them.  Here the
workers are one stacked tensor: each worker's values are scattered at its
indices into a zeroed (M, N) tensor (``scatter_``, no accumulation: one
worker's indices are distinct), and that tensor is summed over dimension 0
in f32, the reduction ``XlaTransport.all_reduce`` runs.  So where the top k
hold every non-zero entry, the sparse sum equals the dense one bit for bit.
Float atomics (``index_add_``, ``scatter_add_`` across workers) would make
the order of additions differ from run to run, so none is used.  The
selection is ``ops.vq_topk`` (the top-k kernel on the card), and ``k``
comes from shapes, so a call never waits on the device.
"""

from __future__ import annotations

import copy

import torch

from repro_torch.comm.api import (WORKER_AXIS, CommRecord, Transport,
                                  tree_f32_bytes)
from repro_torch.comm.xla import XlaTransport
from repro_torch.kernels import ops, vq_fused


def topk_count(size: int, frac: float) -> int:
    """Entries kept per worker: ``max(1, int(frac * size))``, the
    reference's convention."""
    return max(1, int(frac * size))


def sparse_allsum(x: torch.Tensor, residual: torch.Tensor, frac: float,
                  mask: torch.Tensor | None = None, *, select=ops.vq_topk
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparse sum over the workers of x (M, ...) with error feedback.

    Returns ``(summed f32 shaped like x[0], new residual shaped like x)``.
    With ``mask`` (M,) given, a worker whose bit is 0 contributes zeros and
    keeps its residual.  ``select`` is the selection, ``ops.vq_topk`` or
    its plain version."""
    m = x.shape[0]
    full = (x.to(torch.float32) + residual).reshape(m, -1)
    vals, idx, new_res = select(full, topk_count(full.shape[1], frac))
    if mask is not None:
        keep = mask.to(torch.float32)[:, None]
        vals = vals * keep
        new_res = torch.where(keep != 0, new_res, residual.reshape(m, -1))
    gathered = torch.zeros_like(full).scatter_(1, idx.long(), vals)
    summed = torch.sum(gathered.view(x.shape), dim=0)
    return summed, new_res.view(x.shape)


class SparseTransport(Transport):
    """Top-k/error-feedback sums; dense ``XlaTransport`` for means."""

    name = "sparse"
    stateful = True

    def __init__(self, frac: float = 0.01):
        super().__init__()
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"compression frac must be in (0, 1], got {frac}")
        self.frac = frac
        self.select = ops.vq_topk
        # the dense sidecar shares this log, so its records land in the
        # same stream under their own transport name
        self._dense = XlaTransport()
        self._dense.log = self.log

    def init_state(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    def plain(self) -> SparseTransport:
        out = copy.copy(self)    # shares the log and the dense sidecar
        out.select = vq_fused.vq_topk_plain
        return out

    def _sparse_sum(self, x, mask, *, op: str, state, tag: str):
        m = x.shape[0]
        n = x[0].numel()
        self.log.append(CommRecord(
            op=op, transport=self.name, axis=WORKER_AXIS, participants=m,
            logical_bytes=tree_f32_bytes(x[0]),
            wire_bytes=(m - 1) * topk_count(n, self.frac) * 8 if m > 1 else 0,
            tag=tag))
        residual = self.init_state(x) if state is None else state
        summed, new_res = sparse_allsum(x, residual, self.frac, mask,
                                        select=self.select)
        return summed, (None if state is None else new_res)

    def all_reduce(self, x: torch.Tensor, *, op: str = "sum", state=None,
                   tag: str = "merge") -> tuple[torch.Tensor, object]:
        if op == "mean":
            out, _ = self._dense.all_reduce(x, op="mean", tag=tag)
            return out, state
        if op != "sum":
            raise ValueError(
                f"unknown reduce op {op!r}; choose 'sum' or 'mean'")
        return self._sparse_sum(x, None, op="sum", state=state, tag=tag)

    def masked_all_reduce(self, x: torch.Tensor, mask: torch.Tensor, *,
                          state=None, tag: str = "merge"
                          ) -> tuple[torch.Tensor, object]:
        m = x.shape[0]
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        return self._sparse_sum(x, mask, op="masked_sum", state=state,
                                tag=tag)
