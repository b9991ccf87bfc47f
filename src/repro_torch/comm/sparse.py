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
  * A tuple payload selects leaf by leaf (k per leaf, one residual per
    leaf, the state a tuple) under one record, charged the sum over leaves
    of ``(M-1) * k * 8``, as the reference charges a pytree.

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
                                  as_leaves, from_leaves, worker_f32_bytes)
from repro_torch.comm.xla import XlaTransport
from repro_torch.kernels import ops, vq_fused


def topk_count(size: int, frac: float) -> int:
    """Entries kept per worker: ``max(1, int(frac * size))``, the
    reference's convention."""
    return max(1, int(frac * size))


def topk_threshold_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Dense 0/1 mask, x's shape and dtype, keeping the ``frac``
    largest-|x| entries: every entry at or above the k-th largest
    magnitude, so ties widen the mask.  The reference selects with stock
    ``lax.top_k`` here, not its Pallas kernel, so ``torch.topk`` serves;
    ``optim.compression.topk_compress`` uses it."""
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, topk_count(flat.numel(), frac)).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


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

    def init_state(self, x):
        leaves, is_tuple = as_leaves(x)
        return from_leaves([torch.zeros(leaf.shape, dtype=torch.float32,
                                        device=leaf.device)
                            for leaf in leaves], is_tuple)

    def plain(self) -> SparseTransport:
        out = copy.copy(self)    # shares the log and the dense sidecar
        out.select = vq_fused.vq_topk_plain
        return out

    def _sparse_sum(self, x, mask, *, op: str, state, calls: int,
                    tag: str):
        leaves, is_tuple = as_leaves(x)
        m = leaves[0].shape[0]
        wire = sum((m - 1) * topk_count(leaf[0].numel(), self.frac) * 8
                   for leaf in leaves) if m > 1 else 0
        self.log.append(CommRecord(
            op=op, transport=self.name, axis=WORKER_AXIS, participants=m,
            logical_bytes=worker_f32_bytes(x), wire_bytes=wire, calls=calls,
            tag=tag))
        residuals, _ = as_leaves(self.init_state(x) if state is None
                                 else state)
        outs = [sparse_allsum(leaf, res, self.frac, mask, select=self.select)
                for leaf, res in zip(leaves, residuals, strict=True)]
        new_state = from_leaves([o[1] for o in outs], is_tuple)
        return (from_leaves([o[0] for o in outs], is_tuple),
                None if state is None else new_state)

    def all_reduce(self, x, *, op: str = "sum", state=None, calls: int = 1,
                   tag: str = "merge"):
        if op == "mean":
            out, _ = self._dense.all_reduce(x, op="mean", calls=calls,
                                            tag=tag)
            return out, state
        if op != "sum":
            raise ValueError(
                f"unknown reduce op {op!r}; choose 'sum' or 'mean'")
        return self._sparse_sum(x, None, op="sum", state=state, calls=calls,
                                tag=tag)

    def masked_all_reduce(self, x, mask: torch.Tensor, *, state=None,
                          calls: int = 1, tag: str = "merge"):
        m = as_leaves(x)[0][0].shape[0]
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        return self._sparse_sum(x, mask, op="masked_sum", state=state,
                                calls=calls, tag=tag)
