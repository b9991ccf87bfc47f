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

With ``group=`` (one worker a process, ``distributed.process_group``) a
payload is this rank's rows ``(1, ...)``, and so is the residual: the rank
selects its top k at ``(1, N)``, the (value, index) pairs of every leaf go
out in one ``all_gather`` of int32 words over the group (the values as
their bits), and each rank scatters the gathered (M, k) pairs into a zeroed (M,
N) tensor in rank order and sums it over dimension 0 in f32, the stacked
run's own op.  So a group run equals the stacked run bit for bit, and the
records' ``participants`` is the group's size, so the wire bytes are the
stacked run's too.  A masked call applies this rank's (1,) entry; means
ride ``XlaTransport(group=)``.
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


def sparse_allsum_group(leaves, residuals, frac: float, group,
                        mask: torch.Tensor | None = None, *,
                        select=ops.vq_topk) -> tuple[list, list]:
    """``sparse_allsum`` over the ranks of ``group``, each leaf this rank's
    rows (1, ...): one ``all_gather`` carries every leaf's (value, index)
    pairs.  Returns ``(the sums, f32 shaped like a leaf's row, the new
    residuals, shaped like the leaves)``."""
    from repro_torch.distributed import process_group
    fulls, sent, new_res = [], [], []
    for leaf, residual in zip(leaves, residuals, strict=True):
        full = (leaf.to(torch.float32) + residual).reshape(1, -1)
        vals, idx, res = select(full, topk_count(full.shape[1], frac))
        if mask is not None:
            keep = mask.to(torch.float32)[:, None]
            vals = vals * keep
            res = torch.where(keep != 0, res, residual.reshape(1, -1))
        fulls.append(full)
        sent += [vals[0].contiguous().view(torch.int32),
                 idx[0].to(torch.int32)]
        new_res.append(res.view(leaf.shape))
    gathered = process_group.all_gather(torch.cat(sent), group)
    sums, at = [], 0
    for leaf, full in zip(leaves, fulls):
        k = topk_count(full.shape[1], frac)
        vals = gathered[:, at:at + k].contiguous().view(torch.float32)
        idx = gathered[:, at + k:at + 2 * k]
        at += 2 * k
        scattered = torch.zeros((gathered.shape[0], full.shape[1]),
                                dtype=torch.float32, device=full.device)
        scattered.scatter_(1, idx.long(), vals)
        sums.append(torch.sum(
            scattered.view(gathered.shape[0], *leaf.shape[1:]), dim=0))
    return sums, new_res


class SparseTransport(Transport):
    """Top-k/error-feedback sums; dense ``XlaTransport`` for means."""

    name = "sparse"
    stateful = True

    def __init__(self, frac: float = 0.01, group=None):
        super().__init__()
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"compression frac must be in (0, 1], got {frac}")
        self.frac = frac
        self.group = group
        self.select = ops.vq_topk
        # the dense sidecar shares this log, so its records land in the
        # same stream under their own transport name
        self._dense = XlaTransport(group=group)
        self._dense.log = self.log

    def workers(self, x) -> int:
        return self._dense.workers(x)

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
        m = self.workers(x)
        wire = sum((m - 1) * topk_count(leaf[0].numel(), self.frac) * 8
                   for leaf in leaves) if m > 1 else 0
        self.log.append(CommRecord(
            op=op, transport=self.name, axis=WORKER_AXIS, participants=m,
            logical_bytes=worker_f32_bytes(x), wire_bytes=wire, calls=calls,
            tag=tag))
        residuals, _ = as_leaves(self.init_state(x) if state is None
                                 else state)
        if self.group is not None:
            sums, res = sparse_allsum_group(leaves, residuals, self.frac,
                                            self.group, mask,
                                            select=self.select)
        else:
            outs = [sparse_allsum(leaf, r, self.frac, mask,
                                  select=self.select)
                    for leaf, r in zip(leaves, residuals, strict=True)]
            sums, res = [o[0] for o in outs], [o[1] for o in outs]
        return (from_leaves(sums, is_tuple),
                None if state is None else from_leaves(res, is_tuple))

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
        m = as_leaves(x)[0][0].shape[0]       # this rank's one over a group
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        return self._sparse_sum(x, mask, op="masked_sum", state=state,
                                calls=calls, tag=tag)
