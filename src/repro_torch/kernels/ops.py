"""Public wrappers over the port's kernels, and the residency predicates
that route between them.  Counterpart of ``repro/kernels/ops.py``.

The reference plans residency against a TPU core's VMEM
(``DEFAULT_VMEM_BUDGET_BYTES = 8 MiB``) and aligns batch blocks to 8 rows
for the TPU's sublanes (``_bm_floor``).  Neither applies on Hopper.  Here a
kernel "fits" when each of its blocks fits the shared memory one block may
use on an H100, 227 KB (232,448 bytes), counting what the port's own
kernels hold there (``vq_fused.smem_bytes``, ``vq_assign.smem_bytes``).
Both kernels stream the codebook from global memory, so the budget bounds
kappa/8 + 2d floats for the window kernel and a (32, d) tile for the delta
kernel; at the slice's width (kappa=4096, d=128) both fit by far.  The port
does not pad batches, so no row floor exists.

Where the full-codebook delta kernel does not fit, the reference takes its
blocked assign+delta kernel; that kernel is not ported yet, so
``vq_delta_routed`` and ``vq_delta_topk`` raise ``NotImplementedError``
instead of taking another route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import vq_assign as assign_kernels
from repro_torch.kernels import vq_fused

#: Shared memory one block may use on an H100 (dynamic, after opting in).
SMEM_BUDGET_BYTES = 232_448


def window_fits(kappa: int, d: int) -> bool:
    """Can the window kernel run a (kappa, d) codebook?"""
    return vq_fused.smem_bytes(kappa, d) <= SMEM_BUDGET_BYTES


def delta_fits(d: int) -> bool:
    """Can the full-codebook delta kernel run at width d?"""
    return assign_kernels.smem_bytes(d) <= SMEM_BUDGET_BYTES


def vq_assign(z: torch.Tensor, w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-prototype ``(assign int32, mind f32)``; the contract of
    ``ref.vq_assign_ref``, with optional leading worker dimension.  The
    serving read path (``serve.lookup``) goes through it."""
    return assign_kernels.vq_assign(z, w)


def vq_delta(z: torch.Tensor, w: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minibatch displacement statistics ``(counts, zsum)``; the contract of
    ``ref.vq_delta_ref``, with optional leading worker dimension."""
    counts, zsum, _, _ = assign_kernels.vq_delta(z, w)
    return counts, zsum


def distortion(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean min distance (paper eq. 2 per worker) through the delta
    kernel: z (..., B, d), w (..., kappa, d) -> (...)."""
    _, _, mind, _ = assign_kernels.vq_delta(z, w)
    return torch.mean(mind, dim=-1)


def _require_delta_fits(d: int) -> None:
    if not delta_fits(d):
        raise NotImplementedError(
            f"d={d} is past the delta kernel's shared-memory budget; the "
            f"blocked assign+delta kernel that would take it "
            f"(repro/kernels/vq_fused.py::_fused_delta_kernel) is still to "
            f"port: ROADMAP.md queue 2, row 3")


def vq_delta_routed(z: torch.Tensor, w: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``vq_delta`` where the full-codebook kernel fits the shared-memory
    budget; past it, the reference's blocked kernel, which is not ported."""
    _require_delta_fits(w.shape[-1])
    return vq_delta(z, w)


def vq_topk(full: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse transport's selection: for each row of full (M, N), the k
    largest-|x| entries ``(vals (M, k), idx (M, k) int32)`` in ascending
    index order and the error-feedback residual ``full - kept`` (M, N)."""
    return vq_fused.vq_topk(full, k)


def vq_delta_topk(z: torch.Tensor, w: torch.Tensor, residual: torch.Tensor,
                  *, frac: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eq.-8 displacement with the error-feedback carry folded in,
    ``counts * w - zsum + residual``, compressed to the sparse transport's
    payload with ``k = max(1, int(frac * kappa * d))`` (the convention of
    ``comm.sparse.topk_count``).

    z (B, d), w and residual (kappa, d) -> (vals (k,), idx (k,) int32,
    new residual (kappa, d)); with a leading worker dimension M on all
    three, each output gains it.  Past the delta kernel's budget the
    reference takes its blocked kernel's epilogue, which is not ported."""
    _require_delta_fits(w.shape[-1])
    if residual.shape != w.shape:
        raise ValueError(f"residual must be shaped like w {tuple(w.shape)}, "
                         f"got {tuple(residual.shape)}")
    counts, zsum = vq_delta(z, w)
    full = counts.unsqueeze(-1) * w - zsum + residual
    flat = full.reshape(-1, w.shape[-2] * w.shape[-1])
    vals, idx, new_res = vq_topk(flat, max(1, int(frac * flat.shape[1])))
    if w.dim() == 2:
        return vals[0], idx[0], new_res.view(w.shape)
    return vals, idx, new_res.view(w.shape)


def vq_window(zwin: torch.Tensor, w0: torch.Tensor,
              eps: torch.Tensor) -> torch.Tensor:
    """One window for every worker in a single launch; callers check
    ``window_fits`` first."""
    return vq_fused.vq_window(zwin, w0, eps)
