"""The window kernel: tau sequential eq.-1 steps for M stacked workers.

Counterpart of the window part of ``repro/kernels/vq_fused.py``
(``_window_kernel`` / ``vq_window_pallas``).  The CUDA source is
``csrc/vq_window.cu``; it says what bounds the kernel and how.

``vq_window`` launches the kernel for CUDA tensors and takes the plain
version ``vq_window_plain`` for CPU tensors only.  ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from repro_torch.core import vq
from repro_torch.kernels import _build

#: Blocks per worker (one thread-block cluster); mirrors csrc/vq_window.cu.
CLUSTER_BLOCKS = 8
#: Warps per block; mirrors csrc/vq_window.cu.
WARPS = 16

launches = 0


def smem_bytes(kappa: int, d: int) -> int:
    """Shared memory one block of the window kernel holds: the norms of its
    ``ceil(kappa / 8)`` rows, the double-buffered point, the per-warp and
    per-block argmin partials.  The codebook itself streams from global
    memory, so ``tau`` does not enter."""
    rows = -(-kappa // CLUSTER_BLOCKS)
    return 4 * (rows + 2 * d) + 8 * (WARPS + 2)


def vq_window_plain(zwin: torch.Tensor, w0: torch.Tensor,
                    eps: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the tau-step loop over ``core/vq.py``.

    zwin (M, tau, d), w0 (kappa, d) shared, eps (tau,) -> w (M, kappa, d).
    """
    w = w0.expand(zwin.shape[0], *w0.shape).clone()
    for t in range(zwin.shape[1]):
        w = w - eps[t] * vq.H(zwin[:, t], w)
    return w


def _check(zwin: torch.Tensor, w0: torch.Tensor, eps: torch.Tensor) -> None:
    if zwin.dim() != 3 or w0.dim() != 2 or eps.dim() != 1:
        raise ValueError(
            f"vq_window takes zwin (M, tau, d), w0 (kappa, d), eps (tau,); "
            f"got {tuple(zwin.shape)}, {tuple(w0.shape)}, {tuple(eps.shape)}")
    m, tau, d = zwin.shape
    if w0.shape[1] != d or eps.shape[0] != tau:
        raise ValueError(
            f"shape mismatch: zwin {tuple(zwin.shape)}, w0 {tuple(w0.shape)}, "
            f"eps {tuple(eps.shape)}")
    for name, x in (("zwin", zwin), ("w0", w0), ("eps", eps)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != zwin.device:
            raise ValueError(f"{name} is on {x.device}, zwin on {zwin.device}")


def vq_window(zwin: torch.Tensor, w0: torch.Tensor,
              eps: torch.Tensor) -> torch.Tensor:
    """One window for every worker: zwin (M, tau, d), w0 (kappa, d), eps
    (tau,) f32 -> w (M, kappa, d) after tau sequential eq.-1 steps.

    Callers check ``ops.window_fits`` first.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    global launches
    _check(zwin, w0, eps)
    if zwin.device.type == "cpu":
        return vq_window_plain(zwin, w0, eps)
    if zwin.device.type != "cuda":
        raise ValueError(f"vq_window runs on cuda or cpu, got {zwin.device}")
    for name, x in (("zwin", zwin), ("w0", w0), ("eps", eps)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, tau, d = zwin.shape
    kappa = w0.shape[0]
    if m == 0 or kappa == 0 or d == 0:
        raise ValueError("vq_window needs M, kappa and d > 0")
    if m > 65535:
        raise ValueError(f"M={m} is past the launch grid's limit of 65535")
    wout = torch.empty((m, kappa, d), dtype=torch.float32, device=zwin.device)
    lib = _build.library()
    with torch.cuda.device(zwin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vq_window_f32(zwin.data_ptr(), w0.data_ptr(), eps.data_ptr(),
                               wout.data_ptr(), m, tau, kappa, d, stream)
    _build.check(rc, "vq_window_f32")
    launches += 1
    return wout
