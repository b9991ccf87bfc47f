"""The delta kernel: assignment, counts, zsum and min distance per point.

Counterpart of the delta part of ``repro/kernels/vq_assign.py``
(``_delta_kernel`` / ``vq_delta_pallas``), with a leading worker dimension:
the reference's 2-D signature is the case M=1.  The CUDA source is
``csrc/vq_delta.cu``; it says what bounds the kernel and how.

``vq_delta`` launches the kernel for CUDA tensors and takes the plain
version ``vq_delta_plain`` for CPU tensors only.  ``launches`` counts the
wrapper's launches of the kernel; each is four CUDA kernel launches in a
row (row norms, partial argmin, combine, accumulate).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import vq
from repro_torch.kernels import _build

#: Codebook rows per block of the argmin pass (the kappa split that gives a
#: batch of one its parallelism).
KCHUNK = 256
#: Points per block of the argmin pass; mirrors csrc/vq_delta.cu.
ROWS = 8
#: Codebook rows per owner block of the accumulate pass; mirrors the source.
OWN_ROWS = 32
#: Assignments staged per sweep of the accumulate pass; mirrors the source.
CHUNK = 256

launches = 0


def smem_bytes(d: int) -> int:
    """Shared memory of the delta kernel's largest block: the accumulate
    pass holds a (32, d) zsum tile, 256 staged assignments and 32 counts
    (the argmin pass holds 8 points and 8x8 partials, less).  The codebook
    streams from global memory, so kappa does not enter."""
    accumulate = 4 * (OWN_ROWS * d + CHUNK + OWN_ROWS)
    argmin = 4 * (ROWS * d + ROWS) + 8 * ROWS * ROWS
    return max(accumulate, argmin)


def vq_delta_plain(z: torch.Tensor, w: torch.Tensor):
    """The kernel's plain version: argmin, one-hot, counts, one-hot^T @ z.

    z (..., B, d), w (..., kappa, d) -> (counts (..., kappa),
    zsum (..., kappa, d), mind (..., B), assign (..., B) int32)."""
    d2 = vq.squared_distances(z, w)
    mind, assign = torch.min(d2, dim=-1)
    onehot = F.one_hot(assign, w.shape[-2]).to(torch.float32)
    counts = torch.sum(onehot, dim=-2)
    zsum = onehot.transpose(-1, -2) @ z
    return counts, zsum, mind, assign.to(torch.int32)


def _check(z: torch.Tensor, w: torch.Tensor) -> None:
    if z.dim() != w.dim() or z.dim() not in (2, 3):
        raise ValueError(
            f"vq_delta takes z (B, d), w (kappa, d) or z (M, B, d), "
            f"w (M, kappa, d); got {tuple(z.shape)}, {tuple(w.shape)}")
    if z.shape[:-2] != w.shape[:-2] or z.shape[-1] != w.shape[-1]:
        raise ValueError(
            f"shape mismatch: z {tuple(z.shape)}, w {tuple(w.shape)}")
    for name, x in (("z", z), ("w", w)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if z.device != w.device:
        raise ValueError(f"z is on {z.device}, w on {w.device}")


def vq_delta(z: torch.Tensor, w: torch.Tensor):
    """Assignment statistics of z (M, B, d) against w (M, kappa, d) (or the
    2-D case M=1): ``(counts, zsum, mind, assign)`` as ``vq_delta_plain``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream."""
    global launches
    _check(z, w)
    if z.device.type == "cpu":
        return vq_delta_plain(z, w)
    if z.device.type != "cuda":
        raise ValueError(f"vq_delta runs on cuda or cpu, got {z.device}")
    for name, x in (("z", z), ("w", w)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    flat = z.dim() == 2
    if flat:
        z, w = z.unsqueeze(0), w.unsqueeze(0)
    m, b, d = z.shape
    kappa = w.shape[1]
    if m == 0 or b == 0 or kappa == 0 or d == 0:
        raise ValueError("vq_delta needs M, B, kappa and d > 0")
    if m > 65535 or -(-b // ROWS) > 65535:
        raise ValueError(f"M={m}, B={b} is past the launch grid's limits")
    s = -(-kappa // KCHUNK)
    dev = z.device
    counts = torch.empty((m, kappa), dtype=torch.float32, device=dev)
    zsum = torch.empty((m, kappa, d), dtype=torch.float32, device=dev)
    mind = torch.empty((m, b), dtype=torch.float32, device=dev)
    assign = torch.empty((m, b), dtype=torch.int32, device=dev)
    w2 = torch.empty((m, kappa), dtype=torch.float32, device=dev)
    pmin = torch.empty((m, b, s), dtype=torch.float32, device=dev)
    pidx = torch.empty((m, b, s), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vq_delta_f32(
            z.data_ptr(), w.data_ptr(), counts.data_ptr(), zsum.data_ptr(),
            mind.data_ptr(), assign.data_ptr(), w2.data_ptr(),
            pmin.data_ptr(), pidx.data_ptr(), m, b, kappa, d, KCHUNK, stream)
    _build.check(rc, "vq_delta_f32")
    launches += 1
    if flat:
        return counts[0], zsum[0], mind[0], assign[0]
    return counts, zsum, mind, assign
