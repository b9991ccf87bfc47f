"""The assign and delta kernels: nearest prototype per point, and the
delta kernel's counts and zsum.

Counterpart of ``repro/kernels/vq_assign.py`` (``_assign_kernel`` /
``vq_assign_pallas`` and ``_delta_kernel`` / ``vq_delta_pallas``), with a
leading worker dimension: the reference's 2-D signatures are the case M=1.
Both kernels live in ``csrc/vq_delta.cu``, which says what bounds them and
how; the assign kernel is the delta kernel's first three passes, so the
two assign with the same bits.

``vq_assign`` and ``vq_delta`` launch their kernels for CUDA tensors and
take the plain versions (``vq_assign_plain``, ``vq_delta_plain``) for CPU
tensors only.  ``launches_assign`` and ``launches`` count the wrappers'
launches; an assign launch is three CUDA kernel launches in a row (row
norms, partial argmin, combine), a delta launch one at B <= ``SMALL_B``
(the sweep) and four past it (then accumulate).  The kappa chunk
(``kchunk``) comes from ``kernels.autotune`` unless the caller gives one;
it changes no bit.  The sweep's tickets and partials are kept per device
and stream (``_sweep_scratch``); the kernel leaves the tickets as it found
them, so no launch depends on host work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import vq
from repro_torch.kernels import _build, autotune

#: Codebook rows per block of the argmin pass before tuning (the kappa split
#: that gives a batch of one its parallelism); ``autotune``'s ``off`` tiles.
KCHUNK = 256
#: Points per block of the argmin pass; mirrors csrc/vq_delta.cu.
ROWS = 8
#: Codebook rows per owner block of the accumulate pass; mirrors the source.
OWN_ROWS = 32
#: Assignments staged per sweep of the accumulate pass; mirrors the source.
CHUNK = 256
#: Largest batch the delta kernel's one-launch sweep takes; mirrors the
#: source (kSmallB).
SMALL_B = 8
#: Shared memory one block may use on an H100 (dynamic, after opting in);
#: mirrors csrc/vq_common.cuh's kSmemMax.
SMEM_MAX = 232_448

launches = 0
launches_assign = 0


def argmin_smem_bytes(d: int) -> int:
    """Shared memory of one argmin-pass block: its 8 points when they fit
    (d <= 7,247), plus the 8 norms and the 8x8 per-warp partials; past
    that the points are read in place and only the rest stays."""
    fixed = 4 * ROWS + 8 * ROWS * ROWS
    staged = 4 * ROWS * d + fixed
    return staged if staged <= SMEM_MAX else fixed


def accumulate_smem_bytes(d: int) -> int:
    """Shared memory of one accumulate-pass block: a (32, d) zsum tile, 256
    staged assignments and 32 counts."""
    return 4 * (OWN_ROWS * d + CHUNK + OWN_ROWS)


def sweep_smem_bytes(b: int, d: int) -> int:
    """Shared memory of one block of the delta kernel's sweep (B <= 8): its
    B points, and for ``kB`` = 1 or 8 point slots the norms, the per-warp
    partials, the winners and a flag."""
    kb = 1 if b == 1 else SMALL_B
    return 4 * b * d + 4 * kb * (2 + 2 * ROWS) + 4


def smem_bytes(d: int) -> int:
    """Shared memory of the delta kernel's largest block at any batch, the
    accumulate pass's (the argmin pass and the sweep hold at most 8 points
    and their partials, less).  The codebook streams from global memory, so
    kappa does not enter."""
    return max(accumulate_smem_bytes(d), argmin_smem_bytes(d),
               sweep_smem_bytes(SMALL_B, d))


def vq_assign_plain(z: torch.Tensor, w: torch.Tensor):
    """The assign kernel's plain version: z (..., B, d), w (..., kappa, d)
    -> (assign (..., B) int32, mind (..., B) f32), first index on ties."""
    mind, assign = torch.min(vq.squared_distances(z, w), dim=-1)
    return assign.to(torch.int32), mind


def vq_delta_plain(z: torch.Tensor, w: torch.Tensor):
    """The kernel's plain version: argmin, one-hot, counts, one-hot^T @ z.

    z (..., B, d), w (..., kappa, d) -> (counts (..., kappa),
    zsum (..., kappa, d), mind (..., B), assign (..., B) int32)."""
    assign, mind = vq_assign_plain(z, w)
    onehot = F.one_hot(assign.long(), w.shape[-2]).to(z.dtype)
    counts = torch.sum(onehot, dim=-2)
    zsum = onehot.transpose(-1, -2) @ z
    return counts, zsum, mind, assign


def check_inputs(z: torch.Tensor, w: torch.Tensor, name: str) -> None:
    """Raise unless z (B, d), w (kappa, d) or z (M, B, d), w (M, kappa, d)
    are float32 on one device."""
    if z.dim() != w.dim() or z.dim() not in (2, 3):
        raise ValueError(
            f"{name} takes z (B, d), w (kappa, d) or z (M, B, d), "
            f"w (M, kappa, d); got {tuple(z.shape)}, {tuple(w.shape)}")
    if z.shape[:-2] != w.shape[:-2] or z.shape[-1] != w.shape[-1]:
        raise ValueError(
            f"shape mismatch: z {tuple(z.shape)}, w {tuple(w.shape)}")
    for arg, x in (("z", z), ("w", w)):
        if x.dtype != torch.float32:
            raise ValueError(f"{arg} must be float32, got {x.dtype}")
    if z.device != w.device:
        raise ValueError(f"z is on {z.device}, w on {w.device}")


def argmin_buffers(m: int, b: int, kappa: int, kchunk: int,
                   dev: torch.device) -> tuple[torch.Tensor, ...]:
    """Outputs and scratch of the argmin passes on ``dev``:
    ``(mind (M, B), assign (M, B) int32, w2 (M, kappa), pmin, pidx
    (M, B, ceil(kappa / kchunk)))``."""
    if kchunk < 1:
        raise ValueError(f"kchunk must be >= 1, got {kchunk}")
    s = -(-kappa // kchunk)
    f32 = torch.float32
    return (torch.empty((m, b), dtype=f32, device=dev),
            torch.empty((m, b), dtype=torch.int32, device=dev),
            torch.empty((m, kappa), dtype=f32, device=dev),
            torch.empty((m, b, s), dtype=f32, device=dev),
            torch.empty((m, b, s), dtype=torch.int32, device=dev))


def stacked_dims(z: torch.Tensor, w: torch.Tensor, name: str
                 ) -> tuple[int, int, int, int]:
    """``(M, B, kappa, d)`` of contiguous CUDA inputs (the 2-D form is
    M=1), after checking what the launch grid takes."""
    for arg, x in (("z", z), ("w", w)):
        if not x.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    m = z.shape[0] if z.dim() == 3 else 1
    b, d = z.shape[-2:]
    kappa = w.shape[-2]
    if m == 0 or b == 0 or kappa == 0 or d == 0:
        raise ValueError(f"{name} needs M, B, kappa and d > 0")
    if m > 65535 or -(-b // ROWS) > 65535:
        raise ValueError(f"M={m}, B={b} is past the launch grid's limits")
    return m, b, kappa, d


_scratch: dict[tuple, tuple[torch.Tensor, ...]] = {}  # (device, stream)


def _sweep_scratch(dev: torch.device, stream: int, m: int, n: int
                   ) -> tuple[torch.Tensor, ...]:
    """The sweep's ``(tickets (>= M,) int32, all 0; pmin (>= n,) f32; pidx
    (>= n,) int32)`` for launches on ``stream``, kept across calls: the
    kernel puts every ticket back to 0, and overwrites the partials before
    it reads them.  Grown, never shrunk; a launch on another stream gets
    its own, so two streams never share a ticket."""
    key = (dev, stream)
    got = _scratch.get(key)
    if got is None or got[0].numel() < m or got[1].numel() < n:
        mc = max(m, 0 if got is None else got[0].numel())
        nc = max(n, 0 if got is None else got[1].numel())
        got = _scratch[key] = (
            torch.zeros(mc, dtype=torch.int32, device=dev),
            torch.empty(nc, dtype=torch.float32, device=dev),
            torch.empty(nc, dtype=torch.int32, device=dev))
    return got


def _launch(z: torch.Tensor, w: torch.Tensor, name: str, stats: bool,
            kchunk: int | None = None):
    """Launch ``vq_assign_f32`` (``stats`` False) or ``vq_delta_f32`` on
    CUDA tensors; returns ``(counts, zsum, mind, assign)``, the first two
    None without ``stats``.  Counts no launch (the wrappers do)."""
    m, b, kappa, d = stacked_dims(z, w, name)
    dev = z.device
    if kchunk is None:
        kchunk = autotune.pick_tiles(b, kappa, d, m=m, device=dev,
                                     kind="delta" if stats else "assign"
                                     ).kchunk
    elif kchunk < 1:
        raise ValueError(f"kchunk must be >= 1, got {kchunk}")
    f32 = torch.float32
    lib = _build.library()
    with _build.on_device(dev):
        stream = _build.current_stream(dev)
        if stats and b <= SMALL_B:   # the sweep: no norms, no scratch made
            tickets, pmin, pidx = _sweep_scratch(dev, stream, m,
                                                 m * b * -(-kappa // kchunk))
            counts = torch.empty((m, kappa), dtype=f32, device=dev)
            zsum = torch.empty((m, kappa, d), dtype=f32, device=dev)
            mind = torch.empty((m, b), dtype=f32, device=dev)
            assign = torch.empty((m, b), dtype=torch.int32, device=dev)
            rc = lib.vq_delta_f32(z.data_ptr(), w.data_ptr(),
                                  counts.data_ptr(), zsum.data_ptr(),
                                  mind.data_ptr(), assign.data_ptr(), None,
                                  pmin.data_ptr(), pidx.data_ptr(),
                                  tickets.data_ptr(), m, b, kappa, d, kchunk,
                                  stream)
        else:
            mind, assign, w2, pmin, pidx = argmin_buffers(m, b, kappa, kchunk,
                                                          dev)
            counts = zsum = None
            tail = (w2.data_ptr(), pmin.data_ptr(), pidx.data_ptr())
            dims = (m, b, kappa, d, kchunk, stream)
            if stats:
                counts = torch.empty((m, kappa), dtype=f32, device=dev)
                zsum = torch.empty((m, kappa, d), dtype=f32, device=dev)
                rc = lib.vq_delta_f32(z.data_ptr(), w.data_ptr(),
                                      counts.data_ptr(), zsum.data_ptr(),
                                      mind.data_ptr(), assign.data_ptr(),
                                      *tail, None, *dims)
            else:
                rc = lib.vq_assign_f32(z.data_ptr(), w.data_ptr(),
                                       mind.data_ptr(), assign.data_ptr(),
                                       *tail, *dims)
    _build.check(rc, f"{name}_f32")
    if z.dim() == 2:
        return (None if counts is None else counts[0],
                None if zsum is None else zsum[0], mind[0], assign[0])
    return counts, zsum, mind, assign


def on_cuda(z: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain version);
    raises for any other device."""
    if z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {z.device}")
    return z.device.type == "cuda"


def vq_assign(z: torch.Tensor, w: torch.Tensor, *, kchunk: int | None = None):
    """Nearest prototype of z (M, B, d) in w (M, kappa, d) (or the 2-D case
    M=1): ``(assign int32, mind f32)`` as ``vq_assign_plain``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream."""
    global launches_assign
    check_inputs(z, w, "vq_assign")
    if not on_cuda(z, "vq_assign"):
        return vq_assign_plain(z, w)
    _, _, mind, assign = _launch(z, w, "vq_assign", stats=False,
                                 kchunk=kchunk)
    launches_assign += 1
    return assign, mind


def vq_delta(z: torch.Tensor, w: torch.Tensor, *, kchunk: int | None = None):
    """Assignment statistics of z (M, B, d) against w (M, kappa, d) (or the
    2-D case M=1): ``(counts, zsum, mind, assign)`` as ``vq_delta_plain``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream."""
    global launches
    check_inputs(z, w, "vq_delta")
    if not on_cuda(z, "vq_delta"):
        return vq_delta_plain(z, w)
    out = _launch(z, w, "vq_delta", stats=True, kchunk=kchunk)
    launches += 1
    return out
