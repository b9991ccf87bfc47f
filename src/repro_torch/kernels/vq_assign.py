"""The assign and delta kernels: nearest prototype per point, and the
delta kernel's counts and zsum.

Counterpart of ``repro/kernels/vq_assign.py`` (``_assign_kernel`` /
``vq_assign_pallas`` and ``_delta_kernel`` / ``vq_delta_pallas``), with a
leading worker dimension: the reference's 2-D signatures are the case M=1.
Both kernels live in ``csrc/vq_delta.cu``, which says what bounds them and
how; both, and the blocked kernel, assign through one argmin engine, so
they assign with the same bits.  Its launch plan, the route (the sweep at
B <= ``SMALL_B``, the tiled argmin past it), its grid, shared memory,
tickets and partials, is the pure function ``argmin_plan``, which the
wrappers, the tuner and the tests read.

``vq_assign`` and ``vq_delta`` launch their kernels for CUDA tensors and
take the plain versions (``vq_assign_plain``, ``vq_delta_plain``) for CPU
tensors only.  ``launches_assign`` and ``launches`` count the wrappers'
launches; an assign launch is one CUDA kernel launch, a delta launch one
at B <= ``SMALL_B`` (the sweep) and two past it (the tiled argmin, then
the accumulate pass).  The kappa chunk (``kchunk``) comes from
``kernels.autotune`` unless the caller gives one; it changes no bit.  The
engine's tickets and partials are kept per device and stream
(``_sweep_scratch``); the kernels leave the tickets as they found them, so
no launch depends on host work.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import vq
from repro_torch.kernels import _build, autotune

#: Codebook rows per block of the argmin engine before tuning (the kappa
#: split that gives a small batch its parallelism); ``autotune``'s ``off``
#: tiles.
KCHUNK = 256
#: Codebook rows per owner block of the accumulate pass; mirrors
#: csrc/vq_delta.cu.
OWN_ROWS = 32
#: Assignments staged per sweep of the accumulate pass; mirrors the source.
CHUNK = 256
#: Largest batch the argmin engine's sweep takes; mirrors the source
#: (vq::kSmallB).
SMALL_B = 8
#: The tiled route (B > SMALL_B): points per block, the codebook rows and
#: columns a block stages at once, and the stages its ring holds; mirror
#: the source.
TILE_POINTS, TILE_ROWS, TILE_COLS, TILE_STAGES = 32, 16, 128, 4
#: Bound on the static shared memory of a sweep or tiled block (partials,
#: norms, the ticket's flag); mirrors the source's kStaticSmem.
STATIC_SMEM = 1024
#: Shared memory one block may use on an H100 (dynamic, after opting in);
#: mirrors csrc/vq_common.cuh's kSmemMax.
SMEM_MAX = 232_448

launches = 0
launches_assign = 0


class ArgminPlan(NamedTuple):
    """One launch of the argmin engine.  ``route`` "sweep" (B <=
    ``SMALL_B``: a block per kappa chunk and worker, with all B points,
    ``staged`` in shared memory where they fit, else read in place) or
    "tiled" (a block per kappa chunk, ``TILE_POINTS`` points and worker;
    ``staged``: the point tile staged once, d <= ``TILE_COLS``, else beside
    each column tile).  ``grid`` is (kappa chunks, point tiles, M);
    ``smem_bytes`` a block's dynamic shared memory plus the bound on its
    static; ``tickets`` and ``partials`` the scratch the launch takes."""
    route: str
    staged: bool
    grid: tuple[int, int, int]
    smem_bytes: int
    tickets: int
    partials: int


def argmin_plan(m: int, b: int, kappa: int, d: int, kchunk: int
                ) -> ArgminPlan:
    """The argmin engine's launch for z (M, B, d) against w (M, kappa, d)
    at kappa chunk ``kchunk``, as csrc/vq_delta.cu makes it: the sweep
    exactly at B <= 8, every block within 232,448 B of shared memory.  The
    plan changes no bit."""
    if min(m, b, kappa, d) < 1:
        raise ValueError(f"the argmin needs M, B, kappa and d > 0, got "
                         f"({m}, {b}, {kappa}, {d})")
    if kchunk < 1:
        raise ValueError(f"kchunk must be >= 1, got {kchunk}")
    s = -(-kappa // kchunk)
    if b <= SMALL_B:
        staged = 4 * b * d + STATIC_SMEM <= SMEM_MAX
        return ArgminPlan("sweep", staged, (s, 1, m),
                          (4 * b * d if staged else 0) + STATIC_SMEM, m,
                          m * b * s)
    tiles = -(-b // TILE_POINTS)
    once = d <= TILE_COLS
    point_bufs = 1 if once else TILE_STAGES
    smem = 4 * (TILE_STAGES * TILE_ROWS * TILE_COLS
                + point_bufs * TILE_POINTS * TILE_COLS)
    return ArgminPlan("tiled", once, (s, tiles, m), smem + STATIC_SMEM,
                      m * tiles, m * b * s)


def argmin_smem_bytes(d: int) -> int:
    """Shared memory of the argmin engine's largest block at width d, over
    every batch: the sweep's staged points (at most 8 of them, while they
    fit) or the tiled route's tiles, which do not grow with d."""
    return max(argmin_plan(1, b, 1, d, 1).smem_bytes
               for b in range(1, SMALL_B + 2))


def accumulate_smem_bytes(d: int) -> int:
    """Shared memory of one accumulate-pass block: a (32, d) zsum tile, 256
    staged assignments and 32 counts."""
    return 4 * (OWN_ROWS * d + CHUNK + OWN_ROWS)


def smem_bytes(d: int) -> int:
    """Shared memory of the delta kernel's largest block at any batch: the
    accumulate pass's (32, d) tile or the argmin engine's.  The codebook
    streams through, so kappa does not enter."""
    return max(accumulate_smem_bytes(d), argmin_smem_bytes(d))


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
    if m > 65535 or -(-b // TILE_POINTS) > 65535:
        raise ValueError(f"M={m}, B={b} is past the launch grid's limits")
    return m, b, kappa, d


_scratch: dict[tuple, tuple[torch.Tensor, ...]] = {}  # (device, stream)


def _sweep_scratch(dev: torch.device, stream: int, m: int, n: int
                   ) -> tuple[torch.Tensor, ...]:
    """The argmin engine's ``(tickets (>= m,) int32, all 0; pmin (>= n,)
    f32; pidx (>= n,) int32)`` for launches on ``stream``, kept across
    calls (``m`` and ``n`` are a plan's ``tickets`` and ``partials``): the
    kernels put every ticket back to 0, and overwrite the partials before
    they read them.  Grown, never shrunk; a launch on another stream gets
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


def engine_scratch(m: int, b: int, kappa: int, d: int, kchunk: int,
                   dev: torch.device, stream: int) -> tuple[int, int, int]:
    """Pointers ``(pmin, pidx, tickets)`` of the argmin engine's scratch for
    one launch on ``stream`` at these dimensions (``argmin_plan``)."""
    plan = argmin_plan(m, b, kappa, d, kchunk)
    tickets, pmin, pidx = _sweep_scratch(dev, stream, plan.tickets,
                                         plan.partials)
    return pmin.data_ptr(), pidx.data_ptr(), tickets.data_ptr()


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
    mind = torch.empty((m, b), dtype=f32, device=dev)
    assign = torch.empty((m, b), dtype=torch.int32, device=dev)
    counts = zsum = None
    lib = _build.library()
    with _build.on_device(dev):
        stream = _build.current_stream(dev)
        scratch = engine_scratch(m, b, kappa, d, kchunk, dev, stream)
        dims = (m, b, kappa, d, kchunk, stream)
        if stats:
            counts = torch.empty((m, kappa), dtype=f32, device=dev)
            zsum = torch.empty((m, kappa, d), dtype=f32, device=dev)
            rc = lib.vq_delta_f32(z.data_ptr(), w.data_ptr(),
                                  counts.data_ptr(), zsum.data_ptr(),
                                  mind.data_ptr(), assign.data_ptr(),
                                  *scratch, *dims)
        else:
            rc = lib.vq_assign_f32(z.data_ptr(), w.data_ptr(),
                                   mind.data_ptr(), assign.data_ptr(),
                                   *scratch, *dims)
    _build.check(rc, f"{name}_f32")
    if z.dim() == 2:
        return (None if counts is None else counts[0],
                None if zsum is None else zsum[0], mind[0], assign[0])
    return counts, zsum, mind, assign


def cuda_launches() -> int:
    """CUDA kernels the assign, delta and blocked entries have launched in
    this process (the C library's host count; a launch of ``vq_delta`` is
    one at B <= ``SMALL_B`` and two past it).  Needs the built library."""
    out = ctypes.c_longlong(0)
    _build.check(_build.library().vq_argmin_launches(ctypes.byref(out)),
                 "vq_argmin_launches")
    return out.value


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
