"""The window kernel (tau sequential eq.-1 steps for M stacked workers), the
blocked assign+delta kernel (the delta step at any width) and the top-k
kernel (the sparse transport's per-worker selection).

Counterpart of ``repro/kernels/vq_fused.py`` (``_window_kernel`` /
``vq_window_pallas``, ``_fused_delta_kernel`` / ``vq_delta_blocked_pallas``
and ``_topk_kernel`` / ``vq_topk_pallas``).  The CUDA sources are
``csrc/vq_window.cu``, ``csrc/vq_blocked.cu`` and ``csrc/vq_topk.cu``; each
says what bounds its kernel and how.

``vq_window``, ``vq_delta_blocked`` and ``vq_topk`` launch their kernels for
CUDA tensors and take the plain versions ``vq_window_plain``,
``vq_delta_blocked_plain`` and ``vq_topk_plain`` for CPU tensors only; the
window and top-k kernels' launch plans are the pure functions
``_window_plan`` and ``_topk_plan``.
``launches``, ``launches_blocked`` and ``launches_topk`` count the kernels'
launches.

``vq_divergence`` (``csrc/vq_divergence.cu``, plain ``vq_divergence_plain``,
count ``launches_divergence``) is no TPU kernel's counterpart: it is an
observed sync window's ``||w_local - w_shared||^2`` per worker, which the
reference's compiled scan fuses into one pass (``repro/engine/mesh.py:590``)
and eager PyTorch would spend three on.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch.core import vq
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import vq_assign as assign_kernels

#: Blocks a worker of the window kernel, both routes (a thread-block
#: cluster; mirrors csrc/vq_window.cu).  An H100 holds 15 resident clusters
#: at once (``window_clusters``), so M = 8 workers run in one wave.
CLUSTER_BLOCKS = 8
#: Threads per block of the window kernel, both routes at most; mirrors
#: csrc/vq_window.cu.
WINDOW_THREADS = 512
#: Warps per block of the streaming route.
WARPS = WINDOW_THREADS // 32
#: Rows a warp of the resident route holds in registers, and the columns a
#: lane holds of each (so only d <= 128); mirror csrc/vq_window.cu.
REG_ROWS, REG_COLS = 5, 4
#: The window kernel's static shared memory: the streaming route's per-warp
#: and per-block argmin partials (16 (min, argmin) pairs and 2 more), the
#: resident route's three 64-bit keys and two point norms, to the 16 bytes
#: that align the dynamic shared memory after them.
STREAM_STATIC_SMEM = 8 * (WARPS + 2)
RESIDENT_STATIC_SMEM = 32
#: Codebook columns per owner block of the blocked kernel's accumulate
#: sweep (one per thread); mirrors csrc/vq_blocked.cu.
COLS = 256
#: Assignments the accumulate sweep stages at once; mirrors the source.
CHUNK = 256

#: Threads per block of the top-k kernel, and its blocks a row (a thread
#: block cluster); mirror csrc/vq_topk.cu.
TOPK_THREADS, TOPK_CLUSTER = 1024, 8

launches = 0
# the thread runtime launches the window kernel from M threads at once
_launches_lock = threading.Lock()
launches_blocked = 0
launches_topk = 0
launches_divergence = 0

#: Entries a block of the divergence kernel sums, at least: 8 float4 loads a
#: thread, and at (8, 4096, 128) a grid of 512 blocks, all resident at once.
DIVERGENCE_BLOCK_ENTRIES = 8192


class WindowPlan(NamedTuple):
    """One launch of the window kernel: ``CLUSTER_BLOCKS`` blocks a worker
    of ``threads`` threads, block r owning codebook rows ``[r * rows, (r +
    1) * rows)`` (none past kappa).  ``resident`` keeps them on chip for
    the whole window: the first ``rows - reg_rows`` in shared memory at
    ``stride4`` float4s a row, the last ``reg_rows`` in registers; else they
    stream from global memory.  ``smem_bytes`` is what one block holds,
    dynamic and static."""
    resident: bool
    threads: int
    rows: int
    reg_rows: int
    stride4: int
    smem_bytes: int


def _resident_smem(srows: int, d: int) -> tuple[int, int]:
    """``(stride4, bytes)`` of a resident block with ``srows`` rows in
    shared memory: each row padded to an odd number of float4s (8
    neighbouring rows then meet 32 distinct banks), four point buffers,
    the rows' norms and the static keys."""
    n4 = -(-d // 4)
    stride4 = n4 | 1
    return stride4, (16 * srows * stride4 + 4 * 16 * n4 + 4 * srows
                     + RESIDENT_STATIC_SMEM)


def _window_plan(m: int, kappa: int, d: int,
                 budget_bytes: int = assign_kernels.SMEM_MAX) -> WindowPlan:
    """The window kernel's launch for M workers at (kappa, d), its blocks
    held to ``budget_bytes`` of shared memory where they can be.

    Resident where a block's ``ceil(kappa / 8)`` rows fit the shared memory
    one block may use (``vq_assign.SMEM_MAX``) and, at d <= 128, its 16
    warps' registers past that (``REG_ROWS`` rows a warp), and the block
    fits the budget.  At (8, 4096, 128): 512 rows a block, 433 in shared
    memory (232,436 B) and 79 in registers.  Otherwise the streaming route:
    its rows' norms in shared memory (at d=3072: 26,768 B; at d=128: 3,216
    B), which may still exceed the budget (``ops.window_fits`` then
    refuses the kernel).  The plan changes no bit; a launch the card
    refuses raises."""
    if m < 1 or kappa < 1 or d < 1:
        raise ValueError(f"vq_window needs M, kappa and d > 0, got "
                         f"({m}, {kappa}, {d})")
    if m > 65535:
        raise ValueError(f"M={m} is past the launch grid's limit of 65535")
    n4 = -(-d // 4)
    rows = -(-kappa // CLUSTER_BLOCKS)
    room = assign_kernels.SMEM_MAX - RESIDENT_STATIC_SMEM - 64 * n4
    fit = max(0, room // (16 * (n4 | 1) + 4))  # rows shared memory holds
    reg_cap = WARPS * REG_ROWS if d <= 32 * REG_COLS else 0
    srows = min(rows, fit)
    stride4, nbytes = _resident_smem(srows, d)
    if rows - srows <= reg_cap and nbytes <= budget_bytes:
        threads = (WINDOW_THREADS if srows < rows
                   else min(WINDOW_THREADS, 32 * -(-rows // 32)))
        return WindowPlan(True, threads, rows, rows - srows, stride4, nbytes)
    return WindowPlan(False, WINDOW_THREADS, rows, 0, 0,
                      4 * (rows + 2 * d) + STREAM_STATIC_SMEM)


def smem_bytes(kappa: int, d: int,
               budget_bytes: int = assign_kernels.SMEM_MAX) -> int:
    """Shared memory one block of the window kernel holds at (kappa, d)
    under ``budget_bytes``, as ``_window_plan`` lays it out: a resident
    block's rows, or a streaming block's norms; ``tau`` and M do not
    enter."""
    return _window_plan(1, kappa, d, budget_bytes).smem_bytes


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


def vq_window(zwin: torch.Tensor, w0: torch.Tensor, eps: torch.Tensor,
              budget_bytes: int = assign_kernels.SMEM_MAX) -> torch.Tensor:
    """One window for every worker: zwin (M, tau, d), w0 (kappa, d), eps
    (tau,) f32 -> w (M, kappa, d) after tau sequential eq.-1 steps.

    Callers check ``ops.window_fits`` first, at the same ``budget_bytes``.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, with the plan ``_window_plan`` gives."""
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
    plan = _window_plan(m, kappa, d, budget_bytes)
    wout = torch.empty((m, kappa, d), dtype=torch.float32, device=zwin.device)
    lib = _build.library()
    with _build.on_device(zwin.device):
        stream = _build.current_stream(zwin.device)
        rc = lib.vq_window_f32(
            zwin.data_ptr(), w0.data_ptr(), eps.data_ptr(), wout.data_ptr(),
            m, tau, kappa, d, int(plan.resident), plan.threads, plan.rows,
            plan.rows - plan.reg_rows, plan.stride4,
            plan.smem_bytes - (RESIDENT_STATIC_SMEM if plan.resident
                               else STREAM_STATIC_SMEM), stream)
    _build.check(rc, "vq_window_f32")
    with _launches_lock:
        launches += 1
    return wout


def window_clusters(plan: WindowPlan) -> int:
    """How many clusters of ``plan``'s resident route the card holds at
    once (``cudaOccupancyMaxActiveClusters``): M clusters run in one wave
    when it is at least M.  Needs a CUDA card."""
    if not plan.resident:
        raise ValueError("the streaming route's clusters are 8 blocks of "
                         "16 warps; only the resident route is asked")
    out = ctypes.c_int(0)
    _build.check(_build.library().vq_window_clusters(
        plan.threads, plan.smem_bytes - RESIDENT_STATIC_SMEM,
        int(plan.reg_rows > 0), ctypes.byref(out)), "vq_window_clusters")
    return out.value


def blocked_accumulate_smem_bytes(kappa: int, bk: int) -> int:
    """Shared memory of one block of the blocked kernel's accumulate sweep
    at tile ``bk``: the (min(bk, kappa), 256) zsum tile, its counts and 256
    staged assignments; d does not enter."""
    rows = min(bk, kappa)
    return 4 * (rows * COLS + rows + CHUNK)


def blocked_smem_bytes(kappa: int, d: int, bk: int) -> int:
    """Shared memory of the blocked kernel's largest block: the accumulate
    sweep's or the argmin engine's (``vq_assign.argmin_smem_bytes``),
    neither of which grows with d past the engine's staging limits."""
    return max(blocked_accumulate_smem_bytes(kappa, bk),
               assign_kernels.argmin_smem_bytes(d))


def vq_delta_blocked_plain(z: torch.Tensor, w: torch.Tensor,
                           residual: torch.Tensor | None = None):
    """The blocked kernel's plain version: ``vq_assign.vq_delta_plain``,
    and with ``residual`` the eager epilogue
    ``counts.unsqueeze(-1) * w - zsum + residual``.

    z (..., B, d), w (..., kappa, d) -> (counts, zsum, mind, assign[,
    delta (..., kappa, d)])."""
    out = assign_kernels.vq_delta_plain(z, w)
    if residual is None:
        return out
    counts, zsum = out[0], out[1]
    return (*out, counts.unsqueeze(-1) * w - zsum + residual)


def _launch_blocked(z: torch.Tensor, w: torch.Tensor,
                    residual: torch.Tensor | None, kchunk: int | None,
                    bk: int | None):
    """Launch ``vq_delta_blocked_f32`` on CUDA tensors; counts no launch."""
    m, b, kappa, d = assign_kernels.stacked_dims(z, w, "vq_delta_blocked")
    if residual is not None and not residual.is_contiguous():
        raise ValueError("residual must be contiguous")
    dev = z.device
    if kchunk is None or bk is None:
        tiles = autotune.pick_tiles(b, kappa, d, m=m, device=dev,
                                    kind="delta_blocked")
        kchunk = tiles.kchunk if kchunk is None else kchunk
        bk = tiles.bk if bk is None else bk
    if bk < 1:
        raise ValueError(f"bk must be >= 1, got {bk}")
    bk = min(bk, kappa)
    if kchunk < 1:
        raise ValueError(f"kchunk must be >= 1, got {kchunk}")
    if -(-d // COLS) > 65535:
        raise ValueError(f"d={d} is past the launch grid's limit")
    f32 = torch.float32
    mind = torch.empty((m, b), dtype=f32, device=dev)
    assign = torch.empty((m, b), dtype=torch.int32, device=dev)
    counts = torch.empty((m, kappa), dtype=f32, device=dev)
    zsum = torch.empty((m, kappa, d), dtype=f32, device=dev)
    delta = None if residual is None else torch.empty_like(zsum)
    lib = _build.library()
    with _build.on_device(dev):
        stream = _build.current_stream(dev)
        rc = lib.vq_delta_blocked_f32(
            z.data_ptr(), w.data_ptr(),
            None if residual is None else residual.data_ptr(),
            counts.data_ptr(), zsum.data_ptr(),
            None if delta is None else delta.data_ptr(), mind.data_ptr(),
            assign.data_ptr(),
            *assign_kernels.engine_scratch(m, b, kappa, d, kchunk, dev,
                                           stream),
            m, b, kappa, d, kchunk, bk, stream)
    _build.check(rc, "vq_delta_blocked_f32")
    out = (counts, zsum, mind, assign) + (() if delta is None else (delta,))
    return tuple(x[0] for x in out) if z.dim() == 2 else out


def vq_delta_blocked(z: torch.Tensor, w: torch.Tensor, *,
                     residual: torch.Tensor | None = None,
                     kchunk: int | None = None, bk: int | None = None):
    """Assignment statistics of z (M, B, d) against w (M, kappa, d) (or the
    2-D case M=1) at any kappa and d: ``(counts, zsum, mind, assign)`` as
    ``vq_assign.vq_delta`` gives them, bit for bit on the card; with
    ``residual`` (shaped like w), also ``delta = counts * w - zsum +
    residual`` as the eager expression rounds it.

    The tiles (``kchunk``, ``bk``) come from ``kernels.autotune`` unless
    given; they change no bit.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream."""
    global launches_blocked
    assign_kernels.check_inputs(z, w, "vq_delta_blocked")
    if residual is not None and (residual.shape != w.shape
                                 or residual.dtype != torch.float32
                                 or residual.device != w.device):
        raise ValueError(
            f"residual must be float32 shaped like w {tuple(w.shape)} on "
            f"{w.device}, got {residual.dtype} {tuple(residual.shape)} on "
            f"{residual.device}")
    if not assign_kernels.on_cuda(z, "vq_delta_blocked"):
        return vq_delta_blocked_plain(z, w, residual)
    out = _launch_blocked(z, w, residual, kchunk, bk)
    launches_blocked += 1
    return out


def vq_topk_plain(full: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-k kernel's plain version: a stable descending sort of |x|
    (the lower index first among equal |x|, as ``lax.top_k``), its first k
    indices in ascending order, their entries, and ``full - kept``.

    full (M, N) f32 -> (vals (M, k) f32, idx (M, k) int32,
    residual (M, N) f32).  ``torch.topk`` does not promise an order among
    ties, so it is not used."""
    order = torch.sort(full.abs(), dim=1, descending=True, stable=True)[1]
    idx = torch.sort(order[:, :k], dim=1)[0]
    vals = torch.gather(full, 1, idx)
    kept = torch.zeros_like(full).scatter_(1, idx, vals)
    return vals, idx.to(torch.int32), full - kept


class TopkPlan(NamedTuple):
    """One launch of the top-k kernel: ``cluster`` blocks a row, block r
    owning entries ``[r * slice_len, (r + 1) * slice_len)`` of it."""
    cluster: int
    slice_len: int


def _topk_plan(m: int, n: int, k: int) -> TopkPlan:
    """The top-k kernel's launch for full (m, n) at k: m clusters of
    ``TOPK_CLUSTER`` blocks, a row split into slices of ``ceil(n / 8)``
    entries rounded up to a multiple of 4, so that float4 loads stay
    aligned.  Every pass reads its slice from device memory (from L2 after
    the first where the rows fit it: at n = 524,288 the 16.8 MB of full
    do).  There is one route; the plan changes no bit."""
    if not 1 <= k <= n:
        raise ValueError(f"vq_topk needs 1 <= k <= N={n}, got k={k}")
    if not 1 <= m * TOPK_CLUSTER <= 2**31 - 1:
        raise ValueError(f"M={m} clusters of {TOPK_CLUSTER} blocks are past "
                         f"the launch grid's limit")
    return TopkPlan(TOPK_CLUSTER, 4 * -(-n // (4 * TOPK_CLUSTER)))


def vq_topk(full: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k largest-|x| entries of each row of full (M, N) f32, 1 <= k <= N:
    ``(vals (M, k), idx (M, k) int32, residual (M, N))`` as
    ``vq_topk_plain``, the pairs in ascending index order.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, with the plan ``_topk_plan`` gives."""
    global launches_topk
    if full.dim() != 2 or full.dtype != torch.float32:
        raise ValueError(f"vq_topk takes full (M, N) float32, got "
                         f"{tuple(full.shape)} {full.dtype}")
    m, n = full.shape
    if not 1 <= k <= n:
        raise ValueError(f"vq_topk needs 1 <= k <= N={n}, got k={k}")
    if full.device.type == "cpu":
        return vq_topk_plain(full, k)
    if full.device.type != "cuda":
        raise ValueError(f"vq_topk runs on cuda or cpu, got {full.device}")
    if not full.is_contiguous():
        raise ValueError("full must be contiguous")
    if m == 0 or n > 2**31 - 1 - 4 * TOPK_THREADS:
        raise ValueError(f"vq_topk needs M >= 1 and N < 2**31 - 4096, got "
                         f"({m}, {n})")
    plan = _topk_plan(m, n, k)
    vals = torch.empty((m, k), dtype=torch.float32, device=full.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=full.device)
    residual = torch.empty_like(full)
    lib = _build.library()
    with _build.on_device(full.device):
        stream = _build.current_stream(full.device)
        rc = lib.vq_topk_f32(full.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                             residual.data_ptr(), m, n, k, plan.slice_len,
                             stream)
    _build.check(rc, "vq_topk_f32")
    launches_topk += 1
    return vals, idx, residual


def vq_divergence_plain(w_local: torch.Tensor,
                        w_shared: torch.Tensor) -> torch.Tensor:
    """The divergence kernel's plain version: w_local (M, kappa, d), w_shared
    (kappa, d) -> (M,), each worker's ``sum((w_local[m] - w_shared) ** 2)``
    (the reference's ``mesh.py:590``)."""
    return torch.sum((w_local - w_shared) ** 2,
                     dim=tuple(range(1, w_local.dim())))


def vq_divergence(w_local: torch.Tensor,
                  w_shared: torch.Tensor) -> torch.Tensor:
    """Each worker's squared distance to the shared codebook, (M,) f32, in
    one pass over w_local (M, kappa, d) and w_shared (kappa, d), both f32
    contiguous.  CPU tensors take ``vq_divergence_plain``; CUDA tensors
    launch ``csrc/vq_divergence.cu`` on the current stream (its sums run in
    another order than PyTorch's)."""
    global launches_divergence
    dev = w_local.device    # read once: each read builds a torch.device
    if (w_local.dim() < 2 or w_local.shape[1:] != w_shared.shape
            or w_local.dtype != torch.float32
            or w_shared.dtype != torch.float32
            or dev != w_shared.device):
        raise ValueError(
            f"vq_divergence takes w_local (M, ...) and w_shared (...) f32 on "
            f"one device, got {tuple(w_local.shape)} {w_local.dtype} on "
            f"{dev} and {tuple(w_shared.shape)} {w_shared.dtype} on "
            f"{w_shared.device}")
    if dev.type == "cpu":
        return vq_divergence_plain(w_local, w_shared)
    if dev.type != "cuda":
        raise ValueError(f"vq_divergence runs on cuda or cpu, got {dev}")
    if not (w_local.is_contiguous() and w_shared.is_contiguous()):
        raise ValueError("w_local and w_shared must be contiguous")
    m, n = w_local.shape[0], w_shared.numel()
    g = min(1024, max(1, -(-n // DIVERGENCE_BLOCK_ENTRIES)))
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with _build.on_device(dev):
        stream = _build.current_stream(dev)
        # the argmin engine's per-stream scratch: tickets left at 0 by
        # every kernel that takes one, partials written before they are read
        tickets, partial, _ = assign_kernels._sweep_scratch(dev, stream, m,
                                                            m * g)
        rc = lib.vq_divergence_f32(w_local.data_ptr(), w_shared.data_ptr(),
                                   partial.data_ptr(), tickets.data_ptr(),
                                   out.data_ptr(), m, n, g, stream)
    _build.check(rc, "vq_divergence_f32")
    launches_divergence += 1
    return out
