"""Tile selection for the port's kernels, with a deterministic cache.
Counterpart of ``repro/kernels/autotune.py``.

The tiles are the runtime tile sizes of the port's CUDA kernels:

  * ``kchunk``: codebook rows per block of the argmin engine (the sweep
    at B <= 8 and the tiled argmin past it, which the assign, delta and
    blocked kernels share), the kappa split that gives a small batch its
    parallelism;
  * ``bk``: codebook rows per owner block of the blocked kernel's
    accumulate sweep (``csrc/vq_blocked.cu``), which runs past 8 points.
    The delta kernel's own accumulate tile is fixed
    (``vq_assign.OWN_ROWS``).

Neither changes a bit: the argmin is a strict total order of (distance,
index), so any kappa split finds the same winner, and every sum runs in
point order whatever the tile.  The tuner only changes time.

The pick comes from a model of the H100 (the port's copy of the
reference's ``VqCell.delta_grid``, ``delta_flops`` and ``delta_hbm_bytes``,
``distributed/roofline.py``, re-derived for the port's tiling): each launch
takes the larger of its bytes over the memory rate and its operations over
the f32 rate, divided by the share of the card its blocks keep busy, which
counts blocks against the 132 SMs (the eq.-9 tick at batch 1 has only
``ceil(kappa / kchunk) * M`` sweep blocks) and the warps that shared
memory and registers let each SM hold.  The launch's shape comes from the
engine's plan (``vq_assign.argmin_plan``).  Among the tiles whose shared
memory fits the budget (``ops.delta_smem_bytes``, the model the router
uses), the least model time wins, then the larger tiles (fewer blocks).

Three modes, set once at launch (``--autotune {off,cache,search}``):

  * ``off``: the untuned tiles (``vq_assign.KCHUNK``, ``vq_assign.OWN_ROWS``),
    no cache touched;
  * ``cache``: the model's pick, memoized in the process and, when a path is
    set (``set_cache_path`` or ``REPRO_AUTOTUNE_CACHE``), in a JSON file;
  * ``search``: the model ranks the tiles, the first ``SEARCH_TOP_N`` are
    timed with CUDA events on the card and the fastest wins, into the same
    cache.  For CPU tensors the plain versions have no tiles, so search
    takes the model's pick.

Keys name the device (``torch.cuda.get_device_name``, or ``cpu:cpu``), so a
file tuned on one card never hands its tiles to another.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading

import torch

MODES = ("off", "cache", "search")
KINDS = ("assign", "delta", "delta_blocked")
KCHUNK_CANDIDATES = (64, 128, 256, 512, 1024)
BK_CANDIDATES = (8, 16, 32, 64, 128)
SEARCH_TOP_N = 3    # model-ranked candidates timed in search mode
SEARCH_ITERS = 10   # timed launches per candidate, after one warm-up

# NVIDIA H100 SXM (data sheet): HBM bytes/s, f32 FLOP/s outside the tensor
# cores, SMs, shared memory and warps one SM holds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SMS = 132
SM_SMEM_BYTES = 233_472
SM_WARPS = 64
#: Warps of 256-thread blocks each SM needs in flight to reach the memory
#: rate in the model (a sweep with fewer reaches that share of it).
FULL_WARPS = 32
#: The same for the argmin engine's sweep, whose warps each keep 8 rows'
#: loads in flight (an accumulate pass's warp one row's), fitted to the
#: H100's times of kchunk 64-512 at (8, 1) x 4096 x 128 (PERF.md).
SWEEP_FULL_WARPS = 12
#: The tiled argmin's blocks an SM holds (its launch bounds: 128 registers
#: a thread), which keep its f32 pipes busy: 64 independent fmas a lane.
TILED_BLOCKS = 2
BLOCK_WARPS = 8


@dataclasses.dataclass(frozen=True)
class TileConfig:
    kchunk: int
    bk: int


class _TunerState:
    def __init__(self):
        self.mode = "cache"
        self.cache: dict[str, TileConfig] = {}
        self.cache_path: str | None = None
        self.file_loaded = False
        self.searches = 0            # cache misses resolved
        # (kind, batch, kappa, d, m, device) -> the pick: a launch's hit
        # without the key string, the device's name or the lock
        self.hits: dict[tuple, TileConfig] = {}
        self.lock = threading.Lock()


_STATE = _TunerState()


def set_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"autotune mode must be one of {MODES}, got {mode!r}")
    _STATE.mode = mode
    _STATE.hits.clear()


def get_mode() -> str:
    return _STATE.mode


def set_cache_path(path: str | None) -> None:
    """Point the tuner at a JSON cache file (None: in memory only)."""
    _STATE.cache_path = path
    _STATE.file_loaded = False
    _STATE.hits.clear()


def reset(mode: str | None = None) -> None:
    """Drop every cached pick and the miss count."""
    with _STATE.lock:
        _STATE.cache.clear()
        _STATE.searches = 0
        _STATE.file_loaded = False
        _STATE.hits.clear()
        if mode is not None:
            set_mode(mode)


def search_count() -> int:
    """Cache misses resolved since the last reset."""
    return _STATE.searches


def legacy_tiles() -> TileConfig:
    """The untuned tiles: mode ``off``'s answer."""
    from repro_torch.kernels import vq_assign
    return TileConfig(kchunk=vq_assign.KCHUNK, bk=vq_assign.OWN_ROWS)


@functools.cache
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_kind(device: str | torch.device) -> str:
    """``cuda:<card name>`` or ``cpu:cpu``: the device part of a key."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu:cpu"
    if dev.type != "cuda":
        raise ValueError(f"the tuner keys cuda or cpu devices, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda:{_cuda_name(index)}"


def tune_key(kind: str, batch: int, kappa: int, d: int, *, m: int = 1,
             device: str | torch.device, dtype_bytes: int = 4) -> str:
    return (f"{kind}|m{m}|b{batch}|k{kappa}|d{d}|e{dtype_bytes}|"
            f"{device_kind(device)}")


def _sweep_s(blocks: int, nbytes: float, flops: float, smem: int,
             full_warps: int = FULL_WARPS,
             max_blocks: int = SM_WARPS // BLOCK_WARPS) -> float:
    """Model time of one sweep: its roofline time over the share of the
    card its blocks keep busy (infinite where no block fits an SM)."""
    resident = min(max_blocks, SM_SMEM_BYTES // (smem + 1024))
    if resident == 0:
        return float("inf")
    per_sm = min(float(resident), blocks / SMS)
    busy = min(1.0, per_sm * BLOCK_WARPS / full_warps)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) / busy


def model_time(cfg: TileConfig, batch: int, kappa: int, d: int, *,
               m: int = 1, kind: str = "delta_blocked") -> float:
    """Model time (s) of one launch of ``kind`` at these tiles."""
    from repro_torch.kernels import vq_assign, vq_fused

    plan = vq_assign.argmin_plan(m, batch, kappa, d, cfg.kchunk)
    s = plan.grid[0]
    stats = kind != "assign"
    if plan.route == "sweep":
        # one launch for every kind: a block per kappa chunk reads its rows
        # once (norms folded in) and, with the statistics, writes their
        # zsum and counts; each stages the B points; partials written and
        # combined
        sweep_bytes = 4 * m * (kappa * d + s * batch * d + 2 * batch * s
                               + 2 * batch
                               + (kappa * d + kappa if stats else 0))
        return _sweep_s(s * m, sweep_bytes,
                        2.0 * m * (batch + 1) * kappa * d, plan.smem_bytes,
                        SWEEP_FULL_WARPS)
    # the tiled argmin: every (kappa chunk, point tile) block streams its
    # rows and stages its points (once where d <= 128, else for each row
    # group); four warps a row group take each row's norm; partials written
    # and combined
    tiles = plan.grid[1]
    groups = -(-kappa // vq_assign.TILE_ROWS)
    point_reads = s if plan.staged else groups
    dist_bytes = 4 * m * (tiles * kappa * d
                          + point_reads * batch * d + 4 * batch * s)
    norm_warps = vq_assign.TILE_POINTS // 8
    t = _sweep_s(s * tiles * m, dist_bytes,
                 2.0 * m * kappa * d * (batch + norm_warps * tiles),
                 plan.smem_bytes, TILED_BLOCKS * BLOCK_WARPS, TILED_BLOCKS)
    if not stats:
        return t
    if kind == "delta":
        blocks = -(-kappa // vq_assign.OWN_ROWS) * m
        smem = vq_assign.accumulate_smem_bytes(d)
    else:
        blocks = -(-kappa // cfg.bk) * -(-d // vq_fused.COLS) * m
        smem = vq_fused.blocked_accumulate_smem_bytes(kappa, cfg.bk)
    # accumulate sweep: every owner block scans every assignment; points
    # read once, counts and zsum written once
    acc_bytes = 4 * (blocks * batch + m * (batch * d + kappa * d + kappa))
    return t + _sweep_s(blocks, acc_bytes, float(m * batch * d), smem)


def _candidates(batch: int, kappa: int, d: int, *, kind: str,
                budget_bytes: int) -> list[TileConfig]:
    """Tiles worth trying: kchunk up to the codebook, and for the blocked
    kernel each bk whose shared memory fits the budget (the smallest when
    none does)."""
    from repro_torch.kernels import ops, vq_assign

    kchunks = sorted({min(c, kappa) for c in KCHUNK_CANDIDATES})
    if kind != "delta_blocked":
        return [TileConfig(kchunk=c, bk=vq_assign.OWN_ROWS) for c in kchunks]
    bks = sorted({min(c, kappa) for c in BK_CANDIDATES})
    fit = [b for b in bks
           if ops.delta_smem_bytes(kappa, d, bk=b) <= budget_bytes]
    return [TileConfig(kchunk=c, bk=b) for c in kchunks
            for b in (fit or bks[:1])]


def _rank(cands: list[TileConfig], batch: int, kappa: int, d: int, *,
          m: int, kind: str) -> list[TileConfig]:
    """Deterministic ranking: model time, then the larger tiles (fewer
    blocks)."""
    return sorted(cands, key=lambda c: (
        model_time(c, batch, kappa, d, m=m, kind=kind), -c.kchunk, -c.bk))


def _measure(cfg: TileConfig, batch: int, kappa: int, d: int, *, m: int,
             kind: str, device: torch.device) -> float:
    """Mean ms of one launch at these tiles on the card (CUDA events), on
    N(0, 1) inputs of the shape; counts no launch."""
    from repro_torch.kernels import vq_assign, vq_fused

    gen = torch.Generator(device=device).manual_seed(0)
    z = torch.randn((m, batch, d), generator=gen, device=device)
    w = torch.randn((m, kappa, d), generator=gen, device=device)
    if kind == "delta_blocked":
        def run():
            vq_fused._launch_blocked(z, w, None, cfg.kchunk, cfg.bk)
    else:
        def run():
            vq_assign._launch(z, w, kind, stats=kind == "delta",
                              kchunk=cfg.kchunk)
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SEARCH_ITERS):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / SEARCH_ITERS


def _cache_path() -> str | None:
    return _STATE.cache_path or os.environ.get("REPRO_AUTOTUNE_CACHE") or None


def _load_file_cache() -> None:
    _STATE.file_loaded = True
    path = _cache_path()
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return
    for k, v in raw.items():
        if (isinstance(v, list) and len(v) == 2 and k not in _STATE.cache
                and all(isinstance(x, int) and x >= 1 for x in v)):
            _STATE.cache[k] = TileConfig(kchunk=v[0], bk=v[1])


def _save_file_cache() -> None:
    path = _cache_path()
    if not path:
        return
    try:
        with open(path, "w") as f:
            json.dump({k: [c.kchunk, c.bk] for k, c in
                       sorted(_STATE.cache.items())}, f, indent=0,
                      sort_keys=True)
    except OSError:
        pass


def pick_tiles(batch: int, kappa: int, d: int, *, m: int = 1,
               device: str | torch.device, kind: str = "delta",
               budget_bytes: int | None = None) -> TileConfig:
    """The tiles for one launch shape of ``kind`` on ``device``.

    ``off`` returns ``legacy_tiles()``.  Otherwise the pick comes from the
    cache, or is made once: the model's in ``cache`` mode, the fastest of
    the model's first candidates in ``search`` mode on a CUDA device.
    ``budget_bytes`` bounds the blocked kernel's shared memory (default
    ``ops.smem_budget_bytes()``)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if _STATE.mode == "off":
        return legacy_tiles()
    fast = (kind, batch, kappa, d, m, device)
    hit = _STATE.hits.get(fast)
    if hit is not None:
        return hit
    from repro_torch.kernels import ops

    device = torch.device(device)
    # a bare "cuda" follows the current card, so only a named device's
    # pick is kept for the fast path
    hits = (_STATE.hits if device.type == "cpu" or device.index is not None
            else {})
    key = tune_key(kind, batch, kappa, d, m=m, device=device)
    with _STATE.lock:
        if not _STATE.file_loaded:
            _load_file_cache()
        hit = _STATE.cache.get(key)
        if hit is not None:
            hits[fast] = hit
            return hit
        mode = _STATE.mode
    # rank and time outside the lock, so a hit never waits on a search
    cands = _rank(_candidates(batch, kappa, d, kind=kind,
                              budget_bytes=ops.smem_budget_bytes(
                                  budget_bytes)),
                  batch, kappa, d, m=m, kind=kind)
    best = cands[0]
    if mode == "search" and device.type == "cuda" and len(cands) > 1:
        timed = [(_measure(c, batch, kappa, d, m=m, kind=kind, device=device),
                  i, c) for i, c in enumerate(cands[:SEARCH_TOP_N])]
        best = min(timed)[2]
    with _STATE.lock:
        hit = _STATE.cache.get(key)
        if hit is not None:        # another thread resolved it first
            hits[fast] = hit
            return hit
        _STATE.searches += 1
        _STATE.cache[key] = hits[fast] = best
        _save_file_cache()
        return best
