#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA:

  1. prints the card's name and power limit, builds the port's CUDA kernels
     from src/repro_torch/kernels/csrc with nvcc, and prints the build time;
  2. holds each kernel against its plain PyTorch version on the card at the
     slice's width (M=8 workers, kappa=4096, d=128, tau=10): the window
     kernel over 20 windows, the delta kernel at batch 1 (the per-step
     shape) and batch 1000 (the eval shape), and both at a ragged shape
     that divides none of their block sizes;
  3. checks that the window kernel gives the same codebook, bit for bit, as
     the per-step path through the delta kernel, window by window; then
     the argmin engine's two routes in the delta kernel (the one-launch
     sweep at B = 1, 2 and 8, the tiled argmin at B = 9), each against the
     plain version and, bit for bit, against the assign kernel's (assign,
     mind); the sweep called
     1,000 times back to back on new points, each result against the
     plain version, and replayed 10 times from a CUDA graph holding two
     sweeps, each replay equal to eager calls bit for bit and the tickets
     0 after; the window plan (``vq_fused._window_plan``) at d=128, at
     d=3072 and under a 100,000 B budget, with how many resident clusters
     the card holds at once; and the window kernel's resident route at M =
     1 and 3, at a ragged kappa with register rows and at kappa = 5, and
     its streaming route at d=128 under that budget, against the per-step
     path, bit for bit;
  4. holds the assign kernel against its plain version at the serving
     flush shape (128 x 4096 x 128), the eval shape ((8, 1000) x 4096 x
     128), the ragged shape and the eq.-9 tick's (8, 1) x 4096 x 3072 (the
     last against the plain version in float64, see BLOCKED_REF), and
     against the delta kernel's (assign, min distance), which it must
     equal bit for bit; then the tiled argmin (B > 8) at B = 9, 128 and
     1000 (and 9 at d=3072) against the sweep over the same points taken 8
     at a time, (assign, mind) bit for bit, each call one CUDA launch (the
     engine's host count, ``vq_assign.cuda_launches``);
  5. drives the main path, ``repro_torch.launch.train --mode vq --executor
     mesh``, on 8 x 125,000 points for ``--scheme delta`` and then
     ``--scheme average``, and the per-step (``fused=False``) route on the
     first 2,000 points of each worker, with every kernel's launch count
     set to 0 before each run and read after it;
  6. compares each run's first 20 windows with the port's own oracles
     (``core.schemes.scheme_delta`` / ``scheme_average``) on the card;
  7. serves the delta run's codebook with ``repro_torch.launch.serve --mode
     vq`` (kappa=4096, d=128): 10,000 one-vector requests under the
     geometric arrival process, then 10,000 saturating ones; checks that
     none failed, that versions are monotonic, that 1,000 sampled responses
     equal the plain version, and that the assign kernel ran once per flush
     and warm-up; then four more geometric legs, with the launcher's
     ``gc.freeze()`` off, on, on, off, read what the freeze does to p99;
  8. runs eq. 9, ``--scheme async_delta --network geometric``, on 8 x
     125,000 points: one delta-kernel launch per tick and no window-kernel
     launch, its first 200 ticks held against the port's oracle
     (``core.async_vq.scheme_async``) on the same round lengths, and its
     final distortion below the initial one and below twice the sync delta
     run's;
  9. holds the top-k kernel against its plain version on the card, bit for
     bit (vals, idx, residual), with one counted launch a call, at (8,
     524,288) with k = 5,242, 524, 1 and 524,288, the window displacement
     also at k = its rows' non-zero counts and those +- 1 (the T = 0 early
     exit on either side), at a ragged (3, 40,040) with k = 37, on a
     tie-heavy input (mostly zeros of both signs, repeated magnitudes of
     both signs) with k cutting through a tie, and on 0.5 tie runs across
     every slice boundary of the (8, 524,288) row, cut at a boundary; and
     prints the launch plan of each shape (8-block clusters, slice length);
  10. runs the sparse transport: ``--scheme delta --transport sparse
     --compress-frac 0.01`` on 8 x 125,000 points, which must give the
     dense delta run's curve and codebook bit for bit (k = 5,242 keeps every
     entry a window can touch, tau * d = 1,280), with one top-k launch per
     window and 3,669,400,000 B of merge wire per worker; the lossy
     ``--compress-frac 0.001`` (k = 524) on 8 x 20,000 points, its first 20
     windows held bit for bit against a loop written out here (window
     kernel, payload + residual, the plain selection, the sum); and eq. 9
     over the sparse transport for 20,000 ticks on the dense eq.-9 run's
     round lengths, whose curve must equal the dense run's head bit for bit;
  11. holds the blocked assign+delta kernel against the delta kernel, bit
     for bit (assign, mind, counts, zsum), at (8, 1) and (8, 1000) x 4096 x
     128; against its plain version at d=3072 ((8, 1), (8, 8) and (8,
     1000) x 4096, the epilogue also on a residual with +0 and -0 entries)
     and at ragged shapes, past the sweep's staging limit (d=8000 at B =
     1, 9 and 13), with its epilogue equal to the eager expression on its
     own outputs bit for bit; each blocked call at B <= 8 one CUDA launch;
     and ``ops.vq_delta_topk``'s blocked branch
     against its full-kernel branch at d=128, bit for bit;
  12. runs eq. 9 at d=128 through the blocked route (the shared-memory
     budget forced down) for 2,000 ticks, which must equal the dense run's
     head bit for bit with one blocked launch per tick;
  13. drives eq. 9 on a 3072-wide embedding codebook (kappa=4096, M=8,
     2,000 ticks per worker, cut for time) through the launcher: one
     blocked launch per tick and no delta or window launch, distortion
     falling, its first 200 ticks held against ``scheme_async`` under the
     flip rule and, with ``fused=False`` (assign kernel + ``index_add_``),
     equal to the blocked route bit for bit; then the sync delta scheme at
     that width on 8 x 2,000 points, the window kernel against the
     per-step loop through the blocked kernel, window by window, bit for
     bit;
  14. runs the tile tuner's search on the eq.-9 shape and shows the tuned
     tiles give the untuned tiles' bits;
  15. holds the ring all-reduce kernel against its plain version, bit for
     bit, with one launch a call, at (8, 524,288) (a window's displacement,
     N(0, 1) entries, and N(0, 1) under a 0/1 mask), (8, 1) (the eval
     payload), ragged (3, 40,040) and (5, 1,000,003), (8, 524,285) (chunk
     a multiple of 4, N not), (5, 999,996) (the float4 route with a short
     last chunk, plain and masked), and (8, 12,582,912) (the d=3072
     payload, 402.7 MB), and prints the largest |ring - torch.sum| as a
     read-out (the orders differ); then the top-k kernel on the d=3072
     payload at k = 1% (402.7 MB, past L2), bit for bit;
  16. drives ``--scheme delta --transport ring`` on 8 x 125,000 points
     through the launcher: 12,500 window and 25,000 ring launches (merge and
     eval) and no other, 3,670,016 B of merge wire a window, its curve and
     codebook held against the dense delta run's (CURVE_RTOL, ROWS_FRAC),
     its first 200 windows equal bit for bit to runs over
     ``RingTransport().plain()`` and ``quant[identity:ring]`` and held
     against a dense run of those windows; ``--scheme average --transport
     ring`` on 8 x 2,000 points (400 ring launches) against dense average;
     eq. 9 over the masked ring for 20,000 ticks on the dense eq.-9 run's
     round lengths (20,000 delta and 22,000 ring launches), its curve and
     codebook held against a dense eq.-9 run of those ticks and its first
     2,000 ticks equal to the plain-ring run bit for bit; and
     ``--transport ring --wire-quant int8`` on 8 x 20,000 points (917,508 B
     of wire a window, 4,000 ring launches, distortion falling);
  17. runs the comm layer at full width, M = 8 as 2 host groups of 4
     (``--hosts 2``): the top-k kernel on a tier-1 payload ((2, 524,288),
     k = 1,024, and (2, 1) at k = 1) and the ring kernel on a host group's
     rows ((4, 524,288)) against their plain versions, bit for bit; both
     tiers dense on 8 x 20,000 points, equal bit for bit to the flat dense
     run (3,145,728 / 2,097,152 B a window on tiers 0 / 1), and over
     ``--transport ring`` to the flat ring run with the same ring launches;
     a sparse tier 1 (k = 1,024) at full depth: 12,500 window and top-k
     launches, 3,145,728 / 8,192 B a window, its first 20 windows held
     against ``use_kernels=False`` and its final distortion within 25% of
     the flat dense run's; eq. 9 over the hierarchy for 20,000 ticks (a
     delta and a top-k launch a tick) and, with a dense tier 1, equal to the
     flat eq.-9 run over 2,000 ticks bit for bit; ``--merge dynamic`` at
     threshold 0 equal to plain delta bit for bit (7 B of probe a window),
     then at full depth at T, the median probe of that leg, and over
     ``--wire-quant int8`` (cut); ``--quorum`` without lateness equal to
     plain delta bit for bit, then ``--network geometric --p-delay 0.2`` at
     full depth (late worker-windows as the numpy late matrix counts them,
     3,670,023 B a window); the ``Tier1BudgetController`` from frac 0.5 in
     chunks of 100 windows, its trajectory equal to the ladder replayed on
     the host, the top-k kernel at each k of it against plain; times the
     two new kernel shapes and traces 200 windows of the sparse-tier-1
     leg;
  18. runs chaos, elastic resizes and checkpoints (``elastic_legs``), each
     leg with the launch counts set to 0 before it and read after: E1,
     ``--resize 4000:4,8000:8 --ckpt-dir`` at full depth through the
     launcher, observed (``--metrics``: its ``resize_events``,
     ``late_delta_points`` and ``resize`` spans == its ``ResizeStats``, a
     divergence launch a window)
     (14,499 windows, 40 late points, 14,500 window launches: one
     is the late delta's, over the departing workers' (4, tau, d) stack),
     its first 4,000 windows equal bit for bit to the fixed-M delta run,
     its final distortion within 1e-2 of it, one 2,097,152 B ``late_delta``
     record, checkpoints at 4,000 and 8,000, each resize's ``wall_s`` and
     checkpoint save time printed; E2, ``--resume`` from step 8,000, equal
     to E1's last 6,499 windows bit for bit; E3, ``checkpoint_every=750``
     on 20,000 points a worker (cut), resumed from step 1,500 bit for bit;
     E4, ``--hosts 2 --tier1-transport xla --resize 500:4,1000:8`` on
     20,000 points (cut), equal bit for bit to the flat elastic run, its
     late delta charged 2,097,152 B on tier 1; E5, ``--chaos
     7:kill=2,slow=1,part=1`` at full depth, resizes with cause
     ``chaos_kill`` at the kill windows and the late worker-windows equal
     to the segments' numpy late matrices, observed too (``chaos_kills``
     twice the kills, the reference's count; ``chaos_late_worker_windows``
     == the late matrices); E6, eq. 9 over a
     ``ChaosNetwork`` (a slowdown, a kill) for 20,000 ticks (cut), one
     delta launch a tick, the dead worker's rounds never completing, its
     first 200 ticks held against ``scheme_async``;
  19. runs the thread runtime, training while serving and the trace/metrics
     layer (``threads_serving_obs_legs``), each leg with the launch counts
     set to 0 before it and read after: T1, ``--executor thread --scheme
     async_delta`` on 8 x 125,000 points for 5 s (one window launch at (1,
     tau, d) a round: window launches == the workers' pushes, no other
     launch; every worker pushes; the distortion falls; points/s, rounds/s,
     the stale-read share, the inbox's peak depth and the window plan at
     M = 1 printed; T1 again without the inbox's bound, a read-out; and
     rounds/s at M = 1, 2, 4 for 1 s each, a read-out); T2, a 50x
     straggler for 3 s (worker 0 takes fewer points than each other); T3,
     ``--comm-delay-s 0.01`` for 3 s; T4, 8 threads x 200
     ``BlobStore.apply(+1)`` on a (4096, 128) device tensor (version 1,600,
     every entry 1600.0); S1, ``launch.serve --train-publish`` (an elastic
     trainer at M = 8, 4, 8 on 8 x 20,000 points publishing every 10
     windows, 10,000 geometric requests): no failure, monotonic versions,
     more than one served, 1 + its ``on_window`` calls published, window
     launches == windows + late deltas and assign launches == flushes +
     warm-ups, 1,000 sampled answers == plain on their version's codebook,
     the trace clean with flush, load and window spans, p50/p99 beside
     phase 7's; O1, the divergence kernel (an observed window's
     ``||w_local - w_shared||^2`` in one pass; no TPU kernel's counterpart)
     against its plain version at (8, 4096, 128), a ragged and a
     misaligned shape, one launch a call, and 1,000 calls back to back
     with the same bits and the tickets left 0; then ``--scheme delta`` at
     full depth, two pairs of bare and observed runs in turns (``--trace
     --metrics``, the collector run before each): curve and codebook ==
     the main path's bit for bit, 12,500 divergence launches an observed
     run, ``windows_total`` 12,500, the ``comm_*`` counters ==
     ``CommLog.summarize``, 3,670,016 B of merge a window, their wall
     ratio a read-out; the divergence kernel's inputs captured on the
     observed path for 20 windows, its outputs and the emitted
     ``codebook_divergence`` series against plain; the gate: 16 pairs of
     500-window blocks, bare and observed in turns in one process, the
     reference's estimator (the smaller of the best-of-16 ratio and the
     median pair ratio) <= 1.03; and eq. 9 for 20,000 ticks, two pairs of
     bare and observed runs in turns, bit for bit, their ratios a
     read-out;
  20. times each kernel (the delta sweep also at each kchunk the tuner
     weighs; the assign kernel at the flush, the eval and (8, 1) x 4096 x
     3072; the blocked kernel at (8, 1) x 4096 x 3072 with and without the
     epilogue and at (8, 1) x 4096 x 128; the window kernel also at M = 1,
     the thread runtime's round; the divergence kernel), its plain version,
     its bound
     and, for the top-k
     kernel, ``torch.topk`` (selection only, also on the d=3072 payload),
     for the ring kernel ``torch.sum(x, dim=0)`` (each in turns with its
     library call), all on one yardstick (``kernel_ms``: CUDA events around
     each call, 1 GiB read before it to flush L2, so inputs come from
     device memory as the bound assumes), beside each kernel's CUDA-event time
     over back-to-back calls (L2 warm, the wrapper's host time included);
     and traces 200 windows of the
     sync delta path (bare, then observed), 1,000 ticks of the eq.-9 path, 200 windows of the
     sparse eq.-8 path, 200 windows of the ring sync path and 200 ticks of
     the 3072-wide eq.-9 path with torch.profiler (device time by kernel, the
     device's idle share), after timing 200 dense and ring sync windows in
     turns on the host clock;
  21. prints one ``{"kernels": [...]}`` line (window, delta, assign,
      top-k, blocked and ring), the card line again, and last
      ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failed check exits non-zero before the result lines; an exception
prints its traceback to stdout first.  It needs no network and imports
nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the slice's width: a SIFT1M-shaped deployment (see PERF.md)
M, N_PER, D, KAPPA, TAU, N_EVAL, SEED = 8, 125_000, 128, 4096, 10, 1000, 0
CHECK_WINDOWS = 20      # windows held against the plain version / oracle
UNFUSED_POINTS = 2000   # depth of the per-step (fused=False) leg
PROFILE_WINDOWS = 200   # windows traced by torch.profiler
PROFILE_TICKS = 1000    # eq.-9 ticks traced by torch.profiler
FLUSH_ROWS = 128        # the service's padded flush (batch_align)
SERVE_REQUESTS = 10_000  # one-vector requests, SIFT1M's query-set size
SERVE_SAMPLE = 1000     # served rows held against the plain version
ASYNC_CHECK_TICKS = 200  # eq.-9 ticks held against the oracle
P_DELAY = 0.5           # the paper's geometric delay parameter
SPARSE_FRAC = 0.01      # the launcher's --compress-frac default
LOSSY_FRAC = 0.001      # k = 524 < tau * d: the selection drops entries
LOSSY_POINTS = 20_000   # depth of the lossy sparse eq.-8 leg
SPARSE_TICKS = 20_000   # depth of the sparse eq.-9 leg
# a text-embedding-3-large-shaped codebook (see PERF.md): d=3072 is past
# the delta kernel's shared memory, so every step takes the blocked kernel
WIDE_D = 3072
WIDE_POINTS = 2000      # ticks (points) per worker, cut for time
BLOCKED_TICKS = 2000    # depth of the d=128 eq.-9 leg, blocked route
# below the window kernel's smallest block (the streaming route's 3,216 B at
# d=128, 26,768 B at d=3072) and the delta kernel's (17,536 B at d=128)
# shared memory: forces the blocked route
FORCE_BUDGET = 1024
# below the resident window block (232,436 B at d=128), above the streaming
# one: the window kernel streams its codebook at d=128
STREAM_BUDGET = 100_000
RING_PLAIN_WINDOWS = 200  # sync windows held bitwise against the plain ring
RING_PLAIN_TICKS = 2000   # eq.-9 ticks held bitwise against the plain ring
RING_AVG_POINTS = 2000    # depth of the ring average leg
RING_MASK = (1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0)  # a 0/1 mask over M=8
# the comm layer's legs: M = 8 as 2 host groups of 4 workers
HOSTS = 2
COMM_POINTS = 20_000    # points (or ticks) per worker of a cut leg
COMM_CHECK_TICKS = 2000  # eq.-9 ticks of the dense-tier-1 == flat check
QUORUM_P_DELAY = 0.2    # 0.8^11 = 8.6% of worker-windows late at tau = 10
CTL_FRAC0 = 0.5         # the controller leg's starting tier-1 frac
CTL_DCN = 262_144       # its tier-1 bytes a tick: frac 0.5 takes 8 ticks
CTL_PUBLISH = 100       # its windows a chunk
# the elastic legs (queue 1, item 5a): E1's schedule at full depth, the
# periodic checkpoint of E3, E4's host-group schedule on COMM_POINTS, E5's
# chaos spec, and E6's faults over eq. 9 (a slowdown inside the ticks held
# against the oracle, a kill later)
ELASTIC_RESIZE = ((4000, 4), (8000, 8))
CKPT_EVERY = 750
HIER_RESIZE = ((500, 4), (1000, 8))
CHAOS_SPEC = "7:kill=2,slow=1,part=1"
E6_FAULTS = ((5, "slow", 3, 10), (500, "kill", 6))
# the thread runtime, training while serving and the trace/metrics layer
# (queue 1, items 5b and 6a): T1's and T2/T3's wall seconds; S1's points a
# worker (2,333 trainer windows at M = 8, 4, 8) and windows a publication;
# the eq.-9 ticks of O1's read-out
T1_SECONDS = 5.0
T23_SECONDS = 3.0
S1_POINTS = 20_000
S1_PUBLISH = 10
O1_TICKS = 20_000
# O1's full-depth runs, two bare/observed pairs in turns: the bits, the
# counters and the trace at full depth, their wall ratio a read-out.  The
# gate's measurement is O1_BLOCK_PAIRS pairs of O1_BLOCK_WINDOWS-window
# blocks in one process, each pair's order the reverse of the last's: a
# one-card machine shares its CPU cores, a sync window's host work is not
# far below its device time, and a stretch the host slows then spoils a
# few pairs of a median instead of one of two full runs; a host busy all
# through slows most pairs, and the best of N still finds quiet blocks
O1_ORDER = (False, True, True, False)
O1_BLOCK_WINDOWS = 500
O1_BLOCK_PAIRS = 16
# O1's capture of the divergence kernel's inputs on the observed path
O1_CAPTURE_WINDOWS = 20

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores (both kernels run on the f32 pipes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# read before each call kernel_ms times: 20 times the H100's 50 MB L2, and
# ~0.3 ms of device time in which the host enqueues the call
L2_FLUSH_BYTES = 1 << 30

# Tolerances.  cuBLAS accumulates z @ w^T in another order than the
# kernels, so a near-tie can flip an assignment: a flip is accepted when the
# exact (f64) distances of the two rows differ by at most FLIP_REL times
# ||z||^2 + ||w||^2, the magnitude that cancels in the expanded distance
# (16 f32 ulps of it).  Min distances carry the same rounding.
FLIP_REL = 2e-6
# zsum at batch 1000 is a sum of a few points taken in another order
ZSUM_RTOL, ZSUM_ATOL = 1e-5, 1e-5
# BLOCKED_REF: the blocked kernel is held against its plain version run on
# the inputs cast to float64, under the same FLIP_REL rule.  At d=3072 the
# f32 plain version's batched cuBLAS product can sum all 3,072 terms of a
# distance into one f32 accumulator, with errors past FLIP_REL, while the
# kernel's 32 lane sums of 96 terms stay well inside it: in f32 the
# reference would be the less accurate side (check_blocked prints both).
# A flip moves one row on one side only; the oracle's first windows agree to
# CURVE_RTOL on the curve and in all but ROWS_FRAC of the codebook rows.
CURVE_RTOL, ROW_ATOL, ROWS_FRAC = 1e-3, 1e-4, 0.01
# the divergence kernel sums a worker's 524,288 squared differences in
# another order than torch.sum: f32 relative rounding of a few 1e-7
DIV_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_flush = []  # the buffer kernel_ms reads, made at its first call


def kernel_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median time of one call of fn, the yardstick of every kernel, plain
    and library time this script reports: CUDA events just before and
    after each of ``iters`` calls, with ``L2_FLUSH_BYTES`` read just before
    the first event, so the call finds none of its inputs in L2, as the
    bound (bytes over the HBM rate) assumes.  A read leaves L2 clean: a write would
    leave dirty lines that the timed call pays to write back.  The read
    also keeps the card busy while the host enqueues the call, so the
    wrapper's host time is left out where it is shorter than the read
    (~0.3 ms); ``time_ms`` counts it."""
    import torch
    if not _flush:
        _flush.append(torch.zeros(L2_FLUSH_BYTES // 4, device="cuda"))
    for _ in range(warmup):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        _flush[0].sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in marks)[iters // 2]


def in_turns(kernel, library, iters: int) -> tuple[list, list]:
    """``kernel_ms`` of a kernel and of the library call it is held
    against, in turns (kernel, library, library, kernel): two readings
    each, in ms."""
    order = (kernel, library, library, kernel)
    got = [kernel_ms(fn, iters) for fn in order]
    return [got[0], got[3]], [got[1], got[2]]


def mean(xs) -> float:
    return sum(xs) / len(xs)


def r4(xs) -> list:
    """Readings in ms to 0.1 us, for printing."""
    return [round(x, 4) for x in xs]


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flip_gap_ok(z, w, a_k: int, a_p: int) -> tuple[bool, float]:
    """Is a flip between rows a_k (kernel) and a_p (plain) a near-tie?"""
    z64 = z.double()
    dk = float(((z64 - w[a_k].double()) ** 2).sum())
    dp = float(((z64 - w[a_p].double()) ** 2).sum())
    scale = float((z64 ** 2).sum() + (w[a_p].double() ** 2).sum())
    return abs(dk - dp) <= FLIP_REL * scale, abs(dk - dp)


def check_ragged(dev) -> None:
    """Both kernels at shapes that divide none of their block sizes (d not
    a multiple of 32, kappa not of 8, 32 or 256, B not of 8): the window
    kernel against the per-step delta-kernel path (bitwise) and the plain
    version, the delta kernel against the plain version."""
    import torch

    from repro_torch.core import vq
    from repro_torch.kernels import vq_assign, vq_fused

    m, tau, kappa, d, b = 3, 7, 1001, 40, 37
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    zwin = torch.rand((m, tau, d), generator=gen, device=dev)
    w0 = torch.rand((kappa, d), generator=gen, device=dev)
    eps = vq.default_steps(torch.arange(1, tau + 1, device=dev))
    wk = vq_fused.vq_window(zwin, w0, eps)
    w = w0.expand(m, kappa, d).contiguous()
    for s in range(tau):
        counts, zsum, _, _ = vq_assign.vq_delta(
            zwin[:, s].unsqueeze(1).contiguous(), w)
        w = w - eps[s] * (counts.unsqueeze(-1) * w - zsum)
    win_plain = bool(torch.equal(wk, vq_fused.vq_window_plain(zwin, w0, eps)))
    z = torch.rand((m, b, d), generator=gen, device=dev)
    ck, zk, mk, ak = vq_assign.vq_delta(z, wk)
    cp, zp, mp, ap = vq_assign.vq_delta_plain(z, wk)
    flips = int((ak != ap).sum())
    print(f"check ragged shapes (M={m}, tau={tau}, kappa={kappa}, d={d}, "
          f"B={b}): window == per-step path {torch.equal(w, wk)}, window == "
          f"plain {win_plain}, delta flips {flips}, max |mind diff| "
          f"{float((mk - mp).abs().max()):.3e}")
    if not torch.equal(w, wk):
        fail("ragged shapes: window kernel differs from the per-step path")
    if flips or not (torch.equal(ck, cp) and torch.allclose(
            zk, zp, rtol=ZSUM_RTOL, atol=ZSUM_ATOL)):
        fail("ragged shapes: delta kernel disagrees with the plain version")
    if not win_plain:
        fail("ragged shapes: window kernel differs from the plain version")


def check_routes(dev, data, w0, wb) -> None:
    """The delta kernel's two routes and the window kernel's plans.

    Delta: the one-launch sweep (B <= 8) at B = 1, 2 and 8 and the passes
    at B = 9, each against the plain version (flips only at near-ties,
    counts and zsum exact where the assignments agree) and, bit for bit,
    against the assign kernel's (assign, mind), which always takes the
    passes; then the sweep at B = 1 called 1,000 times back to back, on a
    new point each call, each result against the plain version (a ticket
    or partial left stale by a call would show in the next), and replayed
    from a CUDA graph two sweeps a replay, its tickets read back as 0.
    Window: the plan at the slice's width, at d=3072 and under
    ``STREAM_BUDGET``, with how many resident clusters the card holds at
    once (M must fit one wave); the resident route at M = 1 and 3 (M = 8
    runs in phase 2), at a ragged kappa with register rows and at kappa = 5
    (blocks with no row), and the streaming route at d=128 under
    ``STREAM_BUDGET`` at M = 1 and 3, each against the per-step path
    through the delta kernel, bit for bit."""
    import torch

    from repro_torch.core import vq
    from repro_torch.kernels import vq_assign, vq_fused

    def against_plain(z, w, label):
        ck, zk, mk, ak = vq_assign.vq_delta(z, w)
        cp, zp, mp, ap = vq_assign.vq_delta_plain(z, w)
        aa, ma = vq_assign.vq_assign(z, w)
        if not (same_bits(ak, aa) and same_bits(mk, ma)):
            fail(f"delta {label}: (assign, mind) differ from the assign "
                 f"kernel's")
        flipped = (ak != ap).nonzero().tolist()
        for j, b in flipped:
            ok, gap = flip_gap_ok(z[j, b], w[j], int(ak[j, b]), int(ap[j, b]))
            if not ok:
                fail(f"delta {label}: worker {j} point {b}: {int(ak[j, b])} "
                     f"vs plain {int(ap[j, b])}, gap {gap:.3e}")
        if not flipped and not (torch.equal(ck, cp) and torch.equal(zk, zp)):
            fail(f"delta {label}: counts/zsum differ from the plain version")
        return len(flipped), float((mk - mp).abs().max())

    for b in (1, 2, 8, 9):
        route = vq_assign.argmin_plan(M, b, KAPPA, D, 1).route
        n_flip, err = against_plain(data[:, 100:100 + b].contiguous(), wb,
                                    f"B={b}")
        print(f"check delta route {route} at ({M}, {b}) x {KAPPA} x {D}: "
              f"== assign kernel bitwise, {n_flip} flips vs plain, max "
              f"|mind diff| {err:.3e}")
    bad, flips = [], 0
    for i in range(1000):
        z = data[:, 200 + i:201 + i].contiguous()
        ck, zk, mk, ak = vq_assign.vq_delta(z, wb)
        cp, zp, mp, ap = vq_assign.vq_delta_plain(z, wb)
        agree = ak == ap
        exact = (torch.equal(ck[agree[:, 0]], cp[agree[:, 0]])
                 and torch.equal(zk[agree[:, 0]], zp[agree[:, 0]]))
        if not bool(agree.all()):
            flips += int((~agree).sum())
            for j in (~agree[:, 0]).nonzero()[:, 0].tolist():
                ok, gap = flip_gap_ok(z[j, 0], wb[j], int(ak[j, 0]),
                                      int(ap[j, 0]))
                if not ok:
                    bad.append((i, j, gap))
        # one point a worker: one count of 1 in each worker's row
        if not exact or not torch.equal(ck.sum(dim=1),
                                        torch.ones_like(mk[:, 0])):
            bad.append((i, "counts/zsum"))
    print(f"check delta sweep, 1,000 calls back to back at ({M}, 1): "
          f"{len(bad)} bad, {flips} flips at near-ties")
    if bad:
        fail(f"delta sweep back to back: {bad[:5]}")
    # two sweeps captured in one CUDA graph, as a graph of eq.-9 ticks will
    # hold them, replayed on 10 new pairs of points.  The warm-up runs on
    # the capture stream, so the sweep's scratch (tickets zeroed once) is
    # made there before the capture and the graph holds the two launches
    # only: a ticket the kernel did not put back would leave no last block
    # in the next sweep, and the tickets must read 0 after the replays.
    z1 = data[:, 1300:1301].contiguous()
    z2 = data[:, 1400:1401].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        vq_assign.vq_delta(z1, wb)
    side.synchronize()
    tickets = vq_assign._scratch[(z1.device, side.cuda_stream)][0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = (vq_assign.vq_delta(z1, wb), vq_assign.vq_delta(z2, wb))
    if vq_assign._scratch[(z1.device, side.cuda_stream)][0] is not tickets:
        fail("the delta sweep made new scratch inside the graph capture")
    replays = 0
    for i in range(10):
        z1.copy_(data[:, 1301 + i:1302 + i])
        z2.copy_(data[:, 1401 + i:1402 + i])
        graph.replay()
        eager = (vq_assign.vq_delta(z1.clone(), wb),
                 vq_assign.vq_delta(z2.clone(), wb))
        replays += all(same_bits(a, b) for got, want in zip(captured, eager)
                       for a, b in zip(got, want))
    torch.cuda.synchronize()
    left = int(tickets.count_nonzero())
    print(f"check delta sweep in a CUDA graph (2 sweeps a replay): "
          f"{replays} of 10 replays == eager calls bitwise, {left} tickets "
          f"left non-zero")
    if replays != 10 or left:
        fail("the delta sweep replayed from a CUDA graph differs from an "
             "eager call, or left a ticket behind")

    main = vq_fused._window_plan(M, KAPPA, D)
    held = vq_fused.window_clusters(main)
    print(f"window plan ({M}, {KAPPA}, {D}): {main}; the card holds {held} "
          f"such clusters at once; ({M}, {KAPPA}, {WIDE_D}): "
          f"{vq_fused._window_plan(M, KAPPA, WIDE_D)}; ({M}, {KAPPA}, {D}) "
          f"under a {STREAM_BUDGET:,} B budget: "
          f"{vq_fused._window_plan(M, KAPPA, D, STREAM_BUDGET)}")
    if not main.resident or held < M:
        fail(f"the window plan {main} does not run M={M} workers in one wave "
             f"({held} clusters at once)")
    eps = vq.default_steps(torch.arange(1, TAU + 1, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = [(m, data[:m, :TAU].contiguous(), w0, smem) for m in (1, 3)
             for smem in (vq_assign.SMEM_MAX, STREAM_BUDGET)]
    w_rag = torch.rand((4001, D), generator=gen, device=dev)
    cases.append((3, torch.rand((3, TAU, D), generator=gen, device=dev),
                  w_rag, vq_assign.SMEM_MAX))
    # 5 rows: blocks 5-7 of each cluster hold none
    cases.append((2, data[:2, :TAU].contiguous(), w0[:5].contiguous(),
                  vq_assign.SMEM_MAX))
    for m, zwin, w_start, smem in cases:
        plan = vq_fused._window_plan(m, w_start.shape[0], D, smem)
        route = "resident" if plan.resident else "streaming"
        wk = vq_fused.vq_window(zwin, w_start, eps, smem)
        w = w_start.expand(m, *w_start.shape).contiguous()
        for s in range(TAU):
            counts, zsum, _, _ = vq_assign.vq_delta(
                zwin[:, s].unsqueeze(1).contiguous(), w)
            w = w - eps[s] * (counts.unsqueeze(-1) * w - zsum)
        print(f"check window {route} M={m}, kappa={w_start.shape[0]} "
              f"({plan.rows} rows a block, {plan.reg_rows} in registers, "
              f"{smem:,} B budget): == per-step delta path bitwise "
              f"{same_bits(wk, w)}")
        if plan.resident != (smem == vq_assign.SMEM_MAX) or not same_bits(
                wk, w):
            fail(f"window M={m}, kappa={w_start.shape[0]}: the {route} "
                 f"route differs from the per-step path")


def tie_heavy(dev, m: int, n: int) -> tuple:
    """(m, n) mostly zeros of both signs, 500 distinct magnitudes above 1,
    2,000 of magnitude 0.5 and 3,000 of 0.25 (both signs) per row, in
    random places; and ks that cut through the 0.5, 0.25 and zero ties."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.zeros((m, n), device=dev)
    sign = torch.where(torch.rand((m, n), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    x = x * sign                                   # -0.0 where sign < 0
    perm = torch.argsort(torch.rand((m, n), generator=gen, device=dev), dim=1)
    big = 1.0 + torch.rand((m, 500), generator=gen, device=dev)
    vals = torch.cat([big, torch.full((m, 2000), 0.5, device=dev),
                      torch.full((m, 3000), 0.25, device=dev)], dim=1)
    x.scatter_(1, perm[:, :5500], vals * torch.gather(sign, 1, perm[:, :5500]))
    return x, (1500, 4000, 6734)


def tie_runs(dev, m: int, n: int) -> tuple:
    """(m, n) of zeros of both signs with a run of 64 entries of magnitude
    0.5 (both signs) centred on every multiple of 32,768 inside the row
    (every slice boundary of the 8-block cluster at n = 524,288, and the
    midpoints between), and 3 distinct magnitudes in [1, 2) between each
    pair of runs; and ks whose cut falls at a run's centre (a slice
    boundary), 10 entries past it, at the last 0.5, and in the zeros
    40,000 entries on (across many warps' segments)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    sign = torch.where(torch.rand((m, n), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    x = torch.zeros((m, n), device=dev) * sign     # -0.0 where sign < 0
    pos = torch.arange(n, device=dev)
    run = ((pos + 32) % 32_768 < 64) & (pos >= 32) & (pos < n - 32)
    x[:, run] = 0.5 * sign[:, run]
    big = torch.tensor([b + 32_768 * j for j in range(n // 32_768)
                        for b in (8_000, 16_000, 24_000)], device=dev)
    x[:, big] = (1.0 + torch.rand((m, big.numel()), generator=gen,
                                  device=dev)) * sign[:, big]
    n_big, n_half = big.numel(), int(run.sum())
    return x, (n_big + 7 * 64 + 32, n_big + 7 * 64 + 42, n_big + n_half,
               n_big + n_half + 40_000)


def topk_equal(full, k: int, label: str) -> None:
    """The top-k kernel against its plain version, bit for bit, with one
    counted launch for the call."""
    from repro_torch.kernels import vq_fused
    before = vq_fused.launches_topk
    got = vq_fused.vq_topk(full, k)
    launched = vq_fused.launches_topk - before
    want = vq_fused.vq_topk_plain(full, k)
    same = [same_bits(a, b) for a, b in zip(got, want)]
    if not all(same) or launched != 1:
        fail(f"top-k {label}, k={k}: kernel differs from the plain version "
             f"(vals, idx, residual bitwise equal: {same}) or launched "
             f"{launched} times")


def topk_plan_line(full) -> str:
    """The launch plan of the top-k kernel on full: cluster and slice."""
    from repro_torch.kernels import vq_fused
    m, n = full.shape
    plan = vq_fused._topk_plan(m, n, 1)
    return (f"({m}, {n}): {m} clusters of {plan.cluster} blocks, slice "
            f"{plan.slice_len:,}")


def check_topk(dev, payload, normal, ks) -> None:
    """The top-k kernel against its plain version at the main path's shape
    (a window's displacement and N(0, 1) entries) at each of ``ks``, the
    displacement at k = its rows' non-zero counts and those counts +- 1
    (the T = 0 early exit on either side), ragged, tie-heavy, and with tie
    runs across the slice boundaries."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = KAPPA * D
    nz_rows = (payload != 0).sum(dim=1).tolist()
    nz_ks = sorted({c + d for c in (min(nz_rows), max(nz_rows))
                    for d in (-1, 0, 1) if 1 <= c + d <= n})
    for full, label, kk in ((payload, "window displacement", ks + tuple(nz_ks)),
                            (normal, "N(0, 1)", ks)):
        for k in kk:
            topk_equal(full, k, f"({M}, {n}) {label}")
    ragged = torch.randn((3, 40_040), generator=gen, device=dev)
    topk_equal(ragged, 37, "ragged (3, 40040)")
    ties, tie_ks = tie_heavy(dev, 4, 100_003)
    for k in tie_ks:
        topk_equal(ties, k, "tie-heavy (4, 100003)")
    runs, run_ks = tie_runs(dev, M, n)
    for k in run_ks:
        topk_equal(runs, k, f"tie runs ({M}, {n})")
    print(f"check top-k vs plain, bitwise (vals, idx, residual), one launch "
          f"a call: ({M}, {n}) window displacement (non-zero per row "
          f"{nz_rows}) at k = {ks} and {nz_ks} and N(0, 1) at k = {ks}; "
          f"ragged (3, 40040) at k = 37; tie-heavy (4, 100003) at k = "
          f"{tie_ks}; 0.5 tie runs across every slice boundary ({M}, {n}) "
          f"at k = {run_ks}: all equal")
    print(f"top-k plans: {topk_plan_line(payload)}; "
          f"{topk_plan_line(ragged)}; {topk_plan_line(ties)}")


def check_assign(z, w, label: str, f64: bool = False) -> tuple[int, float]:
    """The assign kernel against its plain version (flips only at
    near-ties, min distances within FLIP_REL of the cancelled magnitude;
    with ``f64`` the plain version run on the inputs cast to float64, see
    BLOCKED_REF) and against the delta kernel's (assign, mind), bit for
    bit.  Returns (flips, max |mind diff| off flipped rows)."""
    import torch

    from repro_torch.kernels import vq_assign

    ak, mk = vq_assign.vq_assign(z, w)
    ap, mp = (vq_assign.vq_assign_plain(z.double(), w.double()) if f64
              else vq_assign.vq_assign_plain(z, w))
    _, _, md, ad = vq_assign.vq_delta(z, w)
    same = torch.equal(ak, ad) and torch.equal(mk, md)
    if z.dim() == 2:
        z, w, ak, ap, mk, mp = (x[None] for x in (z, w, ak, ap, mk, mp))
    flips = (ak != ap).nonzero().tolist()
    for j, b in flips:
        ok, gap = flip_gap_ok(z[j, b], w[j], int(ak[j, b]), int(ap[j, b]))
        if not ok:
            fail(f"assign {label}: worker {j} row {b}: {int(ak[j, b])} vs "
                 f"plain {int(ap[j, b])}, gap {gap:.3e}: not a near-tie")
    keep = ak == ap
    w2 = (w.double() ** 2).sum(-1)
    scale = (z.double() ** 2).sum(-1) + torch.gather(w2, 1, ak.long())
    err = (mk.double() - mp.double()).abs()
    if bool(((err > FLIP_REL * scale) & keep).any()):
        fail(f"assign {label}: min distances differ from the plain version")
    max_err = float(err[keep].max()) if bool(keep.any()) else 0.0
    print(f"check assign {label} vs plain{' in f64' if f64 else ''}: "
          f"{len(flips)} flips of "
          f"{ak.numel()}, max |mind diff| {max_err:.3e}; == delta kernel's "
          f"(assign, mind) bitwise: {same}")
    if not same:
        fail(f"assign {label}: the assign kernel differs from the delta "
             f"kernel's assignment")
    return len(flips), max_err


def check_served(run) -> None:
    """Sampled served rows against the plain version at the version that
    served them."""
    import numpy as np
    import torch

    from repro_torch.kernels import vq_assign

    pairs = [(q, r) for q, r in run.report.samples if r is not None]
    if len(pairs) < SERVE_SAMPLE:
        fail(f"serving: only {len(pairs)} sampled responses")
    flips = 0
    max_err = 0.0
    for version in sorted({r.version for _, r in pairs}):
        snap = run.store.get(version)
        if snap is None:
            fail(f"serving: version {version} is gone from the store")
        w = snap.w_device
        sel = [(q, r) for q, r in pairs if r.version == version]
        z = torch.from_numpy(np.concatenate([q for q, _ in sel])).to(w.device)
        got_a = torch.from_numpy(np.concatenate([r.assign for _, r in sel]))
        got_m = torch.from_numpy(np.concatenate([r.mindist for _, r in sel]))
        ap, mp = vq_assign.vq_assign_plain(z, w)
        ap, mp = ap.cpu(), mp.cpu()
        for b in (got_a != ap).nonzero()[:, 0].tolist():
            ok, gap = flip_gap_ok(z[b], w, int(got_a[b]), int(ap[b]))
            if not ok:
                fail(f"serving: row {b} served {int(got_a[b])}, plain "
                     f"{int(ap[b])}, gap {gap:.3e}: not a near-tie")
            flips += 1
        keep = got_a == ap
        scale = ((z.double() ** 2).sum(-1)
                 + (w.double() ** 2).sum(-1)[got_a.long().to(w.device)]).cpu()
        err = (got_m.double() - mp.double()).abs()
        if bool(((err > FLIP_REL * scale) & keep).any()):
            fail("serving: served min distances differ from the plain "
                 "version")
        max_err = max(max_err, float(err[keep].max()))
    print(f"check served rows vs plain: {len(pairs)} rows, {flips} flips, "
          f"max |mind diff| {max_err:.3e}")


def serve_leg(serve, codebook, extra: list[str], label: str):
    """One run of the serving launcher at full width, with the assign
    kernel's count set to 0 before it and checked after it."""
    from repro_torch.kernels import vq_assign

    argv = ["--mode", "vq", "--kappa", str(KAPPA), "--dim", str(D),
            "--requests", str(SERVE_REQUESTS), "--seed", str(SEED)] + extra
    pauses: list[tuple[int, float]] = []   # (generation, ms) per GC pass
    started: list[float] = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"],
                           (time.perf_counter() - started.pop()) * 1e3))

    vq_assign.launches_assign = vq_assign.launches = 0
    gc.callbacks.append(on_gc)
    try:
        run = serve.run_vq(serve.parse_args(argv), codebook=codebook,
                           sample=SERVE_SAMPLE)
    finally:
        gc.callbacks.remove(on_gc)
    launches = vq_assign.launches_assign
    full = [ms for gen, ms in pauses if gen == 2]
    print(f"serving ({label}): {len(pauses)} garbage-collector passes, "
          f"{len(full)} full, longest full pass {max(full, default=0.0):.1f} "
          f"ms, longest pass {max((ms for _, ms in pauses), default=0.0):.1f}"
          f" ms")
    if run.rc != 0 or run.report is None:
        fail(f"serving ({label}): the launcher exited {run.rc}")
    rep, st = run.report, run.stats
    print(f"serving ({label}): {rep.qps:.1f} q/s, {rep.rows_per_s:.1f} "
          f"rows/s, p50 {rep.p50_ms:.3f} ms, p99 {rep.p99_ms:.3f} ms, "
          f"{st.flushes} flushes (full {st.full_flushes}, deadline "
          f"{st.deadline_flushes}), mean fill {st.mean_fill:.2f} rows, "
          f"{st.warmups} warm-ups, assign launches {launches}, delta "
          f"launches {vq_assign.launches}")
    if rep.failed or not rep.versions_monotonic:
        fail(f"serving ({label}): {rep.failed} failed, monotonic "
             f"{rep.versions_monotonic}")
    if launches != st.flushes + st.warmups or launches == 0:
        fail(f"serving ({label}): {launches} assign launches for "
             f"{st.flushes} flushes and {st.warmups} warm-ups")
    if vq_assign.launches:
        fail(f"serving ({label}): the delta kernel ran on the read path")
    check_served(run)
    return run, launches


def freeze_ab(serve, codebook, extra: list[str]) -> None:
    """What the launcher's ``gc.freeze()`` of its start-up heap buys, read
    on one machine: geometric legs with the freeze as shipped and with
    ``gc.freeze`` a no-op, in the order off, on, on, off."""
    real = gc.freeze
    p99 = {False: [], True: []}
    for frozen in (False, True, True, False):
        gc.freeze = real if frozen else (lambda: None)
        try:
            run, _ = serve_leg(serve, codebook, extra,
                               f"geometric, freeze {'on' if frozen else 'off'}")
        finally:
            gc.freeze = real
        p99[frozen].append(run.report.p99_ms)
    print(f"gc freeze A/B (geometric, order off/on/on/off): p99 ms off "
          f"{p99[False]}, on {p99[True]}")


def profile(label: str, run, units: int, unit: str) -> None:
    """Where the time goes: device time per kernel name from
    ``torch.profiler`` over one call of ``run`` (after one untraced
    warm-up call), per ``unit``, and the device's busy and idle share of the
    profiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    run()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy = sum(by_name.values())
    if busy == 0.0:
        print(f"profile {label}: the profiler saw no device time (not "
              f"measured)")
        return
    per = 1.0 / units
    print(f"profile ({units} {unit}s of {label}): wall {wall_us * per:.1f} "
          f"us/{unit} with the profiler on, device busy {busy * per:.1f} "
          f"us/{unit}, idle share {1.0 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us * per:9.2f} us/{unit}  {name[:100]}")


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.comm import ring
    from repro_torch.kernels import vq_assign, vq_fused
    vq_fused.launches = vq_fused.launches_blocked = 0
    vq_fused.launches_topk = vq_fused.launches_divergence = 0
    vq_assign.launches = vq_assign.launches_assign = 0
    ring.launches_ring = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.comm import ring
    from repro_torch.kernels import vq_assign, vq_fused
    return {"window": vq_fused.launches, "delta": vq_assign.launches,
            "assign": vq_assign.launches_assign,
            "blocked": vq_fused.launches_blocked,
            "topk": vq_fused.launches_topk, "ring": ring.launches_ring}


def expect_counts(label: str, **want) -> dict:
    """Every kernel's launch count since ``zero_counts``, the divergence
    kernel's too (no TPU kernel's counterpart, so not in
    ``launch_counts``): those named in ``want`` must equal it, every other
    must be 0."""
    from repro_torch.kernels import vq_fused
    counts = {**launch_counts(), "divergence": vq_fused.launches_divergence}
    if counts != {k: want.get(k, 0) for k in counts}:
        fail(f"{label}: launches {counts}, expected {want} and no other")
    return counts


def same_bits(a, b) -> bool:
    """Equal to the bit (float tensors compared as their int32 words)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def one_launch(fn, label: str) -> None:
    """Fail unless one call of fn launches one CUDA kernel (the argmin
    engine's host count, ``vq_assign.cuda_launches``)."""
    from repro_torch.kernels import vq_assign
    before = vq_assign.cuda_launches()
    fn()
    launched = vq_assign.cuda_launches() - before
    if launched != 1:
        fail(f"{label}: {launched} CUDA kernel launches, expected one")


def check_ring(x, label: str, mask=None) -> None:
    """The ring kernel against its plain version, bit for bit, with one
    launch for the call; prints the largest |ring - torch.sum| (a read-out:
    the two add in different orders)."""
    import torch

    from repro_torch.comm import ring

    before = ring.launches_ring
    got = ring.ring_all_reduce(x, mask)
    launched = ring.launches_ring - before
    want = ring.ring_all_reduce_plain(x, mask)
    dense = torch.sum(x if mask is None else mask[:, None] * x, dim=0)
    err = float((got - dense).abs().max())
    print(f"check ring {label} {tuple(x.shape)}: == plain bitwise "
          f"{same_bits(got, want)}, launches {launched}; max |ring - "
          f"torch.sum| {err:.3e}")
    if not (same_bits(got, want) and launched == 1):
        fail(f"ring {label}: the kernel differs from the plain version, or "
             f"it launched {launched} times")


def held_to(label: str, curve, ref_curve, w=None, ref_w=None) -> None:
    """A run against a reference run of the same inputs: the curve within
    CURVE_RTOL and, where codebooks are given, all but ROWS_FRAC of their
    rows within ROW_ATOL (the rule the oracle checks use)."""
    c_err = float(((curve - ref_curve).abs() / ref_curve.abs()).max())
    rows = 0
    if w is not None:
        rows = int(((w - ref_w).abs() > ROW_ATOL).any(dim=1).sum())
    print(f"check {label}: max rel curve diff {c_err:.3e} (rtol "
          f"{CURVE_RTOL}), curve bitwise equal {same_bits(curve, ref_curve)}"
          + ("" if w is None else f", codebook rows off by > {ROW_ATOL}: "
             f"{rows} of {w.shape[0]}"))
    if c_err > CURVE_RTOL or rows > ROWS_FRAC * (0 if w is None
                                                 else w.shape[0]):
        fail(f"{label}: the runs disagree")


def check_blocked(z, w, label: str, residual=None) -> float:
    """The blocked kernel against its plain version evaluated in float64
    (the same code on the inputs cast to f64; see BLOCKED_REF): flips only
    at near-ties; counts exact and equal to the kernel's own assignment's
    histogram; zsum within ZSUM_RTOL/ATOL of its own assignment's f64 sums
    and of the plain zsum off flipped rows; min distances within FLIP_REL of
    the cancelled magnitude; the epilogue equal, bit for bit, to the eager
    ``counts * w - zsum + residual`` on the kernel's own outputs.  The f32
    plain version's own flips against the f64 one are counted and printed.
    Returns max |mind diff| off flipped points."""
    import torch

    from repro_torch.kernels import vq_fused

    out = vq_fused.vq_delta_blocked(z, w, residual=residual)
    ck, zk, mk, ak = out[:4]
    cp, zp, mp64, ap = vq_fused.vq_delta_blocked_plain(z.double(),
                                                        w.double())
    cp, zp = cp.float(), zp.float()
    _, _, m32, a32 = vq_fused.vq_delta_blocked_plain(z, w)
    f32_flips = int((a32 != ap).sum())
    m, b, d = z.shape
    kappa = w.shape[1]
    dev = z.device
    diff = (ak != ap).nonzero().tolist()
    touched = torch.zeros((m, kappa), dtype=torch.bool, device=dev)
    for j, i in diff:
        ok, gap = flip_gap_ok(z[j, i], w[j], int(ak[j, i]), int(ap[j, i]))
        if not ok:
            fail(f"blocked {label}: worker {j} point {i}: {int(ak[j, i])} vs "
                 f"plain {int(ap[j, i])}, gap {gap:.3e}: not a near-tie")
        touched[j, int(ak[j, i])] = touched[j, int(ap[j, i])] = True
    counts_own = torch.zeros((m, kappa), device=dev).scatter_add_(
        1, ak.long(), torch.ones_like(mk))
    zsum_own = torch.zeros((m, kappa, d), dtype=torch.float64,
                           device=dev).index_put_(
        (torch.arange(m, device=dev)[:, None].expand(m, b), ak.long()),
        z.double(), accumulate=True)
    keep = ~touched
    z_err = float((zk - zp).abs()[keep].max())
    if not (torch.equal(ck, counts_own) and torch.equal(ck[keep], cp[keep])
            and torch.allclose(zk, zsum_own.float(), rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)
            and torch.allclose(zk[keep], zp[keep], rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)):
        fail(f"blocked {label}: counts/zsum disagree with the plain version")
    kept_pt = ak == ap
    w2 = (w.double() ** 2).sum(-1)
    scale = (z.double() ** 2).sum(-1) + torch.gather(w2, 1, ak.long())
    err = (mk.double() - mp64).abs()
    if bool(((err > FLIP_REL * scale) & kept_pt).any()):
        fail(f"blocked {label}: min distances differ from the plain version")
    m_err = float(err[kept_pt].max()) if bool(kept_pt.any()) else 0.0
    f32_err = float((m32.double() - mp64).abs()[a32 == ap].max())
    epi = "no residual"
    if residual is not None:
        if not same_bits(out[4], ck.unsqueeze(-1) * w - zk + residual):
            fail(f"blocked {label}: the epilogue differs from the eager "
                 f"expression on the kernel's own counts and zsum")
        epi = "epilogue == eager bitwise"
    print(f"check blocked {label} vs plain in f64: {len(diff)} flips of "
          f"{ak.numel()}, counts exact, max |zsum diff| off flipped rows "
          f"{z_err:.3e}, max |mind diff| {m_err:.3e}, {epi}; the f32 plain "
          f"version (cuBLAS) against the f64 one: {f32_flips} flips, max "
          f"|mind diff| {f32_err:.3e}")
    return m_err


def comm_layer_legs(dev, w0, data, eval_data, runs, lengths, payload,
                    normal_payload) -> None:
    """The comm layer on stacked workers at full width: M = 8 as 2 host
    groups of 4, the dynamic and the quorum merge, the tier-1 controller
    (the module docstring's item 17)."""
    import torch

    from repro_torch import comm
    from repro_torch.comm import ring
    from repro_torch.comm.sweep import acceptance_sparse_frac
    from repro_torch.core import vq
    from repro_torch.engine import Tier1BudgetController, Topology
    from repro_torch.engine import merge as merge_lib
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (FixedLatencyNetwork,
                                            GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import vq_fused
    from repro_torch.launch import train

    topo = Topology.from_spec(M, hosts=HOSTS)
    wph = topo.workers_per_host
    n_flat = KAPPA * D
    logical = 4 * n_flat
    t0_wire = comm.ring_wire_bytes(logical, wph)          # 3,145,728
    t1_dense = comm.ring_wire_bytes(logical, HOSTS)       # 2,097,152
    frac1 = acceptance_sparse_frac(KAPPA, D)              # 1/512
    k1 = comm.topk_count(n_flat, frac1)                   # 1,024
    t1_sparse = (HOSTS - 1) * k1 * 8                      # 8,192
    n_windows = N_PER // TAU
    cw = COMM_POINTS // TAU

    # the kernels at the slice's new shapes: a tier-1 payload (the host
    # groups' summed displacements) and a host group's rows
    partial = payload.view(HOSTS, wph, -1).sum(1).contiguous()
    normal1 = normal_payload[:HOSTS].contiguous()
    for full, label in ((partial, "tier-1 partial"), (normal1, "N(0, 1)")):
        topk_equal(full, k1, f"({HOSTS}, {n_flat}) {label}")
    topk_equal(partial[:, :1].contiguous(), 1, f"({HOSTS}, 1) one-entry leaf")
    print(f"check top-k vs plain, bitwise, one launch: ({HOSTS}, {n_flat}) "
          f"tier-1 partial and N(0, 1) at k = {k1}, ({HOSTS}, 1) at k = 1: "
          f"equal; plan {topk_plan_line(partial)}")
    for x, label in ((payload[:wph].contiguous(), "a host group's "
                      "displacement"),
                     (normal_payload[:wph].contiguous(), "a host group, "
                      "N(0, 1)")):
        check_ring(x, label)

    def flat_args(points, *extra):
        return ["--executor", "mesh", "--workers", str(M), "--points",
                str(points), "--dim", str(D), "--kappa", str(KAPPA), "--tau",
                str(TAU), "--seed", str(SEED)] + list(extra)

    def leg(label, argv, **want):
        zero_counts()
        res, ex, wall = train.run_vq(train.parse_args(argv))
        counts = expect_counts(label, **want)
        pts = M * int(argv[argv.index("--points") + 1])
        print(f"leg {label}: wall {wall:.2f} s ({wall / pts * 1e6:.3f} "
              f"us/point), launches {counts}, C first "
              f"{float(res.distortion[0]):.6f} last "
              f"{float(res.distortion[-1]):.6f}")
        if not (bool(torch.isfinite(res.distortion).all())
                and res.w_shared.shape == (KAPPA, D)
                and float(res.distortion[-1]) < float(res.distortion[0])):
            fail(f"{label}: result not finite, of the wrong shape, or not "
                 f"going down")
        return res, ex, counts

    def tiers(ex, windows):
        by = ex.last_comm["by_tag"]["merge"]["by_tier"]
        return (by[0]["wire_bytes"] // windows, by[1]["wire_bytes"] // windows,
                by[0]["wire_bytes"] % windows + by[1]["wire_bytes"] % windows)

    def same_run(a, b):
        return (same_bits(a.distortion, b.distortion)
                and same_bits(a.w_shared, b.w_shared))

    # -- leg 1: both tiers dense == the flat run, bit for bit -----------------
    inst = ["--network", "instant", "--scheme", "delta"]
    cut = flat_args(COMM_POINTS, *inst)
    flat, _, _ = leg("flat delta (cut)", cut, window=cw)
    hier_d, ex_hd, _ = leg("--hosts 2 --tier1-transport xla (cut)",
                           cut + ["--hosts", str(HOSTS), "--tier1-transport",
                                  "xla"], window=cw)
    per0, per1, rem = tiers(ex_hd, cw)
    print(f"check hier dense == flat dense, bitwise (curve, codebook): "
          f"{same_run(hier_d, flat)}; tier wire a window {per0:,} / {per1:,} "
          f"B")
    if not same_run(hier_d, flat) or (per0, per1, rem) != (t0_wire, t1_dense,
                                                            0):
        fail("hier dense: differs from the flat run, or tier bytes wrong")
    flat_r, _, cr = leg("flat ring delta (cut)", cut + ["--transport", "ring"],
                        window=cw, ring=2 * cw)
    hier_r, ex_hr, chr_ = leg(
        "--transport ring --hosts 2 --tier1-transport xla (cut)",
        cut + ["--transport", "ring", "--hosts", str(HOSTS),
               "--tier1-transport", "xla"], window=cw, ring=2 * cw)
    print(f"check hier ring (one ring launch over {M} rows a reduce) == flat "
          f"ring, bitwise: {same_run(hier_r, flat_r)}; ring launches "
          f"{chr_['ring']} == {cr['ring']}")
    if not same_run(hier_r, flat_r) or tiers(ex_hr, cw) != (t0_wire,
                                                           t1_dense, 0):
        fail("hier ring: differs from the flat ring run")

    # -- leg 2: a sparse tier 1 at full depth (the headline) -----------------
    sp_args = flat_args(N_PER, *inst) + ["--hosts", str(HOSTS)]
    hier_s, ex_hs, _ = leg("--hosts 2 (sparse tier 1, k = "
                                   f"{k1:,}), full depth", sp_args,
                                   window=n_windows, topk=n_windows)
    per0, per1, rem = tiers(ex_hs, n_windows)
    c_flat = float(runs["delta"][0].distortion[-1])
    gap = float(hier_s.distortion[-1]) / c_flat - 1.0
    print(f"check hier sparse: tier wire a window {per0:,} / {per1:,} B "
          f"({t1_dense // per1}x less than dense tier 1); final C "
          f"{float(hier_s.distortion[-1]):.6f} vs flat dense {c_flat:.6f} "
          f"({gap:+.4f})")
    if (per0, per1, rem) != (t0_wire, t1_sparse, 0) or abs(gap) >= 0.25:
        fail("hier sparse: tier bytes wrong or final distortion past 25% of "
             "the flat dense run's")
    head = data[:, : CHECK_WINDOWS * TAU]
    plain = MeshExecutor(InstantNetwork(), use_kernels=False, device=dev,
                         transport=comm.HierarchicalTransport(
                             "xla", comm.get_transport("sparse", frac=frac1),
                             topology=topo)).run(
        "delta", w0, head, eval_data, tau=TAU)
    held_to(f"hier sparse first {CHECK_WINDOWS} windows vs use_kernels=False",
            hier_s.distortion[:CHECK_WINDOWS], plain.distortion)

    # -- leg 3: eq. 9 over the hierarchy --------------------------------------
    geo = ["--scheme", "async_delta", "--network", "geometric", "--p-delay",
           str(P_DELAY)]
    n_t = COMM_POINTS
    res_ha, ex_ha, _ = leg("eq. 9 --hosts 2 (sparse tier 1), cut",
                           flat_args(n_t, *geo) + ["--hosts", str(HOSTS)],
                           delta=n_t, topk=n_t)
    per0, per1, _ = tiers(ex_ha, n_t)
    print(f"eq. 9 over the hierarchy: tier wire a tick {per0:,} / {per1:,} "
          f"B, one delta and one top-k launch a tick")
    if (per0, per1) != (t0_wire, t1_sparse):
        fail("eq. 9 hier: tier bytes wrong")
    n_c = COMM_CHECK_TICKS
    lc = lengths[:, : n_c // TAU + 2]
    flat_a = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU, lengths=lc)
    hier_a = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev,
                          transport=comm.HierarchicalTransport(
                              "xla", "xla", topology=topo)).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU, lengths=lc)
    print(f"check eq. 9 hier dense == flat, {n_c} ticks, bitwise: "
          f"{same_run(hier_a, flat_a)}")
    if not same_run(hier_a, flat_a):
        fail("eq. 9 hier dense differs from the flat run")

    # -- leg 4: the dynamic merge ---------------------------------------------
    dyn0, ex_d0, _ = leg("--merge dynamic --divergence-thresh 0 (cut)",
                         cut + ["--merge", "dynamic"], window=cw)
    probe = ex_d0.last_comm["by_tag"]["probe"]
    print(f"check dynamic at 0 == plain delta, bitwise: "
          f"{same_run(dyn0, flat)}; probe wire {probe['wire_bytes'] // cw} B "
          f"a window, merges {ex_d0.last_comm['by_tag']['merge']['calls']}")
    if (not same_run(dyn0, flat) or probe["wire_bytes"] != 7 * cw
            or ex_d0.last_comm["by_tag"]["merge"]["calls"] != cw):
        fail("dynamic at threshold 0 differs from the plain delta run")
    # T: the median probe of the threshold-0 leg, sum_i ||Delta_i||^2 a
    # window, from the plain delta loop written out over the same points
    w_srd, data_c, _ = train.make_inputs(train.parse_args(cut), dev)
    drifts = []
    eps_c = vq.default_steps(torch.arange(1, cw * TAU + 1, device=dev))
    for i in range(cw):
        span = slice(i * TAU, (i + 1) * TAU)
        delta = merge_lib.tree_sub_f32(w_srd, vq_fused.vq_window(
            data_c[:, span].contiguous(), w_srd, eps_c[span]))
        drifts.append((delta * delta).sum(dim=(1, 2)).sum())
        w_srd = merge_lib.tree_apply_delta(w_srd, torch.sum(delta, dim=0))
    drifts = torch.stack(drifts).cpu()
    thresh = float(drifts.median())
    if not same_bits(w_srd, flat.w_shared):
        fail("the loop written out for the probe differs from the delta run")
    print(f"dynamic threshold T = {thresh:.6e}: the median probe of the "
          f"threshold-0 leg's {cw} windows (first {float(drifts[0]):.4e}, "
          f"last {float(drifts[-1]):.4e})")
    dyn_args = ["--merge", "dynamic", "--divergence-thresh", repr(thresh)]
    zero_counts()
    res_dt, ex_dt, wall_dt = train.run_vq(train.parse_args(
        flat_args(N_PER, *inst) + dyn_args))
    counts_dt = expect_counts("dynamic at T", window=n_windows)
    n_trig = int(ex_dt.last_triggers.sum())
    by = ex_dt.last_comm["by_tag"]
    dense_w = comm.ring_wire_bytes(logical, M)
    print(f"leg --merge dynamic at T, full depth: wall {wall_dt:.2f} s "
          f"({wall_dt / (M * N_PER) * 1e6:.3f} us/point), launches "
          f"{counts_dt}, n_triggered {n_trig} of {n_windows}, merge wire "
          f"{by['merge']['wire_bytes']:,} B, probe wire "
          f"{by['probe']['wire_bytes']:,} B (plain delta "
          f"{n_windows * dense_w:,} B); final C "
          f"{float(res_dt.distortion[-1]):.6f} vs plain delta {c_flat:.6f}")
    if (by["merge"]["wire_bytes"] != n_trig * dense_w
            or by["probe"]["wire_bytes"] != 7 * n_windows
            or not bool(torch.isfinite(res_dt.distortion).all())):
        fail("dynamic at T: wire not re-priced to the triggered windows")
    zero_counts()
    res_dq, ex_dq, wall_dq = train.run_vq(train.parse_args(
        cut + dyn_args + ["--wire-quant", "int8"]))
    expect_counts("dynamic at T over int8", window=cw)
    n_trig_q = int(ex_dq.last_triggers.sum())
    by_q = ex_dq.last_comm["by_tag"]
    print(f"leg --merge dynamic at T --wire-quant int8 (cut): wall "
          f"{wall_dq:.2f} s, n_triggered {n_trig_q} of {cw}, merge wire "
          f"{by_q['merge']['wire_bytes']:,} B, probe wire "
          f"{by_q['probe']['wire_bytes']:,} B; final C "
          f"{float(res_dq.distortion[-1]):.6f}")
    if (by_q["merge"]["wire_bytes"] != n_trig_q * (dense_w // 4 + 4)
            or by_q["probe"]["wire_bytes"] != 5 * cw
            or not bool(torch.isfinite(res_dq.distortion).all())):
        fail("dynamic over int8: wire wrong or curve not finite")

    # -- leg 5: the quorum merge ----------------------------------------------
    q0, ex_q0, _ = leg("--quorum --network instant (cut)", cut + ["--quorum"],
                       window=cw)
    print(f"check quorum without lateness == plain delta, bitwise: "
          f"{same_run(q0, flat)}")
    if not same_run(q0, flat):
        fail("quorum without lateness differs from the plain delta run")
    q_args = flat_args(N_PER, "--scheme", "delta", "--network", "geometric",
                       "--p-delay", str(QUORUM_P_DELAY), "--quorum")
    res_q, ex_q, _ = leg("--quorum --network geometric --p-delay "
                                f"{QUORUM_P_DELAY}, full depth", q_args,
                                window=n_windows)
    late = GeometricDelayNetwork(QUORUM_P_DELAY).late_matrix(M, n_windows,
                                                             TAU)
    q_wire = comm.ring_wire_bytes(logical + 4, M)
    merge_q = ex_q.last_comm["by_tag"]["merge"]
    print(f"quorum: late worker-windows {ex_q.last_late_worker_windows:,} "
          f"(numpy late_matrix {int(late.sum()):,}, "
          f"{late.mean():.4f} of {late.size:,}); merge wire "
          f"{merge_q['wire_bytes'] // n_windows:,} B a window; final C "
          f"{float(res_q.distortion[-1]):.6f} vs plain delta {c_flat:.6f}")
    if (ex_q.last_late_worker_windows != int(late.sum())
            or merge_q["wire_bytes"] != n_windows * q_wire
            or q_wire != 3_670_023):
        fail("quorum: late count or merge wire wrong")

    # -- leg 6: the tier-1 controller -----------------------------------------
    net = FixedLatencyNetwork(latency_ticks=1, dcn_bytes_per_tick=CTL_DCN)
    ctl = Tier1BudgetController(net)
    hier_c = comm.HierarchicalTransport(
        "xla", comm.get_transport("sparse", frac=CTL_FRAC0), topology=topo)
    ex_c = MeshExecutor(net, transport=hier_c, tier1_controller=ctl,
                        publish_every=CTL_PUBLISH, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_c = ex_c.run("delta", w0, data[:, :COMM_POINTS], eval_data, tau=TAU)
    res_c.distortion.cpu()
    wall_c = time.perf_counter() - t0
    counts_c = expect_counts("tier-1 controller", window=cw, topk=cw)
    replay, ks = [], []
    shadow = comm.get_transport("sparse", frac=CTL_FRAC0)
    replica = Tier1BudgetController(net)
    for _ in range(cw // CTL_PUBLISH):
        k = comm.topk_count(n_flat, shadow.frac)
        ks.append(k)
        replay.append(replica.update(shadow, (HOSTS - 1) * k * 8))
    by_c = ex_c.last_comm["by_tag"]["merge"]["by_tier"][1]
    want_wire = sum(CTL_PUBLISH * (HOSTS - 1) * k * 8 for k in ks)
    print(f"leg tier-1 controller ({cw // CTL_PUBLISH} chunks of "
          f"{CTL_PUBLISH} windows, dcn {CTL_DCN:,} B a tick): wall "
          f"{wall_c:.2f} s, launches {counts_c}, frac after each chunk "
          f"{ex_c.last_tier1_fracs}, host replay {replay}; tier-1 wire "
          f"{by_c['wire_bytes']:,} B (replayed {want_wire:,}); ticks a "
          f"window {int(res_c.wall_ticks[0])}")
    if ex_c.last_tier1_fracs != replay or by_c["wire_bytes"] != want_wire:
        fail("tier-1 controller: trajectory or bytes differ from the host "
             "replay")
    for k in sorted(set(ks)):
        topk_equal(partial, k, f"({HOSTS}, {n_flat}) controller ladder")
    print(f"check top-k vs plain, bitwise, at every k of the ladder "
          f"{sorted(set(ks))}: equal")

    # -- the new kernel shapes, timed -----------------------------------------
    warm = time_ms(lambda: vq_fused.vq_topk(partial, k1), 100)
    tk, tl = in_turns(lambda: vq_fused.vq_topk(partial, k1),
                      lambda: torch.topk(partial.abs(), k1, dim=1), 50)
    tp = kernel_ms(lambda: vq_fused.vq_topk_plain(partial, k1), 5)
    tb = bound(4 * 2 * HOSTS * n_flat + 8 * HOSTS * k1, HOSTS * n_flat)
    print(f"timing top-k ({HOSTS}, {n_flat}), k={k1}, tier-1 partial: kernel "
          f"{r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in turns), plain "
          f"{tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]}); warm {warm:.4f} ms")
    xg = normal_payload[:wph].contiguous()
    rk, rl = in_turns(lambda: ring.ring_all_reduce(xg),
                      lambda: torch.sum(xg, dim=0), 200)
    rp = kernel_ms(lambda: ring.ring_all_reduce_plain(xg), 10)
    rb = bound(4 * (wph + 1) * n_flat, (wph - 1) * n_flat)
    print(f"timing ring ({wph}, {n_flat}): kernel {r4(rk)} ms, "
          f"torch.sum(x, dim=0) {r4(rl)} ms (in turns), plain {rp:.4f} ms, "
          f"bound {rb[0]:.4f} ms ({rb[1]})")

    # where the time goes: 200 windows of leg 2
    hs_ex = MeshExecutor(InstantNetwork(), device=dev,
                         transport=comm.HierarchicalTransport(
                             "xla", comm.get_transport("sparse", frac=frac1),
                             topology=topo))
    profile("--hosts 2, sparse tier 1",
            lambda: hs_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                              eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")


def pool_windows(total: int, m: int, boundaries) -> tuple[int, int]:
    """``(windows, late points)`` an elastic run takes from a pool of
    ``total`` points starting at ``m`` workers, with ``boundaries`` the
    ``(window, new M)`` resizes in order: a shrink first takes its departing
    workers' window of points, where the pool still holds it."""
    cursor = win = late = 0
    for at, new_m in boundaries:
        seg = min((total - cursor) // (m * TAU), at - win)
        cursor += seg * m * TAU
        win += seg
        if win < at:
            return win, late
        need = (m - new_m) * TAU
        if new_m < m and total - cursor >= need:
            cursor += need
            late += need
        m = new_m
    return win + (total - cursor) // (m * TAU), late


def elastic_legs(dev, w0, data, eval_data, runs) -> None:
    """Chaos, elastic resizes and checkpoints on stacked workers at full
    width (the module docstring's item 18, legs E1-E6)."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import async_vq
    from repro_torch.engine import (ChaosNetwork, ChaosSchedule,
                                    ElasticMeshExecutor,
                                    GeometricDelayNetwork, InstantNetwork)
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.launch import train

    late_b = 4 * KAPPA * D                                # 2,097,152
    fixed = runs["delta"][0]
    c_fixed = float(fixed.distortion[-1])

    def argv(points, *extra):
        return ["--executor", "mesh", "--workers", str(M), "--points",
                str(points), "--dim", str(D), "--kappa", str(KAPPA), "--tau",
                str(TAU), "--seed", str(SEED), "--network", "instant",
                "--scheme", "delta"] + list(extra)

    def spec(schedule):
        return ",".join(f"{w}:{m}" for w, m in schedule)

    def events(ex):
        return [(e.window, e.old_m, e.new_m, e.late_points, e.cause)
                for e in ex.resize_events]

    def same_run(a, b):
        return (same_bits(a.distortion, b.distortion)
                and same_bits(a.w_shared, b.w_shared))

    def elastic(label, args, windows, late_launches):
        zero_counts()
        res, ex, wall = train.run_vq(train.parse_args(args))
        # an observed window also launches the divergence kernel
        counts = expect_counts(label, window=windows + late_launches,
                               divergence=windows if ex.metrics else 0)
        if ex.metrics is not None:
            check_resize_obs(label, ex)
        curve = res.distortion
        print(f"leg {label}: wall {wall:.2f} s, {windows:,} windows, "
              f"launches {counts}, C first {float(curve[0]):.6f} last "
              f"{float(curve[-1]):.6f}; resizes "
              + "; ".join(f"@{e.window} M {e.old_m} -> {e.new_m} "
                          f"({e.cause}, late points {e.late_points}, wall_s "
                          f"{e.wall_s * 1e3:.2f} ms, checkpoint save "
                          f"{e.checkpoint_s * 1e3:.2f} ms)"
                          for e in ex.resize_events))
        if not (len(curve) == windows and res.w_shared.shape == (KAPPA, D)
                and bool(torch.isfinite(curve).all())
                and float(curve[-1]) < float(curve[0])):
            fail(f"{label}: result not finite, of the wrong length, or not "
                 f"going down")
        return res, ex, wall

    with tempfile.TemporaryDirectory(prefix="elastic_ckpt_") as tmp:
        # -- E1: --resize at full depth through the launcher -----------------
        ck1 = str(Path(tmp) / "e1")
        e1_args = argv(N_PER, "--resize", spec(ELASTIC_RESIZE), "--ckpt-dir",
                       ck1)
        n1, late1 = pool_windows(M * N_PER, M, ELASTIC_RESIZE)
        # observed (--metrics turns the tracer and the registry on)
        res1, ex1, _ = elastic("E1 --resize " + spec(ELASTIC_RESIZE),
                               e1_args + ["--metrics",
                                          str(Path(tmp) / "e1.jsonl")],
                               n1, 1)
        w_first = ELASTIC_RESIZE[0][0]
        head_ok = same_bits(res1.distortion[:w_first],
                            fixed.distortion[:w_first])
        gap = float(res1.distortion[-1]) / c_fixed - 1.0
        late = ex1.last_comm["by_tag"].get("late_delta")
        steps = Checkpointer(ck1).all_steps()
        print(f"check E1: first {w_first} windows == the fixed-M delta run "
              f"bitwise {head_ok}; final C {float(res1.distortion[-1]):.6f} "
              f"vs fixed-M {c_fixed:.6f} ({gap:+.4%}); late points "
              f"{late1}; late_delta {late}; checkpoints {steps}")
        want_ev, m_prev = [], M
        for w, m_new in ELASTIC_RESIZE:
            want_ev.append((w, m_prev, m_new, max(0, m_prev - m_new) * TAU,
                            "schedule"))
            m_prev = m_new
        if (not head_ok or abs(gap) > 1e-2 or events(ex1) != want_ev
                or late != {"calls": 1, "logical_bytes": late_b,
                            "wire_bytes": late_b}
                or steps != [w for w, _ in ELASTIC_RESIZE]):
            fail(f"E1: events {events(ex1)} (expected {want_ev}), the head, "
                 f"the final distortion, the late-delta record or the "
                 f"checkpoints are wrong")

        # -- E2: resume from E1's last checkpoint -----------------------------
        n2 = n1 - ELASTIC_RESIZE[-1][0]
        res2, ex2, _ = elastic("E2 --resume", e1_args + ["--resume"], n2, 0)
        ok2 = (same_bits(res2.distortion, res1.distortion[-n2:])
               and same_bits(res2.w_shared, res1.w_shared)
               and ex2.resize_events == [])
        print(f"check E2: the resumed {n2:,} windows == E1's suffix, curve "
              f"and codebook bitwise: {ok2}")
        if not ok2:
            fail("E2: the resumed run differs from E1's suffix")

        # -- E3: periodic checkpoints, no resize (cut) ------------------------
        cut = data[:, :COMM_POINTS]
        ck3 = Checkpointer(str(Path(tmp) / "e3"))
        n3 = COMM_POINTS // TAU

        def e3(resume):
            return ElasticMeshExecutor(
                [], network=InstantNetwork(), checkpointer=ck3,
                checkpoint_every=CKPT_EVERY, resume=resume, device=dev)

        zero_counts()
        t0 = time.perf_counter()
        res3 = e3(False).run("delta", w0, cut, eval_data, tau=TAU)
        res3.distortion.cpu()
        wall3 = time.perf_counter() - t0
        expect_counts("E3", window=n3)
        steps3 = ck3.all_steps()
        last3 = n3 // CKPT_EVERY * CKPT_EVERY
        zero_counts()
        res3b = e3(True).run("delta", w0, cut, eval_data, tau=TAU)
        expect_counts("E3 resume", window=n3 - last3)
        ok3 = (same_bits(res3b.distortion, res3.distortion[last3:])
               and same_bits(res3b.w_shared, res3.w_shared)
               and same_bits(res3.distortion, fixed.distortion[:n3]))
        print(f"check E3 (checkpoint_every={CKPT_EVERY}, {n3:,} windows, "
              f"wall {wall3:.2f} s): checkpoints {steps3}; resumed from "
              f"{last3} == the suffix, and the run == the fixed-M run's "
              f"head, bitwise: {ok3}")
        if not ok3 or steps3[-1] != last3:
            fail("E3: periodic checkpoint or resume differs")

    # -- E4: whole host groups leave and return, dense tiers (cut) ------------
    n4, late4 = pool_windows(M * COMM_POINTS, M, HIER_RESIZE)
    flat4, _, _ = elastic("E4 flat --resize " + spec(HIER_RESIZE),
                          argv(COMM_POINTS, "--resize", spec(HIER_RESIZE)),
                          n4, 1)
    hier4, ex4, _ = elastic(
        f"E4 --hosts {HOSTS} --tier1-transport xla",
        argv(COMM_POINTS, "--resize", spec(HIER_RESIZE), "--hosts",
             str(HOSTS), "--tier1-transport", "xla"), n4, 1)
    late4b = ex4.last_comm["by_tag"]["late_delta"]
    print(f"check E4: hier dense == flat elastic, bitwise: "
          f"{same_run(hier4, flat4)}; late points {late4}; late_delta "
          f"{late4b}")
    if (not same_run(hier4, flat4)
            or late4b["by_tier"] != {1: {"calls": 1, "logical_bytes": late_b,
                                         "wire_bytes": late_b}}):
        fail("E4: hier differs from the flat elastic run, or the late delta "
             "is not charged to tier 1")

    # -- E5: chaos at full depth ----------------------------------------------
    sched = ChaosSchedule.from_spec(CHAOS_SPEC, windows=N_PER // TAU, m=M,
                                    hosts=2)
    kills = [e.window for e in sched.kill_events]
    bounds = [(w, M - 1 - i) for i, w in enumerate(kills)]
    n5, late5 = pool_windows(M * N_PER, M, bounds)
    with tempfile.TemporaryDirectory(prefix="e5_obs_") as tmp5:
        res5, ex5, _ = elastic(f"E5 --chaos {CHAOS_SPEC}",
                               argv(N_PER, "--chaos", CHAOS_SPEC, "--metrics",
                                    str(Path(tmp5) / "e5.jsonl")), n5,
                               len(kills))
    net5 = ChaosNetwork(InstantNetwork(), sched)
    want_late, lo = 0, 0
    for (at, _), m in zip(bounds + [(n5, None)], [M] + [m for _, m in
                                                         bounds]):
        want_late += int(net5.late_matrix(m, at - lo, TAU,
                                          window0=lo).sum())
        lo = at
    fired = [(e.window, e.cause) for e in ex5.resize_events]
    print(f"check E5: {sched.describe()}; resizes {fired}; late "
          f"worker-windows {ex5.last_late_worker_windows:,} (numpy late "
          f"matrices of the segments {want_late:,}); final C "
          f"{float(res5.distortion[-1]):.6f} vs the plain delta run's "
          f"{c_fixed:.6f}")
    if (fired != [(w, "chaos_kill") for w in kills]
            or ex5.last_late_worker_windows != want_late
            or sum(e.late_points for e in ex5.resize_events) != late5):
        fail("E5: chaos kills or late worker-windows differ")
    # the reference counts a kill twice in chaos_kills: at its resize, and
    # as a scheduled event of the segment that starts at its window
    mt5 = ex5.metrics
    obs5 = (mt5.counter("chaos_kills").value,
            mt5.counter("chaos_late_worker_windows").value)
    print(f"check E5 metrics: chaos_kills {obs5[0]:.0f} (2 x {len(kills)} "
          f"kills, the reference's count), chaos_late_worker_windows "
          f"{obs5[1]:.0f} (numpy late matrices {want_late})")
    if obs5 != (2 * len(kills), want_late):
        fail("E5: chaos metrics differ from the kills and late matrices")

    # -- E6: eq. 9 over a ChaosNetwork (cut) ----------------------------------
    net6 = ChaosNetwork(GeometricDelayNetwork(P_DELAY),
                        ChaosSchedule(E6_FAULTS, hosts=2))
    n6 = COMM_POINTS
    lengths6 = net6.round_lengths(torch.Generator().manual_seed(SEED), M,
                                  n6 // TAU + 2, TAU)
    zero_counts()
    t0 = time.perf_counter()
    res6 = MeshExecutor(net6, device=dev).run(
        "async_delta", w0, data[:, :n6], eval_data, tau=TAU,
        lengths=lengths6)
    curve6 = res6.distortion.cpu()
    wall6 = time.perf_counter() - t0
    counts6 = expect_counts("E6", delta=n6)
    dones = async_vq.done_mask(lengths6, M, n6, TAU, torch.device("cpu"))
    (k_win, _, k_target), = [f for f in E6_FAULTS if f[1] == "kill"]
    last = int(lengths6[k_target, :k_win].to(torch.int64).sum())
    dead_ok = bool(dones[last, k_target]) and not bool(
        dones[last + 1:, k_target].any())
    print(f"leg E6 eq. 9 over ChaosNetwork {E6_FAULTS}, {n6:,} ticks: wall "
          f"{wall6:.2f} s, launches {counts6}, C first {float(curve6[0]):.6f}"
          f" last {float(curve6[-1]):.6f}; worker {k_target}'s last round "
          f"lands at tick {last}, none after: {dead_ok}")
    if not (dead_ok and bool(torch.isfinite(curve6).all())
            and float(curve6[-1]) < float(curve6[0])):
        fail("E6: the dead worker's rounds complete, or the curve is wrong")
    n_c = ASYNC_CHECK_TICKS
    lc = lengths6[:, : n_c // TAU + 2]
    oracle = async_vq.scheme_async(w0, data[:, :n_c], eval_data, tau=TAU,
                                   lengths=lc)
    short = MeshExecutor(net6, device=dev).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU, lengths=lc)
    held_to(f"E6 first {n_c} ticks vs scheme_async", res6.distortion[
        : n_c // 10], oracle.distortion, short.w_shared, oracle.w_shared)
    if not (torch.equal(short.wall_ticks, oracle.wall_ticks)
            and same_bits(short.distortion, res6.distortion[: n_c // 10])):
        fail("E6: the first ticks' run differs from the main run's head")


def check_resize_obs(label: str, ex) -> None:
    """An observed elastic run's resize metrics and spans against its
    ``ResizeStats``."""
    mt, tr = ex.metrics, ex.tracer
    stats = ex.resize_events
    spans = [(s.attrs["window"], s.attrs["old_m"], s.attrs["new_m"],
              s.attrs["cause"]) for s in tr.spans("resize")]
    got = (mt.counter("resize_events").value,
           mt.counter("late_delta_points").value,
           mt.histogram("resize_wall_s").count)
    want = (len(stats), sum(e.late_points for e in stats), len(stats))
    print(f"check {label} obs: resize_events {got[0]:.0f}, "
          f"late_delta_points {got[1]:.0f}, resize spans {spans} == "
          f"ResizeStats {want}")
    if got != want or spans != [(e.window, e.old_m, e.new_m, e.cause)
                                for e in stats]:
        fail(f"{label}: resize metrics or spans differ from ResizeStats")


def segment_windows(total: int, m: int, boundaries) -> list[int]:
    """The windows of each segment an elastic run takes from a pool of
    ``total`` points (``pool_windows``' walk, segment by segment)."""
    cursor = win = 0
    out = []
    for at, new_m in boundaries:
        seg = min((total - cursor) // (m * TAU), at - win)
        out.append(seg)
        cursor += seg * m * TAU
        win += seg
        if win < at:
            return out
        need = (m - new_m) * TAU
        if new_m < m and total - cursor >= need:
            cursor += need
        m = new_m
    return out + [(total - cursor) // (m * TAU)]


def threads_serving_obs_legs(dev, w0, data, eval_data, runs, geo_run,
                             lengths) -> None:
    """The thread runtime, training while serving, and the trace/metrics
    layer at full width (the module docstring's item 19, legs T1-T4, S1
    and O1)."""
    import statistics
    import threading

    import torch

    from repro_torch.core import async_runtime, vq
    from repro_torch.engine import get_executor
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import _build, vq_assign, vq_fused
    from repro_torch.launch import serve, train
    from repro_torch.obs import MetricsRegistry, Tracer, check_trace, \
        load_trace

    thread_argv = ["--executor", "thread", "--scheme", "async_delta",
                   "--workers", str(M), "--points", str(N_PER), "--dim",
                   str(D), "--kappa", str(KAPPA), "--tau", str(TAU), "--seed",
                   str(SEED), "--network", "instant"]

    def thread_leg(label, run, duration_s):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res, ex = run()
        stats = ex.last_stats
        pushes = sum(s.pushes for s in stats)
        points = sum(s.points for s in stats)
        stale = sum(s.stale_reads for s in stats)
        counts = expect_counts(label, window=pushes)
        curve = res.distortion
        print(f"leg {label}: {points / duration_s:,.0f} points/s, "
              f"{pushes / duration_s:,.0f} rounds/s, stale-read share "
              f"{stale / max(pushes, 1):.3f}, inbox peak "
              f"{max(s.inbox_peak for s in stats)} deltas (bound "
              f"{async_runtime.INBOX_PER_WORKER * len(stats) or 'none'}), "
              f"launches {counts}, points by "
              f"worker {[s.points for s in stats]}, C first "
              f"{float(curve[0]):.6f} last {float(curve[-1]):.6f} over "
              f"{len(curve)} samples to {float(res.wall_ticks[-1]):.2f} s, "
              f"peak device memory above the leg's start "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.0f} MiB")
        if not (all(s.pushes > 0 for s in stats)
                and bool(torch.isfinite(curve).all())
                and float(curve[-1]) < float(curve[0])
                and res.w_shared.shape == (KAPPA, D)):
            fail(f"{label}: a worker never pushed, or the distortion did not "
                 f"fall")
        return stats

    # -- T1: the thread runtime through the launcher --------------------------
    plan1 = vq_fused._window_plan(1, KAPPA, D)
    print(f"thread runtime's window launch at (1, {TAU}, {D}): resident "
          f"{plan1.resident}, one cluster of {vq_fused.CLUSTER_BLOCKS} blocks "
          f"of {plan1.threads} threads (on {vq_fused.CLUSTER_BLOCKS} of the "
          f"card's {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs)")

    def t1():
        res, ex, _ = train.run_vq(train.parse_args(
            thread_argv + ["--duration-s", str(T1_SECONDS)]))
        return res, ex

    thread_leg(f"T1 --executor thread, {T1_SECONDS} s", t1, T1_SECONDS)
    # a read-out: T1 with no bound on the inbox (the reference's queue), to
    # show what the bound does to the backlog, the memory and the curve
    bound = async_runtime.INBOX_PER_WORKER
    async_runtime.INBOX_PER_WORKER = 0
    try:
        thread_leg(f"T1 without the inbox's bound (a read-out), "
                   f"{T1_SECONDS} s", t1, T1_SECONDS)
    finally:
        async_runtime.INBOX_PER_WORKER = bound
    # a read-out: rounds/s as the workers grow (the threads share the
    # interpreter lock, and every PyTorch call hands it over)
    scaling = {}
    for m in (1, 2, 4):
        zero_counts()
        ex = get_executor("thread", duration_s=1.0, device=dev)
        ex.run("async_delta", w0, data[:m], eval_data[:m], tau=TAU)
        pushes = sum(s.pushes for s in ex.last_stats)
        expect_counts(f"thread runtime at M = {m}", window=pushes)
        scaling[m] = pushes
    print(f"thread runtime, rounds/s over 1 s by M: {scaling} (a read-out)")

    # -- T2: a 50x straggler; T3: 10 ms communication delays -----------------
    def t2():
        ex = get_executor("thread", duration_s=T23_SECONDS,
                          straggler={0: 50.0}, device=dev)
        return ex.run("async_delta", w0, data, eval_data, tau=TAU), ex

    stats2 = thread_leg(f"T2 straggler {{0: 50}}, {T23_SECONDS} s", t2,
                        T23_SECONDS)
    if not all(stats2[0].points < s.points for s in stats2[1:]):
        fail("T2: the straggler did not lag every other worker")

    def t3():
        res, ex, _ = train.run_vq(train.parse_args(
            thread_argv + ["--duration-s", str(T23_SECONDS),
                           "--comm-delay-s", "0.01"]))
        return res, ex

    thread_leg(f"T3 --comm-delay-s 0.01, {T23_SECONDS} s", t3, T23_SECONDS)

    # -- T4: the store's atomic apply on a device tensor ----------------------
    store = async_runtime.BlobStore(torch.zeros((KAPPA, D), device=dev))
    writers, per_writer = 8, 200

    def hammer():
        for _ in range(per_writer):
            store.apply(lambda w: w + 1.0)

    threads = [threading.Thread(target=hammer) for _ in range(writers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    version, value = store.get()
    exact = (not any(th.is_alive() for th in threads)
             and version == writers * per_writer
             and torch.equal(value, torch.full_like(value,
                                                    writers * per_writer)))
    print(f"check T4: {writers} threads x {per_writer} BlobStore.apply(+1) "
          f"on a ({KAPPA}, {D}) device tensor: version {version}, every "
          f"entry {writers * per_writer}.0: {exact}")
    if not exact:
        fail("T4: the store lost an update")

    # -- S1: training while serving -------------------------------------------
    with tempfile.TemporaryDirectory(prefix="s1_obs_") as tmp:
        trace_path, metrics_path = Path(tmp) / "s1.json", Path(tmp) / "s1.jsonl"
        zero_counts()
        run = serve.run_vq(serve.parse_args(
            ["--mode", "vq", "--train-publish", "--kappa", str(KAPPA),
             "--dim", str(D), "--points", str(S1_POINTS), "--tau", str(TAU),
             "--publish-every", str(S1_PUBLISH), "--requests",
             str(SERVE_REQUESTS), "--network", "geometric", "--p-delay",
             str(P_DELAY), "--seed", str(SEED), "--trace", str(trace_path),
             "--metrics", str(metrics_path)]),
            sample=SERVE_SAMPLE, keep=1_000_000)
        if run.rc != 0 or run.report is None:
            fail(f"S1: the serving launcher exited {run.rc}")
        rep, st, trainer = run.report, run.stats, run.trainer
        n_w = S1_POINTS // TAU
        bounds = [(max(1, n_w // 3), M // 2), (max(2, 2 * n_w // 3), M)]
        segs = segment_windows(M * S1_POINTS, M, bounds)
        windows = sum(segs)
        lates = sum(1 for e in trainer.resize_events if e.late_points)
        publishes = sum(-(-w // S1_PUBLISH) for w in segs)
        counts = expect_counts("S1", window=windows + lates,
                               assign=st.flushes + st.warmups,
                               divergence=windows)
        events = load_trace(str(trace_path))
        errs = check_trace(events, expect_spans=["flush", "load", "window"],
                           expect_merge_tiers={"flat"})
        geo = geo_run.report
        print(f"leg S1 --train-publish: {rep.summary()}; trainer windows "
              f"{windows:,} (segments {segs}), late deltas {lates}, "
              f"published {run.store.version} (1 + {publishes} on_window "
              f"calls), launches {counts}; p50 {rep.p50_ms:.3f} ms, p99 "
              f"{rep.p99_ms:.3f} ms while training vs phase 7's geometric "
              f"leg p50 {geo.p50_ms:.3f} ms, p99 {geo.p99_ms:.3f} ms; trace "
              f"{sum(1 for e in events if e.get('ph') == 'X'):,} spans, "
              f"check_trace {errs or 'clean'}")
        if (rep.failed or not rep.versions_monotonic or rep.n_versions < 2
                or run.store.version != 1 + publishes
                or trainer.metrics.counter("windows_total",
                                           scheme="delta").value != windows
                or errs):
            fail("S1: failed requests, versions, publications, windows or "
                 "the trace are wrong")
        check_served(run)

    # -- O1: the instrumentation's cost and exactness at full depth ----------
    # the divergence kernel against its plain version: a window's results
    # and their merge, a ragged shape (4-byte loads) and a misaligned one
    eps = vq.default_steps(torch.arange(1, TAU + 1, device=dev))
    w_fin = vq_fused.vq_window(data[:, :TAU].contiguous(), w0, eps)
    w_new = w0 - torch.sum(w0 - w_fin, dim=0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ragged = torch.randn((3, 37, 5), generator=gen, device=dev)
    shifted = torch.randn(3 * 4096 * 128 + 1, generator=gen,
                          device=dev)[1:].view(3, 4096, 128)
    div_err = 0.0
    for a, b, label in ((w_fin, w_new, f"({M}, {KAPPA}, {D}) a window"),
                        (ragged, ragged[0] * 0.5, "(3, 37, 5)"),
                        (shifted, shifted[1] * 0.5,
                         "(3, 4096, 128) misaligned")):
        before = vq_fused.launches_divergence
        got = vq_fused.vq_divergence(a, b)
        want = vq_fused.vq_divergence_plain(a, b)
        rel = float(((got - want).abs() / want.abs()).max())
        div_err = max(div_err, float((got - want).abs().max()))
        print(f"check divergence kernel vs plain {label}: max rel diff "
              f"{rel:.3e}, one launch {vq_fused.launches_divergence - before}")
        if rel > DIV_RTOL or vq_fused.launches_divergence - before != 1:
            fail(f"divergence kernel {label}: {rel:.3e} from plain")
    # its last block combines through a ticket: 1,000 calls back to back
    # give the first call's bits, and leave the stream's tickets at 0
    first = vq_fused.vq_divergence(w_fin, w_new)
    again = [vq_fused.vq_divergence(w_fin, w_new) for _ in range(1000)]
    tickets = vq_assign._sweep_scratch(
        w_fin.device, _build.current_stream(w_fin.device), 1, 1)[0]
    same = all(same_bits(first, x) for x in again)
    print(f"check divergence kernel 1,000 calls back to back: bits equal "
          f"{same}, tickets left {int(tickets.abs().sum())}")
    if not same or bool(tickets.any()):
        fail("divergence kernel: bits moved between calls, or a ticket "
             "was left set")
    fixed = runs["delta"][0]
    full = ["--executor", "mesh", "--scheme", "delta", "--workers", str(M),
            "--points", str(N_PER), "--dim", str(D), "--kappa", str(KAPPA),
            "--tau", str(TAU), "--seed", str(SEED), "--network", "instant"]
    walls = {False: [], True: []}
    with tempfile.TemporaryDirectory(prefix="o1_obs_") as tmp:
        for i, observed in enumerate(O1_ORDER):
            argv = full + (["--trace", str(Path(tmp) / f"o1_{i}.json"),
                            "--metrics", str(Path(tmp) / f"o1_{i}.jsonl")]
                           if observed else [])
            # no earlier run's objects for the collector to walk in this one
            gc.collect()
            zero_counts()
            t_all = time.perf_counter()
            res, ex, wall = train.run_vq(train.parse_args(argv))
            t_all = time.perf_counter() - t_all
            expect_counts(f"O1 {'observed' if observed else 'bare'}",
                          window=N_PER // TAU,
                          divergence=N_PER // TAU if observed else 0)
            walls[observed].append(wall)
            if not (same_bits(res.distortion, fixed.distortion)
                    and same_bits(res.w_shared, fixed.w_shared)):
                fail("O1: an observed or bare run differs from the main "
                     "path's delta run")
            if not observed:
                del res, ex
                continue
            mt = ex.metrics
            by_tag = ex.last_comm["by_tag"]
            mirror = {tag: {f: int(mt.counter(
                f"comm_{f}", tag=tag, tier="flat", transport="xla").value)
                for f in ("calls", "logical_bytes", "wire_bytes")}
                for tag in by_tag}
            per_window = by_tag["merge"]["wire_bytes"] / (N_PER // TAU)
            # the first observed run's trace is read back (each is ~50 MB)
            checked = i == O1_ORDER.index(True)
            errs = check_trace(
                load_trace(str(Path(tmp) / f"o1_{i}.json")),
                expect_merge_tiers={"flat"},
                expect_counters=["distortion", "codebook_divergence"]
            ) if checked else []
            print(f"leg O1 observed run {i}: wall {wall:.2f} s (with the "
                  f"trace export {t_all:.2f} s), windows_total "
                  f"{mt.counter('windows_total', scheme='delta').value:.0f}, "
                  f"comm_* {mirror} == CommLog.summarize "
                  f"{ {t: {f: v[f] for f in mirror[t]} for t, v in by_tag.items()} }"
                  f", merge {per_window:,.0f} B a window, "
                  f"{len(ex.tracer.spans()):,} spans, check_trace "
                  f"{(errs or 'clean') if checked else 'not read'}")
            if (mt.counter("windows_total", scheme="delta").value
                    != N_PER // TAU or per_window != 3_670_016 or errs
                    or any(mirror[t] != {f: v[f] for f in mirror[t]}
                           for t, v in by_tag.items())):
                fail("O1: windows_total, the comm mirror, the merge bytes "
                     "or the trace are wrong")
            del res, ex, mt
    ratios = [o / b for o, b in zip(walls[True], walls[False])]
    print(f"O1 full depth (--scheme delta, in the order "
          f"{['observed' if o else 'bare' for o in O1_ORDER]}): walls bare "
          f"{[round(w, 3) for w in walls[False]]} s, "
          f"observed {[round(w, 3) for w in walls[True]]} s, pair ratios "
          f"{[round(r, 4) for r in ratios]} (a read-out)")

    # the divergence kernel on the observed path: its inputs captured at
    # each launch, its outputs against the plain version, and the emitted
    # codebook_divergence series the mean of the plain values
    from repro_torch.engine import mesh as mesh_mod
    launched = []
    kernel = mesh_mod.ops.vq_divergence

    def capture(w_fin, w_srd):
        out = kernel(w_fin, w_srd)
        launched.append((w_fin.clone(), w_srd.clone(), out))
        return out

    ex_c = MeshExecutor(InstantNetwork(), tracer=Tracer(),
                        metrics=MetricsRegistry(), device=dev)
    mesh_mod.ops.vq_divergence = capture
    try:
        ex_c.run("delta", w0, data[:, : O1_CAPTURE_WINDOWS * TAU], eval_data,
                 tau=TAU)
    finally:
        mesh_mod.ops.vq_divergence = kernel
    plain = [vq_fused.vq_divergence_plain(a, b) for a, b, _ in launched]
    cap_rel = max(float(((o - q).abs() / q.abs()).max())
                  for (_, _, o), q in zip(launched, plain))
    series = [c.value for c in ex_c.tracer.counters("codebook_divergence")]
    want = [float(q.mean()) for q in plain]
    series_rel = max((abs(g - w) / abs(w) for g, w in zip(series, want)),
                     default=float("inf"))
    print(f"check O1 divergence kernel on the observed path "
          f"({len(launched)} windows captured): max rel diff from plain "
          f"{cap_rel:.3e}, codebook_divergence series vs the plain mean "
          f"{series_rel:.3e} (tolerance {DIV_RTOL:g})")
    if (len(launched) != O1_CAPTURE_WINDOWS or len(series) != len(want)
            or cap_rel > DIV_RTOL or series_rel > DIV_RTOL):
        fail("O1: the observed path's divergence differs from plain")
    del launched, plain, ex_c

    # the gate: short blocks, bare and observed in turns, in one process
    bdata = data[:, : O1_BLOCK_WINDOWS * TAU]
    blocks = {False: [], True: []}

    def block(observed):
        kw = ({"tracer": Tracer(), "metrics": MetricsRegistry()}
              if observed else {})
        ex_b = MeshExecutor(InstantNetwork(), device=dev, **kw)
        gc.collect()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex_b.run("delta", w0, bdata, eval_data, tau=TAU).distortion.cpu()
        blocks[observed].append(time.perf_counter() - t0)
        expect_counts("O1 block", window=O1_BLOCK_WINDOWS,
                      divergence=O1_BLOCK_WINDOWS if observed else 0)

    for i in range(O1_BLOCK_PAIRS):
        for observed in ((False, True) if i % 2 == 0 else (True, False)):
            block(observed)
    # the reference's estimator for its bar (benchmarks/run.py:619-629,
    # 679): the smaller of the best-of-N ratio and the median pair ratio,
    # since host noise only adds time and a real cost inflates both
    bratios = [o / b for o, b in zip(blocks[True], blocks[False])]
    median = statistics.median(bratios)
    best = min(blocks[True]) / min(blocks[False])
    ratio = min(best, median)
    print(f"check O1 ({O1_BLOCK_PAIRS} pairs of {O1_BLOCK_WINDOWS}-window "
          f"blocks of --scheme delta, in turns): walls bare "
          f"{[round(w, 4) for w in blocks[False]]} s, observed "
          f"{[round(w, 4) for w in blocks[True]]} s, pair ratios "
          f"{[round(r, 4) for r in bratios]}; median pair {median:.4f}, "
          f"best of {O1_BLOCK_PAIRS} {best:.4f}: overhead {ratio:.4f} (bar "
          f"1.03, the reference's max_overhead and estimator)")
    if ratio > 1.03:
        fail(f"O1: instrumentation costs {ratio:.4f}x the bare run's wall")

    # eq. 9, cut: bits and a read-out of the ratio (host-bound path), bare
    # and observed in turns
    n9 = O1_TICKS
    l9 = lengths[:, : n9 // TAU + 2]
    out9, walls9 = {}, {False: [], True: []}
    for observed in O1_ORDER:
        kw = ({"tracer": Tracer(), "metrics": MetricsRegistry()}
              if observed else {})
        ex9 = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev, **kw)
        gc.collect()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res9 = ex9.run("async_delta", w0, data[:, :n9], eval_data, tau=TAU,
                       lengths=l9)
        res9.distortion.cpu()
        walls9[observed].append(time.perf_counter() - t0)
        out9[observed] = (res9, ex9)
        expect_counts("O1 eq. 9", delta=n9)
    (r_b, _), (r_o, ex_o) = out9[False], out9[True]
    same9 = (same_bits(r_b.distortion, r_o.distortion)
             and same_bits(r_b.w_shared, r_o.w_shared))
    rounds = ex_o.metrics.counter("async_rounds_total",
                                  scheme="async_delta").value
    errs9 = check_trace(ex_o.tracer.chrome_events(),
                        expect_merge_tiers={"flat"},
                        expect_counters=["distortion"])
    ratios9 = [o / b for o, b in zip(walls9[True], walls9[False])]
    print(f"check O1 eq. 9 ({n9:,} ticks, bare and observed in turns): "
          f"observed == bare bitwise {same9}; walls bare "
          f"{[round(w, 2) for w in walls9[False]]} s, observed "
          f"{[round(w, 2) for w in walls9[True]]} s, pair ratios "
          f"{[round(r, 4) for r in ratios9]} (a read-out: host-bound); "
          f"async_rounds_total {rounds:.0f}; check_trace {errs9 or 'clean'}")
    if not same9 or errs9:
        fail("O1 eq. 9: the observed run differs from the bare one, or its "
             "trace is not clean")


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    from repro_torch import comm
    from repro_torch import device as device_lib
    from repro_torch.comm import ring
    from repro_torch.core import async_vq, schemes, vq
    from repro_torch.engine import get_executor
    from repro_torch.engine import merge as merge_lib
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import _build, autotune, ops, vq_assign, vq_fused
    from repro_torch.launch import serve, train

    device_lib.pin_full_f32()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- inputs at the slice's width ------------------------------------------
    full = ["--executor", "mesh", "--workers", str(M), "--points", str(N_PER),
            "--dim", str(D), "--kappa", str(KAPPA), "--tau", str(TAU),
            "--seed", str(SEED), "--network", "instant"]
    args = train.parse_args(full + ["--scheme", "delta"])
    w0, data, eval_data = train.make_inputs(args, dev)
    if not ops.window_fits(KAPPA, D) or not ops.delta_fits(D):
        fail("the slice's width does not fit the kernels' shared memory")

    # -- 2+3. kernels vs plain, and the window-vs-per-step card contract ------
    eps_all = vq.default_steps(
        torch.arange(1, CHECK_WINDOWS * TAU + 1, device=dev))
    w_srd = w0
    flips, gaps, unexplained = 0, [], 0
    win_equal = win_total = 0
    win_err = contract_err = mind_err = 0.0
    contract_ok = True
    for i in range(CHECK_WINDOWS):
        span = slice(i * TAU, (i + 1) * TAU)
        zwin = data[:, span].contiguous()
        eps = eps_all[span]
        wk = vq_fused.vq_window(zwin, w_srd, eps)
        wp = vq_fused.vq_window_plain(zwin, w_srd, eps)
        w = w_srd.expand(M, KAPPA, D).contiguous()
        flipped = set()
        for s in range(TAU):
            z = zwin[:, s].unsqueeze(1).contiguous()
            ck, zk, mk, ak = vq_assign.vq_delta(z, w)
            cp, zp, mp, ap = vq_assign.vq_delta_plain(z, w)
            for j in range(M):
                a_k, a_p = int(ak[j, 0]), int(ap[j, 0])
                if a_k != a_p:
                    ok, gap = flip_gap_ok(z[j, 0], w[j], a_k, a_p)
                    flips += 1
                    gaps.append(gap)
                    if not ok:
                        fail(f"window {i} step {s} worker {j}: assignment "
                             f"{a_k} vs plain {a_p} with distance gap "
                             f"{gap:.3e}: not a near-tie")
                    flipped.add(j)
                    continue
                if not (torch.equal(ck[j], cp[j]) and torch.equal(zk[j], zp[j])):
                    fail(f"window {i} step {s} worker {j}: counts/zsum of "
                         f"the delta kernel differ from the plain version")
                mind_err = max(mind_err, abs(float(mk[j, 0] - mp[j, 0])))
                scale = float((z[j, 0].double() ** 2).sum()
                              + (w[j, a_k].double() ** 2).sum())
                if abs(float(mk[j, 0] - mp[j, 0])) > FLIP_REL * scale:
                    fail(f"window {i} step {s} worker {j}: min distance "
                         f"{float(mk[j, 0])} vs plain {float(mp[j, 0])}")
            h = ck.unsqueeze(-1) * w - zk
            w = w - eps[s] * h
        if not torch.equal(w, wk):
            contract_ok = False
            contract_err = max(contract_err, float((w - wk).abs().max()))
        for j in range(M):
            win_total += 1
            if torch.equal(wk[j], wp[j]):
                win_equal += 1
            elif j not in flipped:  # a difference no flip explains
                unexplained += 1
                win_err = max(win_err, float((wk[j] - wp[j]).abs().max()))
        w_srd = w_srd - torch.sum(w_srd - wk, dim=0)   # eq. 8
    print(f"check window vs plain ({CHECK_WINDOWS} windows x {M} workers, "
          f"kappa={KAPPA}, d={D}, tau={TAU}): {win_equal}/{win_total} "
          f"worker-windows bitwise equal, max |diff| without a flip "
          f"{win_err:.3e}, {unexplained} unexplained")
    print(f"check delta batch 1 vs plain ({CHECK_WINDOWS * TAU} steps x {M}): "
          f"counts/zsum exact where assignments agree, max |mind diff| "
          f"{mind_err:.3e}, {flips} flips, gaps "
          f"{[f'{g:.2e}' for g in gaps]}")
    if unexplained:
        fail(f"{unexplained} worker-windows differ from the plain version "
             f"without an assignment flip")
    print(f"check card contract (window kernel == per-step delta-kernel "
          f"path, bitwise, {CHECK_WINDOWS} windows): "
          f"{'holds' if contract_ok else 'BROKEN'}"
          + ("" if contract_ok else f", max |diff| {contract_err:.3e}"))
    if not contract_ok:
        fail("the window kernel and the per-step delta-kernel path differ")

    check_ragged(dev)
    check_routes(dev, data, w0, wk.contiguous())
    # the first window's displacement w0 - w_local: the sparse transport's
    # payload, zero outside the <= tau rows each worker touched
    # -- 9. the top-k kernel ----------------------------------------------------
    payload = merge_lib.tree_sub_f32(w0, vq_fused.vq_window(
        data[:, :TAU].contiguous(), w0, eps_all[:TAU])).reshape(M, -1)
    normal_payload = torch.randn(
        (M, KAPPA * D), generator=torch.Generator(device=dev).manual_seed(
            SEED + 5), device=dev)
    k_main = max(1, int(SPARSE_FRAC * KAPPA * D))
    k_l = max(1, int(LOSSY_FRAC * KAPPA * D))
    check_topk(dev, payload, normal_payload, (k_main, k_l, 1, KAPPA * D))

    # delta kernel at the eval shape, against plain and its own assignment
    wb = wk.contiguous()
    ck, zk, mk, ak = vq_assign.vq_delta(eval_data, wb)
    cp, zp, mp, ap = vq_assign.vq_delta_plain(eval_data, wb)
    diff = (ak != ap).nonzero().tolist()
    touched = torch.zeros((M, KAPPA), dtype=torch.bool, device=dev)
    for j, b in diff:
        ok, gap = flip_gap_ok(eval_data[j, b], wb[j], int(ak[j, b]),
                              int(ap[j, b]))
        if not ok:
            fail(f"batch 1000: worker {j} point {b} flip gap {gap:.3e}")
        touched[j, int(ak[j, b])] = touched[j, int(ap[j, b])] = True
    counts_own = torch.zeros((M, KAPPA), device=dev).scatter_add_(
        1, ak.long(), torch.ones_like(mk))
    zsum_own = torch.zeros((M, KAPPA, D), dtype=torch.float64,
                           device=dev).index_put_(
        (torch.arange(M, device=dev)[:, None].expand(M, N_EVAL), ak.long()),
        eval_data.double(), accumulate=True)
    keep = ~touched
    b_err = float((zk - zp).abs()[keep].max())
    if not (torch.equal(ck, counts_own) and torch.equal(ck[keep], cp[keep])
            and torch.allclose(zk, zsum_own.float(), rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)
            and torch.allclose(zk[keep], zp[keep], rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)):
        fail("batch 1000: counts/zsum disagree with the plain version")
    b_mind = float((mk - mp).abs().max())
    print(f"check delta batch {N_EVAL} vs plain: {len(diff)} flips, counts "
          f"exact off flipped rows, max |zsum diff| {b_err:.3e} "
          f"(rtol {ZSUM_RTOL}, atol {ZSUM_ATOL}), max |mind diff| "
          f"{b_mind:.3e}")

    # -- 4. the assign kernel: flush, eval and ragged shapes ------------------
    wide = ["--executor", "mesh", "--workers", str(M), "--points",
            str(WIDE_POINTS), "--dim", str(WIDE_D), "--kappa", str(KAPPA),
            "--tau", str(TAU), "--seed", str(SEED)]
    wide_async = wide + ["--scheme", "async_delta", "--network", "geometric",
                         "--p-delay", str(P_DELAY)]
    w0w, dataw, evalw = train.make_inputs(train.parse_args(wide_async), dev)
    zq = data[0, :FLUSH_ROWS].contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    zr = torch.rand((3, 37, 40), generator=gen, device=dev)
    wr = torch.rand((3, 1001, 40), generator=gen, device=dev)
    assign_err = 0.0
    for z, w, label in ((zq, wb[0], f"flush {FLUSH_ROWS} x {KAPPA} x {D}"),
                        (eval_data, wb, f"eval ({M}, {N_EVAL}) x {KAPPA} x "
                                        f"{D}"),
                        (zr, wr, "ragged (M=3, kappa=1001, d=40, B=37)")):
        assign_err = max(assign_err, check_assign(z, w, label)[1])
    # the eq.-9 tick's shape at d=3072 (the fused=False leg's), the sweep;
    # against the plain version in float64 and the blocked kernel, bitwise
    w_tick = (w0w + 0.01 * torch.randn(
        (M, KAPPA, WIDE_D), generator=torch.Generator(device=dev).manual_seed(
            SEED + 12), device=dev)).contiguous()
    z_tick = dataw[:, :1].contiguous()
    check_assign(z_tick, w_tick, f"({M}, 1) x {KAPPA} x {WIDE_D}", f64=True)
    a_t, m_t = vq_assign.vq_assign(z_tick, w_tick)
    _, _, m_b, a_b = vq_fused.vq_delta_blocked(z_tick, w_tick)
    if not (same_bits(a_t, a_b) and same_bits(m_t, m_b)):
        fail(f"assign ({M}, 1) x {KAPPA} x {WIDE_D} differs from the blocked "
             f"kernel's (assign, mind)")
    one_launch(lambda: vq_assign.vq_assign(z_tick, w_tick),
               f"assign ({M}, 1) x {WIDE_D}")
    del w_tick
    # the tiled argmin (B > 8) against the sweep over the same points
    # taken 8 at a time: one engine, one order, the same bits
    w_wide9 = w0w.expand(M, KAPPA, WIDE_D).contiguous()
    for z, w, label in ((eval_data[:, :9].contiguous(), wb, f"B=9, d={D}"),
                        (eval_data[:, :128].contiguous(), wb,
                         f"B=128, d={D}"),
                        (eval_data, wb, f"B={N_EVAL}, d={D}"),
                        (evalw[:, :9].contiguous(), w_wide9,
                         f"B=9, d={WIDE_D}")):
        a_k, m_k = vq_assign.vq_assign(z, w)
        parts = [vq_assign.vq_assign(
            z[:, i:i + vq_assign.SMALL_B].contiguous(), w)
            for i in range(0, z.shape[1], vq_assign.SMALL_B)]
        same = (same_bits(a_k, torch.cat([q[0] for q in parts], dim=1))
                and same_bits(m_k, torch.cat([q[1] for q in parts], dim=1)))
        print(f"check tiled argmin ({M}, {label}) == the sweep over the same "
              f"points 8 at a time, bitwise (assign, mind): {same}")
        if not same:
            fail(f"the tiled argmin ({label}) differs from the sweep")
    del w_wide9
    one_launch(lambda: vq_assign.vq_assign(zq, wb[0]), "assign flush")
    one_launch(lambda: vq_assign.vq_assign(eval_data, wb), "assign eval")
    print(f"check assign launches: one CUDA kernel a call at ({M}, 1) x "
          f"{WIDE_D} (the sweep), the flush and the eval (the tiled argmin)")

    # -- 5+6. the main path, and its first windows against the oracles -------
    runs = {}
    for scheme in ("delta", "average"):
        zero_counts()
        res, executor, wall = train.run_vq(
            train.parse_args(full + ["--scheme", scheme]))
        counts = {"window": vq_fused.launches, "delta": vq_assign.launches}
        if vq_fused.launches_blocked:
            fail(f"{scheme}: the blocked kernel ran at d={D}")
        n_windows = N_PER // TAU
        curve = res.distortion.cpu()
        print(f"main path --scheme {scheme}: C first {float(curve[0]):.6f} "
              f"last {float(curve[-1]):.6f}, wall {wall:.2f} s "
              f"({wall / (M * N_PER) * 1e6:.3f} us/point), launches {counts}")
        if counts["window"] != n_windows:
            fail(f"{scheme}: window kernel launched {counts['window']} times, "
                 f"expected {n_windows}")
        if (res.w_shared.shape != (KAPPA, D) or len(curve) != n_windows
                or not bool(torch.isfinite(curve).all())
                or not bool(torch.isfinite(res.w_shared).all())):
            fail(f"{scheme}: result of the wrong shape or not finite")
        if not float(curve[-1]) < float(curve[0]):
            fail(f"{scheme}: distortion did not go down")
        runs[scheme] = (res, counts, wall)

    head = data[:, : CHECK_WINDOWS * TAU]
    for scheme, oracle_fn in (("delta", schemes.scheme_delta),
                              ("average", schemes.scheme_average)):
        oracle = oracle_fn(w0, head, eval_data, tau=TAU)
        short = MeshExecutor(InstantNetwork(), device=dev).run(
            scheme, w0, head, eval_data, tau=TAU)
        held_to(f"{scheme} first {CHECK_WINDOWS} windows vs scheme_{scheme}",
                runs[scheme][0].distortion[:CHECK_WINDOWS],
                oracle.distortion, short.w_shared, oracle.w_shared)
        ticks_ok = torch.equal(short.wall_ticks, oracle.wall_ticks)
        print(f"check {scheme} first {CHECK_WINDOWS} windows vs "
              f"scheme_{scheme}: ticks equal {ticks_ok}")
        if not ticks_ok:
            fail(f"{scheme}: first windows' ticks differ from the oracle's")

    vq_fused.launches = vq_assign.launches = 0
    unfused = MeshExecutor(InstantNetwork(), fused=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_u = unfused.run("delta", w0, data[:, :UNFUSED_POINTS], eval_data,
                        tau=TAU)
    curve_u = res_u.distortion.cpu()
    wall_u = time.perf_counter() - t0
    counts_u = {"window": vq_fused.launches, "delta": vq_assign.launches}
    print(f"main path fused=False (per-step delta kernel), --scheme delta, "
          f"{UNFUSED_POINTS} points/worker: C last {float(curve_u[-1]):.6f}, "
          f"wall {wall_u:.2f} s, launches {counts_u} (one delta launch "
          f"at batch 1 is one CUDA kernel launch, the sweep)")
    if counts_u["delta"] != (UNFUSED_POINTS // TAU) * TAU or counts_u["window"]:
        fail(f"fused=False leg: launches {counts_u}")
    fused_head = runs["delta"][0].distortion[: UNFUSED_POINTS // TAU].cpu()
    if not torch.equal(curve_u, fused_head):
        fail("fused=False curve differs from the window kernel's")
    print("check fused vs fused=False curves (first "
          f"{UNFUSED_POINTS // TAU} windows): bitwise equal")

    # -- 7. serving the delta run's codebook ----------------------------------
    trained = runs["delta"][0].w_shared
    geometric = ["--network", "geometric", "--p-delay", str(P_DELAY)]
    geo_run, serve_launches = serve_leg(serve, trained, geometric,
                                        "geometric arrivals")
    serve_leg(serve, trained, ["--network", "instant", "--tick-ms", "0"],
              "saturating")
    freeze_ab(serve, trained, geometric)

    # -- 8. eq. 9 at full width ------------------------------------------------
    zero_counts()
    res_a, ex_a, wall_a = train.run_vq(train.parse_args(
        ["--executor", "mesh", "--scheme", "async_delta", "--workers", str(M),
         "--points", str(N_PER), "--dim", str(D), "--kappa", str(KAPPA),
         "--tau", str(TAU), "--seed", str(SEED), "--network", "geometric",
         "--p-delay", str(P_DELAY)]))
    counts_a = {"window": vq_fused.launches, "delta": vq_assign.launches}
    curve_a = res_a.distortion.cpu()
    merge_a = ex_a.last_comm["by_tag"]["merge"]
    print(f"main path --scheme async_delta: C first {float(curve_a[0]):.6f} "
          f"last {float(curve_a[-1]):.6f}, wall {wall_a:.2f} s "
          f"({wall_a / (M * N_PER) * 1e6:.3f} us/point), launches "
          f"{counts_a}, merge wire {merge_a['wire_bytes']:,} B over "
          f"{merge_a['calls']:,} masked reduces")
    if counts_a["delta"] != N_PER or counts_a["window"] or (
            vq_fused.launches_blocked):
        fail(f"async_delta: launches {counts_a}, expected {N_PER} delta "
             f"and no window or blocked launch")
    c_sync = float(runs["delta"][0].distortion[-1])
    if (len(curve_a) != N_PER // 10 or res_a.w_shared.shape != (KAPPA, D)
            or not bool(torch.isfinite(curve_a).all())):
        fail("async_delta: result of the wrong shape or not finite")
    if not (float(curve_a[-1]) < float(curve_a[0])
            and float(curve_a[-1]) < 2.0 * c_sync):
        fail(f"async_delta: final distortion {float(curve_a[-1]):.6f} not "
             f"below the initial one and 2x the sync delta run's {c_sync:.6f}")
    n_c = ASYNC_CHECK_TICKS
    lengths = GeometricDelayNetwork(P_DELAY).round_lengths(
        torch.Generator().manual_seed(SEED), M, N_PER // TAU + 2, TAU)
    lengths_c = lengths[:, : n_c // TAU + 2]
    oracle_a = async_vq.scheme_async(w0, data[:, :n_c], eval_data, tau=TAU,
                                     lengths=lengths_c)
    short_a = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU,
        lengths=lengths_c)
    head_a = res_a.distortion[: n_c // 10]
    held_to(f"async_delta first {n_c} ticks vs scheme_async", head_a,
            oracle_a.distortion, short_a.w_shared, oracle_a.w_shared)
    ticks_ok = torch.equal(short_a.wall_ticks, oracle_a.wall_ticks)
    head_ok = torch.equal(short_a.distortion, head_a)
    print(f"check async_delta first {n_c} ticks: ticks equal {ticks_ok}, "
          f"short run's curve == main run's head {head_ok}")
    if not (ticks_ok and head_ok):
        fail("async_delta: first ticks disagree with the oracle")

    # -- 10. the sparse transport ---------------------------------------------
    n_windows = N_PER // TAU
    vq_fused.launches = vq_fused.launches_topk = vq_assign.launches = 0
    res_s, ex_s, wall_s = train.run_vq(train.parse_args(
        full + ["--scheme", "delta", "--transport", "sparse",
                "--compress-frac", str(SPARSE_FRAC)]))
    counts_s = {"window": vq_fused.launches, "topk": vq_fused.launches_topk,
                "delta": vq_assign.launches}
    merge_s = ex_s.last_comm["by_tag"]["merge"]
    res_d, _, wall_d = runs["delta"]
    curve_s = res_s.distortion.cpu()
    same_curve = torch.equal(res_s.distortion, res_d.distortion)
    same_w = torch.equal(res_s.w_shared, res_d.w_shared)
    print(f"main path --scheme delta --transport sparse --compress-frac "
          f"{SPARSE_FRAC} (k={k_main}): C first {float(curve_s[0]):.6f} last "
          f"{float(curve_s[-1]):.6f}, wall {wall_s:.2f} s "
          f"({wall_s / (M * N_PER) * 1e6:.3f} us/point; dense delta "
          f"{wall_d / (M * N_PER) * 1e6:.3f}), launches {counts_s}, merge "
          f"wire {merge_s['wire_bytes']:,} B per worker; curve == dense "
          f"{same_curve}, codebook == dense {same_w}")
    if (counts_s["topk"] != n_windows or counts_s["window"] != n_windows
            or counts_s["delta"]):
        fail(f"sparse delta: launches {counts_s}, expected {n_windows} "
             f"top-k and window launches")
    if merge_s["wire_bytes"] != n_windows * (M - 1) * k_main * 8:
        fail(f"sparse delta: merge wire {merge_s['wire_bytes']:,} B")
    if not (same_curve and same_w):
        fail("sparse delta at k >= tau * d differs from the dense run")

    # lossy: k = 524 < tau * d, error feedback at work
    lossy_full = ["--executor", "mesh", "--workers", str(M), "--points",
                  str(LOSSY_POINTS), "--dim", str(D), "--kappa", str(KAPPA),
                  "--tau", str(TAU), "--seed", str(SEED), "--network",
                  "instant", "--scheme", "delta"]
    lossy_args = train.parse_args(lossy_full + [
        "--transport", "sparse", "--compress-frac", str(LOSSY_FRAC)])
    vq_fused.launches = vq_fused.launches_topk = 0
    res_l, _, wall_l = train.run_vq(lossy_args)
    counts_l = {"window": vq_fused.launches, "topk": vq_fused.launches_topk}
    res_ld, _, _ = train.run_vq(train.parse_args(lossy_full))
    curve_l = res_l.distortion.cpu()
    lw = LOSSY_POINTS // TAU
    if counts_l != {"window": lw, "topk": lw}:
        fail(f"lossy sparse delta: launches {counts_l}")
    if not (bool(torch.isfinite(curve_l).all())
            and float(curve_l[-1]) < float(curve_l[0])):
        fail("lossy sparse delta: curve not finite or not going down")
    w0l, datal, evall = train.make_inputs(lossy_args, dev)
    eps_l = vq.default_steps(torch.arange(1, lw * TAU + 1, device=dev))
    w_hand, curve_hand = w0l, []
    resid = torch.zeros((M, KAPPA * D), device=dev)
    for i in range(CHECK_WINDOWS):
        span = slice(i * TAU, (i + 1) * TAU)
        wk = vq_fused.vq_window(datal[:, span].contiguous(), w_hand,
                                eps_l[span])
        full_p = merge_lib.tree_sub_f32(w_hand, wk).reshape(M, -1) + resid
        vals, idx, resid = vq_fused.vq_topk_plain(full_p, k_l)
        sent = torch.zeros_like(full_p).scatter_(1, idx.long(), vals)
        w_hand = merge_lib.tree_apply_delta(
            w_hand, torch.sum(sent.view(M, KAPPA, D), dim=0))
        curve_hand.append(torch.mean(vq.distortion(evall, w_hand), dim=0))
    curve_hand = torch.stack(curve_hand)
    short_l = get_executor(
        "mesh", network=InstantNetwork(),
        transport=comm.get_transport("sparse", frac=LOSSY_FRAC),
        device=dev).run("delta", w0l, datal[:, : CHECK_WINDOWS * TAU],
                        evall, tau=TAU)
    hand_ok = (torch.equal(res_l.distortion[:CHECK_WINDOWS], curve_hand)
               and torch.equal(short_l.distortion, curve_hand)
               and torch.equal(short_l.w_shared, w_hand))
    print(f"lossy sparse delta --compress-frac {LOSSY_FRAC} (k={k_l}), "
          f"{LOSSY_POINTS} points/worker: C first {float(curve_l[0]):.6f} "
          f"last {float(curve_l[-1]):.6f} (dense at the same depth "
          f"{float(res_ld.distortion[-1]):.6f}), wall {wall_l:.2f} s, "
          f"launches {counts_l}; first {CHECK_WINDOWS} windows == the loop written out "
          f"(window kernel, payload + residual, plain selection, sum): "
          f"{hand_ok}")
    if not hand_ok:
        fail("lossy sparse delta differs from the loop written out")

    # eq. 9 over the sparse transport, on the dense run's round lengths
    n_t = SPARSE_TICKS
    vq_fused.launches = vq_fused.launches_topk = vq_assign.launches = 0
    sparse_async = get_executor(
        "mesh", network=GeometricDelayNetwork(P_DELAY),
        transport=comm.get_transport("sparse", frac=SPARSE_FRAC), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_sa = sparse_async.run("async_delta", w0, data[:, :n_t], eval_data,
                              tau=TAU, lengths=lengths[:, : n_t // TAU + 2])
    curve_sa = res_sa.distortion.cpu()
    wall_sa = time.perf_counter() - t0
    counts_sa = {"window": vq_fused.launches, "topk": vq_fused.launches_topk,
                 "delta": vq_assign.launches}
    merge_sa = sparse_async.last_comm["by_tag"]["merge"]
    head_ok = torch.equal(res_sa.distortion, res_a.distortion[: n_t // 10])
    print(f"eq. 9 --transport sparse --compress-frac {SPARSE_FRAC}, {n_t} "
          f"ticks: C last {float(curve_sa[-1]):.6f}, wall {wall_sa:.2f} s "
          f"({wall_sa / (M * n_t) * 1e6:.3f} us/point; dense eq. 9 "
          f"{wall_a / (M * N_PER) * 1e6:.3f}), launches {counts_sa}, merge "
          f"wire {merge_sa['wire_bytes']:,} B; curve == dense eq.-9 head "
          f"{head_ok}")
    if counts_sa != {"window": 0, "topk": n_t, "delta": n_t}:
        fail(f"sparse eq. 9: launches {counts_sa}")
    if merge_sa["wire_bytes"] != n_t * (M - 1) * k_main * 8:
        fail(f"sparse eq. 9: merge wire {merge_sa['wire_bytes']:,} B")
    if not head_ok:
        fail("sparse eq. 9 at k >= the in-flight entries differs from the "
             "dense run's head")

    # -- 11. the blocked kernel: vs the delta kernel, vs plain ----------------
    gen_b = torch.Generator(device=dev).manual_seed(SEED + 6)
    z1 = data[:, :1].contiguous()
    for z, label in ((z1, "batch 1"), (eval_data, f"batch {N_EVAL}")):
        same = [same_bits(a, b) for a, b in zip(
            vq_fused.vq_delta_blocked(z, wb), vq_assign.vq_delta(z, wb))]
        print(f"check blocked == delta kernel, {label} (M={M}, kappa={KAPPA}"
              f", d={D}), bitwise (counts, zsum, mind, assign): {same}")
        if not all(same):
            fail(f"blocked kernel differs from the delta kernel, {label}")
    resid_b = 0.01 * torch.randn((M, KAPPA, D), generator=gen_b, device=dev)
    for z, label in ((z1, "batch 1"), (eval_data, f"batch {N_EVAL}")):
        same = [same_bits(a, b) for a, b in zip(
            ops.vq_delta_topk(z, wb, resid_b, frac=SPARSE_FRAC),
            ops.vq_delta_topk(z, wb, resid_b, frac=SPARSE_FRAC,
                              budget_bytes=FORCE_BUDGET))]
        print(f"check ops.vq_delta_topk blocked branch == full-kernel branch, "
              f"{label}, d={D}, bitwise (vals, idx, residual): {same}")
        if not all(same):
            fail(f"vq_delta_topk's blocked branch differs, {label}")

    if ops.delta_fits(WIDE_D) or not ops.window_fits(KAPPA, WIDE_D):
        fail(f"d={WIDE_D}: expected the blocked route and the window kernel")
    ww = (w0w + 0.01 * torch.randn((M, KAPPA, WIDE_D), generator=gen_b,
                                   device=dev)).contiguous()
    resid_w = 0.01 * torch.randn((M, KAPPA, WIDE_D), generator=gen_b,
                                 device=dev)
    z1w = dataw[:, :1].contiguous()
    blocked_err = 0.0
    for z, label in ((z1w, f"({M}, 1) x {KAPPA} x {WIDE_D}"),
                     (evalw, f"({M}, {N_EVAL}) x {KAPPA} x {WIDE_D}")):
        blocked_err = max(blocked_err, check_blocked(z, ww, label, resid_w))
    zr, wr, rr = (torch.rand(shape, generator=gen_b, device=dev)
                  for shape in ((3, 37, 3000), (3, 1001, 3000),
                                (3, 1001, 3000)))
    check_blocked(zr, wr, "ragged (M=3, kappa=1001, d=3000, B=37)", rr)
    zr, wr = (torch.rand(shape, generator=gen_b, device=dev)
              for shape in ((2, 13, 8000), (2, 300, 8000)))
    check_blocked(zr, wr, "points read in place (M=2, kappa=300, d=8000, "
                  "B=13)")
    # the epilogue at B <= 8 on +0 and -0 residual entries (and w's own
    # signs), at the tick's width and past the sweep's staging limit
    resid_pm = resid_w.clone()
    resid_pm[..., 0::3] = 0.0
    resid_pm[..., 1::3] = -0.0
    for b in (1, 8):
        check_blocked(dataw[:, :b].contiguous(), ww,
                      f"({M}, {b}) x {KAPPA} x {WIDE_D}, residual with +-0 "
                      f"entries", resid_pm)
    for b in (1, 9):
        zr, wr, rr = (torch.randn(shape, generator=gen_b, device=dev)
                      for shape in ((2, b, 8000), (2, 300, 8000),
                                    (2, 300, 8000)))
        rr[..., 0::3] = 0.0
        rr[..., 1::3] = -0.0
        check_blocked(zr, wr, f"(M=2, kappa=300, d=8000, B={b}), residual "
                      f"with +-0 entries", rr)
    del resid_pm
    z8w = dataw[:, :8].contiguous()
    for fn, label in (
            (lambda: vq_fused.vq_delta_blocked(z1w, ww), f"({M}, 1)"),
            (lambda: vq_fused.vq_delta_blocked(z1w, ww, residual=resid_w),
             f"({M}, 1) with the epilogue"),
            (lambda: vq_fused.vq_delta_blocked(z8w, ww, residual=resid_w),
             f"({M}, 8) with the epilogue"),
            (lambda: vq_fused.vq_delta_blocked(z1, wb), f"({M}, 1), d={D}")):
        one_launch(fn, f"blocked {label}")
    print(f"check blocked launches at B <= 8: one CUDA kernel a call at "
          f"({M}, 1) and ({M}, 8) x {KAPPA} x {WIDE_D}, with and without the "
          f"epilogue, and at ({M}, 1) x {KAPPA} x {D}")

    # -- 12. eq. 9 at d=128 through the blocked route -------------------------
    n_b = BLOCKED_TICKS
    zero_counts()
    forced = MeshExecutor(GeometricDelayNetwork(P_DELAY),
                          smem_budget_bytes=FORCE_BUDGET, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f = forced.run("async_delta", w0, data[:, :n_b], eval_data, tau=TAU,
                       lengths=lengths[:, : n_b // TAU + 2])
    curve_f = res_f.distortion.cpu()
    wall_f = time.perf_counter() - t0
    counts_f = launch_counts()
    head_ok = torch.equal(res_f.distortion, res_a.distortion[: n_b // 10])
    print(f"eq. 9 at d={D} through the blocked route (smem budget "
          f"{FORCE_BUDGET} B), {n_b} ticks: C last {float(curve_f[-1]):.6f}, "
          f"wall {wall_f:.2f} s, launches {counts_f}; curve == dense eq.-9 "
          f"head {head_ok}")
    if counts_f != {"window": 0, "delta": 0, "assign": 0, "blocked": n_b,
                    "topk": 0, "ring": 0}:
        fail(f"eq. 9 through the blocked route: launches {counts_f}")
    if not head_ok:
        fail("eq. 9 through the blocked route differs from the dense run")

    # -- 13. eq. 9 and the sync scheme on a 3072-wide codebook ----------------
    zero_counts()
    res_w, _, wall_w = train.run_vq(train.parse_args(wide_async))
    counts_w = launch_counts()
    curve_w = res_w.distortion.cpu()
    print(f"main path --scheme async_delta --dim {WIDE_D} --kappa {KAPPA}, "
          f"{WIDE_POINTS} ticks: C first {float(curve_w[0]):.6f} last "
          f"{float(curve_w[-1]):.6f}, wall {wall_w:.2f} s "
          f"({wall_w / WIDE_POINTS * 1e3:.3f} ms/tick), launches {counts_w}")
    if counts_w != {"window": 0, "delta": 0, "assign": 0,
                    "blocked": WIDE_POINTS, "topk": 0, "ring": 0}:
        fail(f"eq. 9 at d={WIDE_D}: launches {counts_w}, expected one "
             f"blocked launch per tick and nothing else")
    if (len(curve_w) != WIDE_POINTS // 10
            or res_w.w_shared.shape != (KAPPA, WIDE_D)
            or not bool(torch.isfinite(curve_w).all())
            or not bool(torch.isfinite(res_w.w_shared).all())):
        fail(f"eq. 9 at d={WIDE_D}: result of the wrong shape or not finite")
    if not float(curve_w[-1]) < float(curve_w[0]):
        fail(f"eq. 9 at d={WIDE_D}: distortion did not go down")
    n_c = ASYNC_CHECK_TICKS
    lengths_w = GeometricDelayNetwork(P_DELAY).round_lengths(
        torch.Generator().manual_seed(SEED), M, WIDE_POINTS // TAU + 2, TAU)
    lengths_wc = lengths_w[:, : n_c // TAU + 2]
    oracle_w = async_vq.scheme_async(w0w, dataw[:, :n_c], evalw, tau=TAU,
                                     lengths=lengths_wc)
    short_w = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev).run(
        "async_delta", w0w, dataw[:, :n_c], evalw, tau=TAU,
        lengths=lengths_wc)
    zero_counts()
    unfused_w = MeshExecutor(GeometricDelayNetwork(P_DELAY), fused=False,
                             device=dev).run(
        "async_delta", w0w, dataw[:, :n_c], evalw, tau=TAU,
        lengths=lengths_wc)
    counts_u = launch_counts()
    head_w = res_w.distortion[: n_c // 10]
    held_to(f"eq. 9 at d={WIDE_D}, first {n_c} ticks vs scheme_async",
            head_w, oracle_w.distortion, short_w.w_shared, oracle_w.w_shared)
    ticks_ok = torch.equal(short_w.wall_ticks, oracle_w.wall_ticks)
    head_ok = torch.equal(short_w.distortion, head_w)
    via_ok = (torch.equal(unfused_w.distortion, short_w.distortion)
              and same_bits(unfused_w.w_shared, short_w.w_shared))
    print(f"check eq. 9 at d={WIDE_D}, first {n_c} ticks: ticks equal "
          f"{ticks_ok}, short run == main run's head {head_ok}; fused=False "
          f"(assign kernel + index_add_, launches {counts_u}) == blocked "
          f"route bitwise {via_ok}")
    if not (ticks_ok and head_ok):
        fail(f"eq. 9 at d={WIDE_D}: first ticks disagree with the oracle")
    if counts_u["assign"] != n_c or counts_u["blocked"] or not via_ok:
        fail(f"eq. 9 at d={WIDE_D}, fused=False: launches {counts_u}, equal "
             f"to the blocked route {via_ok}")

    wide_sync = wide + ["--scheme", "delta", "--network", "instant"]
    n_wwin = WIDE_POINTS // TAU
    zero_counts()
    res_ws, _, wall_ws = train.run_vq(train.parse_args(wide_sync))
    counts_ws = launch_counts()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_wf = MeshExecutor(InstantNetwork(), smem_budget_bytes=FORCE_BUDGET,
                          device=dev).run("delta", w0w, dataw, evalw, tau=TAU)
    curve_wf = res_wf.distortion.cpu()
    wall_wf = time.perf_counter() - t0
    counts_wf = launch_counts()
    eps_w = vq.default_steps(torch.arange(1, n_wwin * TAU + 1, device=dev))
    w_srd, win_same = w0w, 0
    for i in range(n_wwin):
        span = slice(i * TAU, (i + 1) * TAU)
        zwin = dataw[:, span].contiguous()
        wk = vq_fused.vq_window(zwin, w_srd, eps_w[span])
        w = w_srd.expand(M, KAPPA, WIDE_D).contiguous()
        for s in range(TAU):
            cs, zs = ops.vq_delta_routed(zwin[:, s].unsqueeze(1).contiguous(),
                                         w, budget_bytes=FORCE_BUDGET)
            w = w - eps_w[span][s] * (cs.unsqueeze(-1) * w - zs)
        if not same_bits(w, wk):
            fail(f"d={WIDE_D} window {i}: the window kernel differs from the "
                 f"per-step loop through the blocked kernel, max |diff| "
                 f"{float((w - wk).abs().max()):.3e}")
        win_same += 1
        w_srd = w_srd - torch.sum(w_srd - wk, dim=0)   # eq. 8
    sync_same = (torch.equal(res_wf.distortion, res_ws.distortion)
                 and same_bits(res_wf.w_shared, res_ws.w_shared))
    curve_ws = res_ws.distortion.cpu()
    print(f"main path --scheme delta --dim {WIDE_D}, {WIDE_POINTS} "
          f"points/worker: C first {float(curve_ws[0]):.6f} last "
          f"{float(curve_ws[-1]):.6f}, wall {wall_ws:.2f} s, launches "
          f"{counts_ws}; per-step through the blocked kernel (smem budget "
          f"{FORCE_BUDGET} B): wall {wall_wf:.2f} s, launches {counts_wf}, "
          f"curve and codebook == window route bitwise {sync_same}; window "
          f"kernel == per-step blocked loop, bitwise, {win_same} of {n_wwin} "
          f"windows")
    if (counts_ws["window"] != n_wwin or counts_ws["blocked"]
            or counts_ws["delta"]):
        fail(f"sync delta at d={WIDE_D}: launches {counts_ws}")
    if counts_wf["blocked"] != WIDE_POINTS or counts_wf["window"]:
        fail(f"sync delta at d={WIDE_D} through the blocked route: launches "
             f"{counts_wf}")
    if not sync_same:
        fail(f"sync delta at d={WIDE_D}: the blocked per-step route differs "
             f"from the window route")
    if not float(curve_ws[-1]) < float(curve_ws[0]):
        fail(f"sync delta at d={WIDE_D}: distortion did not go down")

    # -- 14. the tile tuner ---------------------------------------------------
    legacy = autotune.legacy_tiles()
    model_pick = autotune.pick_tiles(1, KAPPA, WIDE_D, m=M, device=dev,
                                     kind="delta_blocked")
    autotune.reset("search")
    t0 = time.perf_counter()
    tuned = autotune.pick_tiles(1, KAPPA, WIDE_D, m=M, device=dev,
                                kind="delta_blocked")
    t_search = time.perf_counter() - t0
    autotune.reset("cache")
    for z in (z1w, evalw):
        same = [same_bits(a, b) for a, b in zip(
            vq_fused.vq_delta_blocked(z, ww, residual=resid_w,
                                      kchunk=tuned.kchunk, bk=tuned.bk),
            vq_fused.vq_delta_blocked(z, ww, residual=resid_w,
                                      kchunk=legacy.kchunk, bk=legacy.bk))]
        if not all(same):
            fail(f"tuned tiles {tuned} change bits against {legacy}: {same}")
    tile_ms = {legacy: [], tuned: [], model_pick: []}
    for cfg in (legacy, tuned, model_pick, model_pick, tuned, legacy):
        tile_ms[cfg].append(time_ms(lambda: vq_fused.vq_delta_blocked(
            z1w, ww, kchunk=cfg.kchunk, bk=cfg.bk), 50))
    print(f"tuner search at ({M}, 1) x {KAPPA} x {WIDE_D}: picked {tuned} in "
          f"{t_search:.2f} s (model's pick {model_pick}, untuned {legacy}); "
          f"tuned == untuned bitwise at batch 1 and {N_EVAL} (counts, zsum, "
          f"mind, assign, delta); ms per launch (order untuned, tuned, model, "
          f"model, tuned, untuned): "
          f"{ {str(k): [round(x, 4) for x in v]
              for k, v in tile_ms.items()} }")

    # -- 15. the ring kernel against its plain version ------------------------
    ring_mask = torch.tensor(RING_MASK, device=dev)
    gen_r = torch.Generator(device=dev).manual_seed(SEED + 7)
    wide_payload = torch.randn((M, KAPPA * WIDE_D), generator=gen_r,
                               device=dev)
    eval_payload = vq.distortion(eval_data, w0).view(M, 1).contiguous()
    for x, label, mask in (
            (payload, "window displacement", None),
            (normal_payload, "N(0, 1)", None),
            (normal_payload, "N(0, 1), 0/1 mask", ring_mask),
            (eval_payload, "eval payload", None),
            (torch.randn((3, 40_040), generator=gen_r, device=dev),
             "ragged", None),
            (torch.randn((5, 1_000_003), generator=gen_r, device=dev),
             "ragged", None),
            (torch.randn((M, KAPPA * D - 3), generator=gen_r, device=dev),
             "chunk a multiple of 4, N not", None),
            (torch.randn((5, 999_996), generator=gen_r, device=dev),
             "float4 route, short last chunk", None),
            (torch.randn((5, 999_996), generator=gen_r, device=dev),
             "float4 route, 0/1 mask", ring_mask[:5].contiguous()),
            (wide_payload, f"d={WIDE_D} payload", None)):
        check_ring(x, label, mask)
    # the top-k kernel past its shared memory: the d=3072 payload at 1%
    k_wide = max(1, int(SPARSE_FRAC * KAPPA * WIDE_D))
    topk_equal(wide_payload, k_wide, f"d={WIDE_D} payload")
    print(f"check top-k vs plain, bitwise, one launch: ({M}, "
          f"{KAPPA * WIDE_D}) d={WIDE_D} payload at k = {k_wide}: equal; "
          f"plan {topk_plan_line(wide_payload)}")

    # -- 16. the ring transport: sync delta, average, eq. 9, int8 wire --------
    n_windows = N_PER // TAU
    ring_wire = comm.ring_wire_bytes(4 * KAPPA * D, M)
    zero_counts()
    res_r, ex_r, wall_r = train.run_vq(train.parse_args(
        full + ["--scheme", "delta", "--transport", "ring"]))
    counts_r = expect_counts("ring delta", window=n_windows,
                             ring=2 * n_windows)
    merge_r = ex_r.last_comm["by_tag"]["merge"]
    res_d, _, wall_d = runs["delta"]
    print(f"main path --scheme delta --transport ring: C first "
          f"{float(res_r.distortion[0]):.6f} last "
          f"{float(res_r.distortion[-1]):.6f}, wall {wall_r:.2f} s "
          f"({wall_r / (M * N_PER) * 1e6:.3f} us/point; dense delta "
          f"{wall_d / (M * N_PER) * 1e6:.3f}), launches {counts_r}, merge "
          f"wire {ring_wire:,} B a window, {merge_r['wire_bytes']:,} B in all")
    if merge_r["wire_bytes"] != n_windows * ring_wire:
        fail(f"ring delta: merge wire {merge_r['wire_bytes']:,} B")
    if (res_r.w_shared.shape != (KAPPA, D)
            or not bool(torch.isfinite(res_r.distortion).all())
            or not float(res_r.distortion[-1]) < float(res_r.distortion[0])):
        fail("ring delta: result of the wrong shape, not finite or not "
             "going down")
    held_to(f"ring delta vs dense delta, all {n_windows} windows",
            res_r.distortion, res_d.distortion, res_r.w_shared,
            res_d.w_shared)
    n_p = RING_PLAIN_WINDOWS
    short = {}
    for name, transport in (
            ("ring", comm.get_transport("ring")),
            ("dense", comm.get_transport("xla")),
            ("plain ring", comm.RingTransport().plain()),
            ("quant[identity:ring]",
             comm.get_transport("quant", inner="ring", mode="identity"))):
        zero_counts()
        short[name] = MeshExecutor(InstantNetwork(), transport=transport,
                                   device=dev).run(
            "delta", w0, data[:, : n_p * TAU], eval_data, tau=TAU)
        expect_counts(f"{name} delta, {n_p} windows", window=n_p,
                      ring=0 if name in ("dense", "plain ring") else 2 * n_p)
    held_to(f"ring delta vs dense delta, first {n_p} windows",
            short["ring"].distortion, short["dense"].distortion,
            short["ring"].w_shared, short["dense"].w_shared)
    for name in ("plain ring", "quant[identity:ring]"):
        same = (same_bits(short[name].distortion, res_r.distortion[:n_p])
                and same_bits(short[name].w_shared, short["ring"].w_shared))
        print(f"check ring delta first {n_p} windows == {name} run, bitwise "
              f"(curve, codebook): {same}")
        if not same:
            fail(f"ring delta differs from the {name} run")

    avg = ["--executor", "mesh", "--workers", str(M), "--points",
           str(RING_AVG_POINTS), "--dim", str(D), "--kappa", str(KAPPA),
           "--tau", str(TAU), "--seed", str(SEED), "--network", "instant",
           "--scheme", "average"]
    n_avg = RING_AVG_POINTS // TAU
    zero_counts()
    res_ra, _, wall_ra = train.run_vq(train.parse_args(
        avg + ["--transport", "ring"]))
    expect_counts("ring average", window=n_avg, ring=2 * n_avg)
    res_da, _, _ = train.run_vq(train.parse_args(avg))
    print(f"--scheme average --transport ring, {RING_AVG_POINTS} "
          f"points/worker: wall {wall_ra:.2f} s, {2 * n_avg} ring launches")
    held_to(f"ring average vs dense average, {n_avg} windows",
            res_ra.distortion, res_da.distortion, res_ra.w_shared,
            res_da.w_shared)

    n_t = SPARSE_TICKS
    zero_counts()
    ring_async = MeshExecutor(GeometricDelayNetwork(P_DELAY),
                              transport="ring", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_rq = ring_async.run("async_delta", w0, data[:, :n_t], eval_data,
                            tau=TAU, lengths=lengths[:, : n_t // TAU + 2])
    curve_rq = res_rq.distortion.cpu()
    wall_rq = time.perf_counter() - t0
    counts_rq = expect_counts("ring eq. 9", delta=n_t, ring=n_t + n_t // 10)
    merge_rq = ring_async.last_comm["by_tag"]["merge"]
    print(f"eq. 9 --transport ring (masked ring every tick), {n_t} ticks: C "
          f"last {float(curve_rq[-1]):.6f}, wall {wall_rq:.2f} s "
          f"({wall_rq / (M * n_t) * 1e6:.3f} us/point; dense eq. 9 "
          f"{wall_a / (M * N_PER) * 1e6:.3f}), launches {counts_rq}, merge "
          f"wire {merge_rq['wire_bytes']:,} B")
    if merge_rq["wire_bytes"] != n_t * ring_wire:
        fail(f"ring eq. 9: merge wire {merge_rq['wire_bytes']:,} B")
    dense_async = MeshExecutor(GeometricDelayNetwork(P_DELAY),
                               device=dev).run(
        "async_delta", w0, data[:, :n_t], eval_data, tau=TAU,
        lengths=lengths[:, : n_t // TAU + 2])
    held_to(f"ring eq. 9 vs dense eq. 9, {n_t} ticks", res_rq.distortion,
            dense_async.distortion, res_rq.w_shared, dense_async.w_shared)
    n_pt = RING_PLAIN_TICKS
    plain_async = MeshExecutor(
        GeometricDelayNetwork(P_DELAY), transport=comm.RingTransport().plain(),
        device=dev).run("async_delta", w0, data[:, :n_pt], eval_data, tau=TAU,
                        lengths=lengths[:, : n_pt // TAU + 2])
    same = same_bits(plain_async.distortion, res_rq.distortion[: n_pt // 10])
    print(f"check ring eq. 9 first {n_pt} ticks == the plain-ring run, "
          f"bitwise: {same}")
    if not same:
        fail("ring eq. 9 differs from the plain-ring run")

    q_args = train.parse_args(lossy_full + ["--transport", "ring",
                                            "--wire-quant", "int8"])
    lw = LOSSY_POINTS // TAU
    zero_counts()
    res_q, ex_q, wall_q = train.run_vq(q_args)
    counts_q = expect_counts("int8 over ring", window=lw, ring=2 * lw)
    merge_q = ex_q.last_comm["by_tag"]["merge"]
    curve_q = res_q.distortion.cpu()
    print(f"--transport ring --wire-quant int8, {LOSSY_POINTS} points/worker:"
          f" C first {float(curve_q[0]):.6f} last {float(curve_q[-1]):.6f} "
          f"(dense at the same depth {float(res_ld.distortion[-1]):.6f}), "
          f"wall {wall_q:.2f} s, launches {counts_q}, merge wire "
          f"{merge_q['wire_bytes'] // lw:,} B a window "
          f"({merge_q['wire_bytes']:,} B in all)")
    # int8: a quarter of the f32 ring's bytes and each worker's f32 scale
    if merge_q["wire_bytes"] != lw * (ring_wire // 4 + 4):
        fail(f"int8 over ring: merge wire {merge_q['wire_bytes']:,} B")
    if not (bool(torch.isfinite(curve_q).all())
            and float(curve_q[-1]) < float(curve_q[0])):
        fail("int8 over ring: curve not finite or not going down")

    comm_layer_legs(dev, w0, data, eval_data, runs, lengths, payload,
                    normal_payload)
    elastic_legs(dev, w0, data, eval_data, runs)
    threads_serving_obs_legs(dev, w0, data, eval_data, runs, geo_run, lengths)

    # -- 20. timing at the main path's shapes ---------------------------------
    # every kernel, plain and library time by kernel_ms (L2 cold, host time
    # hidden); "warm" is time_ms over back-to-back wrapper calls (L2 warm,
    # the wrapper's host time included), a read-out beside it
    zwin = data[:, :TAU].contiguous()
    eps = eps_all[:TAU].contiguous()
    win_ms = kernel_ms(lambda: vq_fused.vq_window(zwin, w0, eps), 200)
    win_warm = time_ms(lambda: vq_fused.vq_window(zwin, w0, eps), 200)
    win_plain = kernel_ms(lambda: vq_fused.vq_window_plain(zwin, w0, eps), 10)
    win_bound = bound(4 * (M * TAU * D + KAPPA * D + TAU + M * KAPPA * D),
                      TAU * M * KAPPA * (2 * D + 3))
    z1 = data[:, :1].contiguous()
    d1_ms = kernel_ms(lambda: vq_assign.vq_delta(z1, wb), 200)
    d1_warm = time_ms(lambda: vq_assign.vq_delta(z1, wb), 200)
    d1_plain = kernel_ms(lambda: vq_assign.vq_delta_plain(z1, wb), 50)

    def delta_bound(b):
        return bound(4 * (M * b * D + M * KAPPA * D + M * KAPPA
                          + M * KAPPA * D + 2 * M * b),
                     M * b * KAPPA * (2 * D + 3) + M * b * D)

    d1_bound = delta_bound(1)
    by_kchunk = {kc: round(kernel_ms(
        lambda: vq_assign.vq_delta(z1, wb, kchunk=kc), 100), 4)
        for kc in autotune.KCHUNK_CANDIDATES}
    kc_pick = autotune.pick_tiles(1, KAPPA, D, m=M, device=dev,
                                  kind="delta").kchunk
    de_ms = kernel_ms(lambda: vq_assign.vq_delta(eval_data, wb), 20)
    de_plain = kernel_ms(lambda: vq_assign.vq_delta_plain(eval_data, wb), 10)
    de_bound = delta_bound(N_EVAL)
    print(f"timing window (M={M}, tau={TAU}, kappa={KAPPA}, d={D}): kernel "
          f"{win_ms:.4f} ms (warm {win_warm:.4f}), plain {win_plain:.4f} ms, "
          f"bound {win_bound[0]:.4f} ms ({win_bound[1]})")
    # the thread runtime's round: one worker, one cluster of 8 blocks
    zround = data[:1, :TAU].contiguous()
    w1_ms = kernel_ms(lambda: vq_fused.vq_window(zround, w0, eps), 200)
    w1_warm = time_ms(lambda: vq_fused.vq_window(zround, w0, eps), 200)
    w1_plain = kernel_ms(lambda: vq_fused.vq_window_plain(zround, w0, eps),
                         10)
    w1_bound = bound(4 * (TAU * D + KAPPA * D + TAU + KAPPA * D),
                     TAU * KAPPA * (2 * D + 3))
    print(f"timing window (M=1, tau={TAU}, kappa={KAPPA}, d={D}, the thread "
          f"runtime's round): kernel {w1_ms:.4f} ms (warm {w1_warm:.4f}), "
          f"plain {w1_plain:.4f} ms, bound {w1_bound[0]:.4f} ms "
          f"({w1_bound[1]})")
    # the divergence kernel (no TPU kernel's counterpart: an observed
    # window's codebook divergence) at the window's shape
    wfin = vq_fused.vq_window(zwin, w0, eps)
    dv_ms = kernel_ms(lambda: vq_fused.vq_divergence(wfin, w0), 200)
    dv_warm = time_ms(lambda: vq_fused.vq_divergence(wfin, w0), 200)
    dv_plain = kernel_ms(lambda: vq_fused.vq_divergence_plain(wfin, w0), 200)
    dv_bound = bound(4 * (M + 1) * KAPPA * D, 3 * M * KAPPA * D)
    print(f"timing divergence (M={M}, kappa={KAPPA}, d={D}): kernel "
          f"{dv_ms:.4f} ms (warm {dv_warm:.4f}), plain {dv_plain:.4f} ms, "
          f"bound {dv_bound[0]:.4f} ms ({dv_bound[1]})")
    print(f"timing delta batch 1: kernel {d1_ms:.4f} ms (warm "
          f"{d1_warm:.4f}), plain {d1_plain:.4f} ms, bound "
          f"{d1_bound[0]:.4f} ms ({d1_bound[1]}); the sweep by kchunk "
          f"{by_kchunk} ms, the tuner's pick {kc_pick}")
    print(f"timing delta batch {N_EVAL}: kernel {de_ms:.4f} ms, plain "
          f"{de_plain:.4f} ms, bound {de_bound[0]:.4f} ms ({de_bound[1]})")
    zf = torch.randn((FLUSH_ROWS, D), device=dev)
    wt = trained.contiguous()
    af_ms = kernel_ms(lambda: vq_assign.vq_assign(zf, wt), 200)
    af_warm = time_ms(lambda: vq_assign.vq_assign(zf, wt), 200)
    af_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(zf, wt), 200)

    def assign_bound(m, b):
        return bound(4 * (m * b * D + m * KAPPA * D + 2 * m * b),
                     m * b * KAPPA * (2 * D + 3) + m * b * D)

    af_bound = assign_bound(1, FLUSH_ROWS)
    ae_ms = kernel_ms(lambda: vq_assign.vq_assign(eval_data, wb), 20)
    ae_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(eval_data, wb), 10)
    ae_bound = assign_bound(M, N_EVAL)
    print(f"timing assign flush ({FLUSH_ROWS} x {KAPPA} x {D}): kernel "
          f"{af_ms:.4f} ms (warm {af_warm:.4f}), plain {af_plain:.4f} ms, "
          f"bound {af_bound[0]:.4f} ms ({af_bound[1]})")
    print(f"timing assign eval (({M}, {N_EVAL}) x {KAPPA} x {D}): kernel "
          f"{ae_ms:.4f} ms, plain {ae_plain:.4f} ms, bound "
          f"{ae_bound[0]:.4f} ms ({ae_bound[1]})")
    # the fused=False leg's shape at d=3072: read the codebooks once
    at_ms = kernel_ms(lambda: vq_assign.vq_assign(z1w, ww), 100)
    at_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(z1w, ww), 20)
    at_bound = bound(4 * (M * WIDE_D + M * KAPPA * WIDE_D + 2 * M),
                     M * KAPPA * (2 * WIDE_D + 3) + M * WIDE_D)
    print(f"timing assign ({M}, 1) x {KAPPA} x {WIDE_D}: kernel "
          f"{at_ms:.4f} ms, plain {at_plain:.4f} ms, bound "
          f"{at_bound[0]:.4f} ms ({at_bound[1]})")
    def blocked_bound(d, epilogue):
        # batch 1: read z, w (and the residual); write counts, zsum, mind,
        # assign (and delta); the distance and the one-point sums (and the
        # epilogue's three operations an element)
        big = M * KAPPA * d
        n_in = M * d + big * (2 if epilogue else 1)
        n_out = M * KAPPA + big * (2 if epilogue else 1) + 2 * M
        flops = M * KAPPA * (2 * d + 3) + M * d + (3 * big if epilogue else 0)
        return bound(4 * (n_in + n_out), flops)

    bl_ms = kernel_ms(lambda: vq_fused.vq_delta_blocked(z1w, ww), 100)
    bl_warm = time_ms(lambda: vq_fused.vq_delta_blocked(z1w, ww), 100)
    bl_plain = kernel_ms(lambda: vq_fused.vq_delta_blocked_plain(z1w, ww), 20)
    bl_bound = blocked_bound(WIDE_D, False)
    be_ms = kernel_ms(lambda: vq_fused.vq_delta_blocked(
        z1w, ww, residual=resid_w), 100)
    be_plain = kernel_ms(lambda: vq_fused.vq_delta_blocked_plain(
        z1w, ww, resid_w), 20)
    be_bound = blocked_bound(WIDE_D, True)
    pair = {"blocked": [], "delta": []}
    for name in ("blocked", "delta", "delta", "blocked"):
        fn = vq_fused.vq_delta_blocked if name == "blocked" else (
            vq_assign.vq_delta)
        pair[name].append(kernel_ms(lambda: fn(z1, wb), 200))
    b128_plain = kernel_ms(lambda: vq_fused.vq_delta_blocked_plain(z1, wb),
                           50)
    b128_bound = blocked_bound(D, False)
    print(f"timing blocked ({M}, 1) x {KAPPA} x {WIDE_D}: kernel {bl_ms:.4f} "
          f"ms (warm {bl_warm:.4f}), plain {bl_plain:.4f} ms, bound "
          f"{bl_bound[0]:.4f} ms ({bl_bound[1]}); with the epilogue: kernel "
          f"{be_ms:.4f} ms, plain {be_plain:.4f} ms, bound {be_bound[0]:.4f} "
          f"ms ({be_bound[1]})")
    print(f"timing blocked ({M}, 1) x {KAPPA} x {D} beside the delta kernel "
          f"(order blocked, delta, delta, blocked): blocked {pair['blocked']}"
          f" ms, delta {pair['delta']} ms, plain {b128_plain:.4f} ms, bound "
          f"{b128_bound[0]:.4f} ms ({b128_bound[1]})")
    print("library_ms: null for the window, delta, assign and blocked "
          "kernels: none of their functions is one PyTorch call (an argmin "
          "fused with a scatter, a loop of dependent steps, and the "
          "squared-distance argmin with its min: torch.cdist returns "
          "distances, not the argmin and min)")
    # top-k and ring: the kernel and its library call in turns (kernel,
    # library, library, kernel)
    topk_t = {}
    n_flat = KAPPA * D
    for k in (k_main, k_l):
        warm = time_ms(lambda: vq_fused.vq_topk(payload, k), 100)
        tk, tl = in_turns(lambda: vq_fused.vq_topk(payload, k),
                          lambda: torch.topk(payload.abs(), k, dim=1), 50)
        tp = kernel_ms(lambda: vq_fused.vq_topk_plain(payload, k), 5)
        tb = bound(4 * 2 * M * n_flat + 8 * M * k, M * n_flat)
        tn = kernel_ms(lambda: vq_fused.vq_topk(normal_payload, k), 50)
        topk_t[k] = (mean(tk), tp, mean(tl), tb)
        print(f"timing top-k ({M}, {n_flat}), k={k}, window displacement: "
              f"kernel {r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in turns; "
              f"selection only: no signed values, no residual), plain "
              f"{tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]}); kernel on N(0, "
              f"1) entries {tn:.4f} ms; warm {warm:.4f} ms")
    n_wide = KAPPA * WIDE_D
    warm = time_ms(lambda: vq_fused.vq_topk(wide_payload, k_wide), 20)
    tk, tl = in_turns(lambda: vq_fused.vq_topk(wide_payload, k_wide),
                      lambda: torch.topk(wide_payload.abs(), k_wide, dim=1),
                      10)
    tp = kernel_ms(lambda: vq_fused.vq_topk_plain(wide_payload, k_wide), 2)
    tb = bound(4 * 2 * M * n_wide + 8 * M * k_wide, M * n_wide)
    print(f"timing top-k ({M}, {n_wide}), k={k_wide}, d={WIDE_D} payload "
          f"(N(0, 1)): kernel {r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in "
          f"turns), plain {tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]}); warm "
          f"{warm:.4f} ms")
    ring_t = {}
    for x, iters in ((normal_payload, 200), (wide_payload, 20)):
        re_ = time_ms(lambda: ring.ring_all_reduce(x), iters)
        le = time_ms(lambda: torch.sum(x, dim=0), iters)
        rk, rl = in_turns(lambda: ring.ring_all_reduce(x),
                          lambda: torch.sum(x, dim=0), iters)
        rp = kernel_ms(lambda: ring.ring_all_reduce_plain(x),
                       max(3, iters // 20))
        # read x once, write one row; (M - 1) additions an entry
        rb = bound(4 * (M + 1) * x.shape[1], (M - 1) * x.shape[1])
        ring_t[x.shape[1]] = (mean(rk), rp, mean(rl), rb)
        print(f"timing ring {tuple(x.shape)}: kernel {r4(rk)} ms, "
              f"torch.sum(x, dim=0) {r4(rl)} ms (in turns; another order), "
              f"plain {rp:.4f} ms, bound {rb[0]:.4f} ms ({rb[1]}); warm: "
              f"kernel {re_:.4f} ms, torch.sum {le:.4f} ms")
    sync_ex = MeshExecutor(InstantNetwork(), device=dev)
    ring_ex = MeshExecutor(InstantNetwork(), transport="ring", device=dev)
    turns = {sync_ex: [], ring_ex: []}
    for ex in (sync_ex, ring_ex, ring_ex, sync_ex):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU], eval_data,
               tau=TAU).distortion.cpu()
        turns[ex].append((time.perf_counter() - t0) / PROFILE_WINDOWS * 1e6)
    print(f"sync delta, {PROFILE_WINDOWS} windows in turns (dense, ring, "
          f"ring, dense), us a window on the host clock: dense "
          f"{[round(t, 1) for t in turns[sync_ex]]}, ring "
          f"{[round(t, 1) for t in turns[ring_ex]]}")
    profile("--scheme delta, fused",
            lambda: sync_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                                eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    from repro_torch.obs import MetricsRegistry, Tracer
    obs_ex = MeshExecutor(InstantNetwork(), tracer=Tracer(),
                          metrics=MetricsRegistry(), device=dev)
    profile("--scheme delta, fused, observed",
            lambda: obs_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                               eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    async_ex = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev)
    profile("--scheme async_delta",
            lambda: async_ex.run("async_delta", w0,
                                 data[:, :PROFILE_TICKS], eval_data, tau=TAU),
            PROFILE_TICKS, "tick")
    sparse_ex = MeshExecutor(
        InstantNetwork(), transport=comm.get_transport("sparse",
                                                       frac=SPARSE_FRAC),
        device=dev)
    profile(f"--scheme delta --transport sparse --compress-frac {SPARSE_FRAC}",
            lambda: sparse_ex.run("delta", w0,
                                  data[:, : PROFILE_WINDOWS * TAU],
                                  eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    profile("--scheme delta --transport ring",
            lambda: ring_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                                eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    profile(f"--scheme async_delta --dim {WIDE_D}",
            lambda: async_ex.run("async_delta", w0w,
                                 dataw[:, :ASYNC_CHECK_TICKS], evalw,
                                 tau=TAU),
            ASYNC_CHECK_TICKS, "tick")

    kernels = [
        {"name": "vq_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_window.cu",
         "replaces": "src/repro/kernels/vq_fused.py:232",
         "launches": runs["delta"][1]["window"], "max_abs_err": win_err,
         "ms": win_ms, "plain_ms": win_plain, "bound_ms": win_bound[0],
         "bound_by": win_bound[1], "library_ms": None},
        {"name": "vq_delta", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_delta.cu",
         "replaces": "src/repro/kernels/vq_assign.py:108",
         "launches": counts_a["delta"], "max_abs_err": mind_err,
         "ms": d1_ms, "plain_ms": d1_plain, "bound_ms": d1_bound[0],
         "bound_by": d1_bound[1], "library_ms": None},
        {"name": "vq_assign", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_delta.cu",
         "replaces": "src/repro/kernels/vq_assign.py:33",
         "launches": serve_launches, "max_abs_err": assign_err,
         "ms": af_ms, "plain_ms": af_plain, "bound_ms": af_bound[0],
         "bound_by": af_bound[1], "library_ms": None},
        {"name": "vq_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_topk.cu",
         "replaces": "src/repro/kernels/vq_fused.py:191",
         "launches": counts_s["topk"], "max_abs_err": 0.0,
         "ms": topk_t[k_main][0], "plain_ms": topk_t[k_main][1],
         "bound_ms": topk_t[k_main][3][0], "bound_by": topk_t[k_main][3][1],
         "library_ms": topk_t[k_main][2]},
        {"name": "vq_delta_blocked", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_blocked.cu",
         "replaces": "src/repro/kernels/vq_fused.py:46",
         "launches": counts_w["blocked"], "max_abs_err": blocked_err,
         "ms": bl_ms, "plain_ms": bl_plain, "bound_ms": bl_bound[0],
         "bound_by": bl_bound[1], "library_ms": None},
        {"name": "vq_ring", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_ring.cu",
         "replaces": "src/repro/comm/ring.py:40",
         "launches": counts_r["ring"], "max_abs_err": 0.0,
         "ms": ring_t[KAPPA * D][0], "plain_ms": ring_t[KAPPA * D][1],
         "bound_ms": ring_t[KAPPA * D][3][0],
         "bound_by": ring_t[KAPPA * D][3][1],
         "library_ms": ring_t[KAPPA * D][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        # the run still fails; its traceback goes where the result would
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        sys.exit(1)
