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
     the per-step path through the delta kernel, window by window;
  4. holds the assign kernel against its plain version at the serving
     flush shape (128 x 4096 x 128), the eval shape ((8, 1000) x 4096 x
     128) and the ragged shape, and against the delta kernel's
     (assign, min distance), which it must equal bit for bit;
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
     bit (vals, idx, residual), at (8, 524,288) with k = 5,242, 524, 1 and
     524,288, at a ragged (3, 40,040) with k = 37, and on a tie-heavy input
     (mostly zeros of both signs, repeated magnitudes of both signs) with k
     cutting through a tie;
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
  11. times each kernel, its plain version, its bound and, for the top-k
     kernel, ``torch.topk`` (selection only), and traces 200 windows of the
     sync delta path, 1,000 ticks of the eq.-9 path and 200 windows of the
     sparse eq.-8 path with torch.profiler (device time by kernel, the
     device's idle share);
  12. prints one ``{"kernels": [...]}`` line, the card line again, and last
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

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores (both kernels run on the f32 pipes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Tolerances.  cuBLAS accumulates z @ w^T in another order than the
# kernels, so a near-tie can flip an assignment: a flip is accepted when the
# exact (f64) distances of the two rows differ by at most FLIP_REL times
# ||z||^2 + ||w||^2, the magnitude that cancels in the expanded distance
# (16 f32 ulps of it).  Min distances carry the same rounding.
FLIP_REL = 2e-6
# zsum at batch 1000 is a sum of a few points taken in another order
ZSUM_RTOL, ZSUM_ATOL = 1e-5, 1e-5
# A flip moves one row on one side only; the oracle's first windows agree to
# CURVE_RTOL on the curve and in all but ROWS_FRAC of the codebook rows.
CURVE_RTOL, ROW_ATOL, ROWS_FRAC = 1e-3, 1e-4, 0.01


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


def topk_equal(full, k: int, label: str) -> None:
    """The top-k kernel against its plain version, bit for bit."""
    import torch

    from repro_torch.kernels import vq_fused
    got = vq_fused.vq_topk(full, k)
    want = vq_fused.vq_topk_plain(full, k)
    same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got, want)]
    if not all(same):
        fail(f"top-k {label}, k={k}: kernel differs from the plain version "
             f"(vals, idx, residual bitwise equal: {same})")


def check_topk(dev, payload, normal, ks) -> None:
    """The top-k kernel against its plain version at the main path's shape
    (a window's displacement and N(0, 1) entries) at each of ``ks``, ragged
    and tie-heavy."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = KAPPA * D
    for full, label in ((payload, "window displacement"),
                        (normal, "N(0, 1)")):
        for k in ks:
            topk_equal(full, k, f"({M}, {n}) {label}")
    ragged = torch.randn((3, 40_040), generator=gen, device=dev)
    topk_equal(ragged, 37, "ragged (3, 40040)")
    ties, tie_ks = tie_heavy(dev, 4, 100_003)
    for k in tie_ks:
        topk_equal(ties, k, "tie-heavy (4, 100003)")
    print(f"check top-k vs plain, bitwise (vals, idx, residual): ({M}, {n}) "
          f"window displacement ({int((payload != 0).sum())} non-zero) and "
          f"N(0, 1) at k = {ks}; ragged (3, 40040) at k = 37; "
          f"tie-heavy (4, 100003) at k = {tie_ks}: all equal")


def check_assign(z, w, label: str) -> tuple[int, float]:
    """The assign kernel against its plain version (flips only at
    near-ties, min distances within FLIP_REL of the cancelled magnitude)
    and against the delta kernel's (assign, mind), bit for bit.  Returns
    (flips, max |mind diff| off flipped rows)."""
    import torch

    from repro_torch.kernels import vq_assign

    ak, mk = vq_assign.vq_assign(z, w)
    ap, mp = vq_assign.vq_assign_plain(z, w)
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
    print(f"check assign {label} vs plain: {len(flips)} flips of "
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


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import comm
    from repro_torch.core import async_vq, schemes, vq
    from repro_torch.engine import get_executor
    from repro_torch.engine import merge as merge_lib
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import _build, ops, vq_assign, vq_fused
    from repro_torch.launch import serve, train

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

    # -- 5+6. the main path, and its first windows against the oracles -------
    runs = {}
    for scheme in ("delta", "average"):
        vq_fused.launches = vq_assign.launches = 0
        res, executor, wall = train.run_vq(
            train.parse_args(full + ["--scheme", scheme]))
        counts = {"window": vq_fused.launches, "delta": vq_assign.launches}
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
        main_curve = runs[scheme][0].distortion[:CHECK_WINDOWS]
        c_err = float(((main_curve - oracle.distortion).abs()
                       / oracle.distortion.abs()).max())
        rows = int(((short.w_shared - oracle.w_shared).abs() > ROW_ATOL)
                   .any(dim=1).sum())
        print(f"check {scheme} first {CHECK_WINDOWS} windows vs "
              f"scheme_{scheme}: max rel curve diff {c_err:.3e} (rtol "
              f"{CURVE_RTOL}), codebook rows off by > {ROW_ATOL}: {rows} of "
              f"{KAPPA}, ticks equal "
              f"{torch.equal(short.wall_ticks, oracle.wall_ticks)}")
        if (c_err > CURVE_RTOL or rows > ROWS_FRAC * KAPPA
                or not torch.equal(short.wall_ticks, oracle.wall_ticks)):
            fail(f"{scheme}: first windows disagree with the oracle")

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
          f"is four CUDA kernel launches)")
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
    _, serve_launches = serve_leg(serve, trained, geometric,
                                  "geometric arrivals")
    serve_leg(serve, trained, ["--network", "instant", "--tick-ms", "0"],
              "saturating")
    freeze_ab(serve, trained, geometric)

    # -- 8. eq. 9 at full width ------------------------------------------------
    vq_fused.launches = vq_assign.launches = 0
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
    if counts_a["delta"] != N_PER or counts_a["window"]:
        fail(f"async_delta: launches {counts_a}, expected {N_PER} delta "
             f"and no window launch")
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
    c_err = float(((head_a - oracle_a.distortion).abs()
                   / oracle_a.distortion.abs()).max())
    rows = int(((short_a.w_shared - oracle_a.w_shared).abs() > ROW_ATOL)
               .any(dim=1).sum())
    print(f"check async_delta first {n_c} ticks vs scheme_async: max rel "
          f"curve diff {c_err:.3e} (rtol {CURVE_RTOL}), codebook rows off by "
          f"> {ROW_ATOL}: {rows} of {KAPPA}, ticks equal "
          f"{torch.equal(short_a.wall_ticks, oracle_a.wall_ticks)}, short "
          f"run's curve == main run's head {torch.equal(short_a.distortion, head_a)}")
    if (c_err > CURVE_RTOL or rows > ROWS_FRAC * KAPPA
            or not torch.equal(short_a.wall_ticks, oracle_a.wall_ticks)
            or not torch.equal(short_a.distortion, head_a)):
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

    # -- 11. timing at the main path's shapes ---------------------------------
    zwin = data[:, :TAU].contiguous()
    eps = eps_all[:TAU].contiguous()
    win_ms = time_ms(lambda: vq_fused.vq_window(zwin, w0, eps), 200)
    win_plain = time_ms(lambda: vq_fused.vq_window_plain(zwin, w0, eps), 10)
    win_bound = bound(4 * (M * TAU * D + KAPPA * D + TAU + M * KAPPA * D),
                      TAU * M * KAPPA * (2 * D + 3))
    z1 = data[:, :1].contiguous()
    d1_ms = time_ms(lambda: vq_assign.vq_delta(z1, wb), 200)
    d1_plain = time_ms(lambda: vq_assign.vq_delta_plain(z1, wb), 50)

    def delta_bound(b):
        return bound(4 * (M * b * D + M * KAPPA * D + M * KAPPA
                          + M * KAPPA * D + 2 * M * b),
                     M * b * KAPPA * (2 * D + 3) + M * b * D)

    d1_bound = delta_bound(1)
    de_ms = time_ms(lambda: vq_assign.vq_delta(eval_data, wb), 20)
    de_plain = time_ms(lambda: vq_assign.vq_delta_plain(eval_data, wb), 10)
    de_bound = delta_bound(N_EVAL)
    print(f"timing window (M={M}, tau={TAU}, kappa={KAPPA}, d={D}): kernel "
          f"{win_ms:.4f} ms, plain {win_plain:.4f} ms, bound "
          f"{win_bound[0]:.4f} ms ({win_bound[1]})")
    print(f"timing delta batch 1: kernel {d1_ms:.4f} ms, plain "
          f"{d1_plain:.4f} ms, bound {d1_bound[0]:.4f} ms ({d1_bound[1]})")
    print(f"timing delta batch {N_EVAL}: kernel {de_ms:.4f} ms, plain "
          f"{de_plain:.4f} ms, bound {de_bound[0]:.4f} ms ({de_bound[1]})")
    zf = torch.randn((FLUSH_ROWS, D), device=dev)
    wt = trained.contiguous()
    af_ms = time_ms(lambda: vq_assign.vq_assign(zf, wt), 200)
    af_plain = time_ms(lambda: vq_assign.vq_assign_plain(zf, wt), 200)

    def assign_bound(m, b):
        return bound(4 * (m * b * D + m * KAPPA * D + 2 * m * b),
                     m * b * KAPPA * (2 * D + 3) + m * b * D)

    af_bound = assign_bound(1, FLUSH_ROWS)
    ae_ms = time_ms(lambda: vq_assign.vq_assign(eval_data, wb), 20)
    ae_plain = time_ms(lambda: vq_assign.vq_assign_plain(eval_data, wb), 10)
    ae_bound = assign_bound(M, N_EVAL)
    print(f"timing assign flush ({FLUSH_ROWS} x {KAPPA} x {D}): kernel "
          f"{af_ms:.4f} ms, plain {af_plain:.4f} ms, bound "
          f"{af_bound[0]:.4f} ms ({af_bound[1]})")
    print(f"timing assign eval (({M}, {N_EVAL}) x {KAPPA} x {D}): kernel "
          f"{ae_ms:.4f} ms, plain {ae_plain:.4f} ms, bound "
          f"{ae_bound[0]:.4f} ms ({ae_bound[1]})")
    print("library_ms: null for the window, delta and assign kernels: none "
          "of their functions is one PyTorch call (an argmin fused with a "
          "scatter, a loop of dependent steps, and the squared-distance "
          "argmin with its min: torch.cdist returns distances, not the argmin "
          "and min)")
    topk_t = {}
    n_flat = KAPPA * D
    for k in (k_main, k_l):
        tk = time_ms(lambda: vq_fused.vq_topk(payload, k), 100)
        tp = time_ms(lambda: vq_fused.vq_topk_plain(payload, k), 10)
        tl = time_ms(lambda: torch.topk(payload.abs(), k, dim=1), 100)
        tb = bound(4 * 2 * M * n_flat + 8 * M * k, M * n_flat)
        tn = time_ms(lambda: vq_fused.vq_topk(normal_payload, k), 100)
        topk_t[k] = (tk, tp, tl, tb)
        print(f"timing top-k ({M}, {n_flat}), k={k}, window displacement: "
              f"kernel {tk:.4f} ms, plain {tp:.4f} ms, bound {tb[0]:.4f} ms "
              f"({tb[1]}), torch.topk(|x|) {tl:.4f} ms (selection only: no "
              f"signed values, no residual); kernel on N(0, 1) entries "
              f"{tn:.4f} ms")
    sync_ex = MeshExecutor(InstantNetwork(), device=dev)
    profile("--scheme delta, fused",
            lambda: sync_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
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
