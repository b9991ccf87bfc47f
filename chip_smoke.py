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
  4. drives the main path, ``repro_torch.launch.train --mode vq --executor
     mesh``, on 8 x 125,000 points for ``--scheme delta`` and then
     ``--scheme average``, and the per-step (``fused=False``) route on the
     first 2,000 points of each worker, with every kernel's launch count
     set to 0 before each run and read after it;
  5. compares each run's first 20 windows with the port's own oracles
     (``core.schemes.scheme_delta`` / ``scheme_average``) on the card;
  6. times each kernel, its plain version and its bound, and traces 200
     windows of the main path with torch.profiler (device time by kernel,
     the device's idle share);
  7. prints one ``{"kernels": [...]}`` line, the card line again, and last
     ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failed check exits non-zero before the result lines.  It needs no
network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the slice's width: a SIFT1M-shaped deployment (see PERF.md)
M, N_PER, D, KAPPA, TAU, N_EVAL, SEED = 8, 125_000, 128, 4096, 10, 1000, 0
CHECK_WINDOWS = 20      # windows held against the plain version / oracle
UNFUSED_POINTS = 2000   # depth of the per-step (fused=False) leg
PROFILE_WINDOWS = 200   # windows traced by torch.profiler

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


def profile_windows(executor, w0, data, eval_data) -> None:
    """Where a window's time goes on the fused delta path: device time per
    kernel name from ``torch.profiler`` over PROFILE_WINDOWS windows, the
    device's busy and idle share of the profiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    head = data[:, : PROFILE_WINDOWS * TAU]
    executor.run("delta", w0, head[:, : 5 * TAU], eval_data, tau=TAU)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        executor.run("delta", w0, head, eval_data, tau=TAU)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy = sum(by_name.values())
    if busy == 0.0:
        print("profile: the profiler saw no device time (not measured)")
        return
    per = 1.0 / PROFILE_WINDOWS
    print(f"profile ({PROFILE_WINDOWS} windows of --scheme delta, fused): "
          f"wall {wall_us * per:.1f} us/window with the profiler on, device "
          f"busy {busy * per:.1f} us/window, idle share "
          f"{1.0 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us * per:9.2f} us/window  {name[:100]}")


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

    from repro_torch.core import schemes, vq
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import InstantNetwork
    from repro_torch.kernels import _build, ops, vq_assign, vq_fused
    from repro_torch.launch import train

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

    # -- 4+5. the main path, and its first windows against the oracles -------
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

    # -- 6. timing at the main path's shapes ----------------------------------
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
    print("library_ms: null for both kernels: neither function is one "
          "PyTorch call (an argmin fused with a scatter, a loop of "
          "dependent steps)")
    profile_windows(MeshExecutor(InstantNetwork(), device=dev), w0, data,
                    eval_data)

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
         "launches": counts_u["delta"], "max_abs_err": mind_err,
         "ms": d1_ms, "plain_ms": d1_plain, "bound_ms": d1_bound[0],
         "bound_by": d1_bound[1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
