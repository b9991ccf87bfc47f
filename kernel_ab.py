#!/usr/bin/env python3
"""Times one checkout's delta, window, top-k, ring, assign and blocked
kernels on one CUDA card, on the yardstick ``chip_smoke.py`` uses for every
kernel (``chip_smoke.kernel_ms``: CUDA events around each call, the L2
cache flushed before it) and back to back (``chip_smoke.time_ms``: "warm", L2
warm and the wrapper's host time included), beside ``torch.topk`` and
``torch.sum``, at the main path's shapes.

    python3 kernel_ab.py [--src DIR]

imports ``repro_torch`` from DIR (default: this checkout's ``src``) and
builds DIR's kernels, so two checkouts are compared on one card by running
it on each in turns (an older checkout unpacked with ``git archive`` into a
directory that ``.gitignore`` lists):

    python3 kernel_ab.py --src OLD/src; python3 kernel_ab.py
    python3 kernel_ab.py; python3 kernel_ab.py --src OLD/src

Inputs are chip_smoke's, from the same seeds: the delta kernel at (8, 1) x
4096 x 128 (the first point of each worker against the codebooks after the
first window), the window kernel at M=8, tau=10 on the first window, the
first window's displacement at (8, 524,288) for top-k (k = 5,242 and 524),
N(0, 1) entries at (8, 524,288) and (8, 12,582,912) for the ring; the
assign kernel at the serving flush (worker 0's first 128 points against
its codebook), the eval shape ((8, 1000) x 4096 x 128) and (8, 1) x 4096 x
3072 (the 3072-wide eq.-9 inputs, its codebooks moved by 0.01 N(0, 1)
noise), and the blocked kernel at that shape with and without the
epilogue (a 0.01 N(0, 1) residual) and at (8, 1) x 4096 x 128.  With
``--eq9`` it then runs chip_smoke's eq.-9 leg (``--scheme async_delta
--network geometric``, 8 x 125,000 points) through the launcher and adds
its wall time in seconds, a host-bound path that the wrappers' host time
moves.  With ``--paths`` it runs three of chip_smoke's legs through the
launchers and adds their results: the dense sync delta run (``--scheme
delta``, 8 x 125,000 points) and eq. 9 on the 3072-wide codebook (2,000
ticks a worker), wall seconds; and the geometric serving leg (10,000
requests on the sync run's codebook), q/s, p50 and p99 ms.  Prints one
JSON line: ``src``, ``card`` (nvidia-smi's name and power limit) and ms
for each call.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(cs.ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--eq9", action="store_true",
                    help="also time the eq.-9 leg at full depth")
    ap.add_argument("--paths", action="store_true",
                    help="also run the sync delta, 3072-wide eq.-9 and "
                         "serving legs")
    opts = ap.parse_args()
    src = Path(opts.src).resolve()
    if not (src / "repro_torch").is_dir():
        cs.fail(f"no repro_torch package under {src}")
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        cs.fail("kernel_ab.py needs a CUDA card")
    from repro_torch import device as device_lib
    from repro_torch.comm import ring
    from repro_torch.core import vq
    from repro_torch.engine import merge as merge_lib
    from repro_torch.kernels import _build, vq_assign, vq_fused
    from repro_torch.launch import train

    device_lib.pin_full_f32()
    dev = torch.device("cuda")
    _build.library()
    args = train.parse_args([
        "--executor", "mesh", "--workers", str(cs.M), "--points",
        str(cs.N_PER), "--dim", str(cs.D), "--kappa", str(cs.KAPPA),
        "--tau", str(cs.TAU), "--seed", str(cs.SEED), "--network",
        "instant", "--scheme", "delta"])
    w0, data, eval_data = train.make_inputs(args, dev)
    eps = vq.default_steps(torch.arange(1, cs.TAU + 1, device=dev))
    zwin = data[:, :cs.TAU].contiguous()
    w_local = vq_fused.vq_window(zwin, w0, eps)
    payload = merge_lib.tree_sub_f32(w0, w_local).reshape(cs.M, -1)
    z1 = data[:, :1].contiguous()
    normal = torch.randn(
        (cs.M, cs.KAPPA * cs.D), generator=torch.Generator(
            device=dev).manual_seed(cs.SEED + 5), device=dev)
    wide = torch.randn((cs.M, cs.KAPPA * cs.WIDE_D), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           cs.SEED + 9))
    w0w, dataw, _ = train.make_inputs(train.parse_args([
        "--executor", "mesh", "--workers", str(cs.M), "--points",
        str(cs.WIDE_POINTS), "--dim", str(cs.WIDE_D), "--kappa",
        str(cs.KAPPA), "--tau", str(cs.TAU), "--seed", str(cs.SEED),
        "--scheme", "async_delta", "--network", "geometric"]), dev)
    gen_w = torch.Generator(device=dev).manual_seed(cs.SEED + 12)
    ww = (w0w + 0.01 * torch.randn((cs.M, cs.KAPPA, cs.WIDE_D),
                                   generator=gen_w, device=dev)).contiguous()
    resid_w = 0.01 * torch.randn((cs.M, cs.KAPPA, cs.WIDE_D),
                                 generator=gen_w, device=dev)
    z1w = dataw[:, :1].contiguous()
    zf = data[0, :cs.FLUSH_ROWS].contiguous()
    wf = w_local[0].contiguous()
    out = {"src": str(src), "card": cs.card_line()}
    for name, fn, iters in (
            ("delta (8, 1)", lambda: vq_assign.vq_delta(z1, w_local), 200),
            (f"window M={cs.M} tau={cs.TAU}",
             lambda: vq_fused.vq_window(zwin, w0, eps), 200),
            ("assign flush 128", lambda: vq_assign.vq_assign(zf, wf), 200),
            ("assign (8, 1000)",
             lambda: vq_assign.vq_assign(eval_data, w_local), 20),
            ("assign (8, 1) d=3072", lambda: vq_assign.vq_assign(z1w, ww),
             100),
            ("blocked (8, 1) d=3072",
             lambda: vq_fused.vq_delta_blocked(z1w, ww), 100),
            ("blocked (8, 1) d=3072 epilogue",
             lambda: vq_fused.vq_delta_blocked(z1w, ww, residual=resid_w),
             100),
            ("blocked (8, 1) d=128",
             lambda: vq_fused.vq_delta_blocked(z1, w_local), 200)):
        out[name] = [cs.kernel_ms(fn, iters) for _ in range(2)]
        out[f"{name} warm"] = cs.time_ms(fn, iters)
    for k in (max(1, int(cs.SPARSE_FRAC * cs.KAPPA * cs.D)),
              max(1, int(cs.LOSSY_FRAC * cs.KAPPA * cs.D))):
        tk, tl = cs.in_turns(lambda: vq_fused.vq_topk(payload, k),
                             lambda: torch.topk(payload.abs(), k, dim=1), 50)
        out[f"topk k={k}"] = tk
        out[f"torch.topk k={k}"] = tl
        out[f"topk k={k} warm"] = cs.time_ms(
            lambda: vq_fused.vq_topk(payload, k), 100)
    for x, iters in ((normal, 200), (wide, 20)):
        n = x.shape[1]
        rk, rl = cs.in_turns(lambda: ring.ring_all_reduce(x),
                             lambda: torch.sum(x, dim=0), iters)
        out[f"ring n={n}"] = rk
        out[f"torch.sum n={n}"] = rl
        out[f"ring n={n} warm"] = cs.time_ms(
            lambda: ring.ring_all_reduce(x), iters)
        out[f"torch.sum n={n} warm"] = cs.time_ms(
            lambda: torch.sum(x, dim=0), iters)
    if opts.eq9:
        _, _, out["eq9 wall s"] = train.run_vq(train.parse_args(
            ["--executor", "mesh", "--scheme", "async_delta", "--workers",
             str(cs.M), "--points", str(cs.N_PER), "--dim", str(cs.D),
             "--kappa", str(cs.KAPPA), "--tau", str(cs.TAU), "--seed",
             str(cs.SEED), "--network", "geometric", "--p-delay",
             str(cs.P_DELAY)]))
    if opts.paths:
        from repro_torch.launch import serve
        res, _, out["sync delta wall s"] = train.run_vq(train.parse_args([
            "--executor", "mesh", "--workers", str(cs.M), "--points",
            str(cs.N_PER), "--dim", str(cs.D), "--kappa", str(cs.KAPPA),
            "--tau", str(cs.TAU), "--seed", str(cs.SEED), "--network",
            "instant", "--scheme", "delta"]))
        _, _, out["eq9 d=3072 wall s"] = train.run_vq(train.parse_args([
            "--executor", "mesh", "--workers", str(cs.M), "--points",
            str(cs.WIDE_POINTS), "--dim", str(cs.WIDE_D), "--kappa",
            str(cs.KAPPA), "--tau", str(cs.TAU), "--seed", str(cs.SEED),
            "--scheme", "async_delta", "--network", "geometric",
            "--p-delay", str(cs.P_DELAY)]))
        run = serve.run_vq(serve.parse_args([
            "--mode", "vq", "--kappa", str(cs.KAPPA), "--dim", str(cs.D),
            "--requests", str(cs.SERVE_REQUESTS), "--seed", str(cs.SEED),
            "--network", "geometric", "--p-delay", str(cs.P_DELAY)]),
            codebook=res.w_shared)
        if run.rc != 0 or run.report is None or run.report.failed:
            cs.fail(f"serving leg exited {run.rc}")
        out["serve q/s"] = run.report.qps
        out["serve p50 ms"] = run.report.p50_ms
        out["serve p99 ms"] = run.report.p99_ms
    print(json.dumps(out))


if __name__ == "__main__":
    main()
