#!/usr/bin/env python3
"""Times one checkout's delta, window, top-k and ring kernels on one CUDA
card, on the yardstick ``chip_smoke.py`` uses for every kernel
(``chip_smoke.kernel_ms``: CUDA events around each call, the L2 cache
flushed before it) and back to back (``chip_smoke.time_ms``: "warm", L2
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
N(0, 1) entries at (8, 524,288) and (8, 12,582,912) for the ring.  With
``--eq9`` it then runs chip_smoke's eq.-9 leg (``--scheme async_delta
--network geometric``, 8 x 125,000 points) through the launcher and adds
its wall time in seconds, a host-bound path that the wrappers' host time
moves.  Prints one JSON line: ``src``, ``card`` (nvidia-smi's name and
power limit) and ms for each call.
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
    w0, data, _ = train.make_inputs(args, dev)
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
    out = {"src": str(src), "card": cs.card_line()}
    for name, fn in (
            ("delta (8, 1)", lambda: vq_assign.vq_delta(z1, w_local)),
            (f"window M={cs.M} tau={cs.TAU}",
             lambda: vq_fused.vq_window(zwin, w0, eps))):
        out[name] = [cs.kernel_ms(fn, 200) for _ in range(2)]
        out[f"{name} warm"] = cs.time_ms(fn, 200)
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
