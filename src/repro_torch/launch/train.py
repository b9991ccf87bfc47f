"""Training launcher for the paper's VQ schemes, counterpart of
``repro/launch/train.py --mode vq``.

    PYTHONPATH=src python -m repro_torch.launch.train --mode vq \\
        --executor mesh --scheme delta --workers 8 --points 125000 \\
        --dim 128 --kappa 4096

``--transport ring`` (mesh executor only) merges through the ring
all-reduce kernel, ``--transport sparse --compress-frac F`` through the
top-k/error-feedback transport, each worker shipping its F * kappa * d
largest displacement entries; ``--wire-quant {bf16,int8}`` (mesh only)
encodes the merge deltas over either, with error feedback.  ``--scheme
async_delta`` runs eq. 9 with the per-tick masked merge; its
round lengths are drawn from the network with a CPU generator seeded by
``--seed``.  Data is drawn from ``--seed`` on the run's device (``--device
cuda``, the default, or ``cpu``).  Prints the distortion-vs-ticks table, the
wall time in us/point and the merge wire bytes, as the reference does.

Any ``--dim`` runs: past the delta kernel's shared memory (d > 1,807) the
per-step and per-tick steps take the blocked assign+delta kernel, e.g. eq. 9
on a 3072-wide embedding codebook::

    PYTHONPATH=src python -m repro_torch.launch.train --mode vq \
        --executor mesh --scheme async_delta --network geometric \
        --p-delay 0.5 --workers 8 --points 2000 --dim 3072 --kappa 4096

``--autotune {off,cache,search}`` picks the kernels' tiles
(``kernels.autotune``; tiles change no bit) and ``--autotune-cache
TILES.json`` keeps the picks in a file.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import comm
from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.engine import get_executor, get_network
from repro_torch.kernels import autotune

#: Eval points per worker (the reference's ``launch/train.py`` takes 1000).
N_EVAL = 1000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="The paper's VQ schemes on the PyTorch port.")
    ap.add_argument("--mode", choices=("vq",), default="vq",
                    help="only the VQ schemes are ported")
    ap.add_argument("--executor", choices=("sim", "mesh"), default="sim")
    ap.add_argument("--scheme", choices=("average", "delta", "async_delta"),
                    default="delta")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--points", type=int, default=2000,
                    help="data points per worker")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--kappa", type=int, default=16)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--eps0", type=float, default=0.5)
    ap.add_argument("--network", choices=("instant", "fixed", "geometric"),
                    default="instant")
    ap.add_argument("--latency", type=int, default=1)
    ap.add_argument("--p-delay", type=float, default=0.5)
    ap.add_argument("--transport", choices=("xla", "ring", "sparse"),
                    default="xla",
                    help="merge transport (mesh executor): dense, dense "
                         "through the ring kernel, or top-k with error "
                         "feedback")
    ap.add_argument("--compress-frac", type=float, default=0.01,
                    help="sparse transport: fraction of entries each worker "
                         "ships per merge")
    ap.add_argument("--wire-quant", choices=("off", "bf16", "int8"),
                    default="off",
                    help="quantize merge deltas on the wire (mesh "
                         "executor): bf16 halves, int8 quarters the merge "
                         "wire bytes, both with an error-feedback residual")
    ap.add_argument("--autotune", choices=autotune.MODES, default="cache",
                    help="kernel tile selection: 'off' pins the untuned "
                         "tiles, 'cache' picks per shape from the model "
                         "(memoized), 'search' also times the model's first "
                         "candidates on the card and keeps the fastest")
    ap.add_argument("--autotune-cache", default="", metavar="TILES.json",
                    help="keep tuned tiles in this JSON file (read at "
                         "start; keyed by shape and device name)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def make_inputs(args, dev: torch.device):
    """(w0, data, eval_data) for a run, drawn from ``args.seed`` on dev."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    data = synthetic.replicate_stream(gen, args.workers, n=args.points,
                                      d=args.dim)
    eval_data = data[:, : min(N_EVAL, args.points)].contiguous()
    w0 = synthetic.kmeanspp_init(gen, data.reshape(-1, args.dim), args.kappa)
    return w0, data, eval_data


def build_executor(args, dev: torch.device):
    net_kw = {}
    if args.network == "fixed":
        net_kw["latency_ticks"] = args.latency
    elif args.network == "geometric":
        net_kw["p_delay"] = args.p_delay
    kw = {}
    if args.executor == "mesh":
        transport = comm.get_transport(
            args.transport, **({"frac": args.compress_frac}
                               if args.transport == "sparse" else {}))
        if args.wire_quant != "off":
            transport = comm.get_transport("quant", inner=transport,
                                           mode=args.wire_quant)
        kw["transport"] = transport
    return get_executor(args.executor, network=get_network(args.network,
                                                           **net_kw),
                        device=dev, **kw)


def run_vq(args):
    """Run the scheme and print the reference's report; returns
    ``(result, executor, wall_s)``."""
    dev = device_lib.resolve(args.device)
    autotune.set_mode(args.autotune)
    if args.autotune_cache:
        autotune.set_cache_path(args.autotune_cache)
    w0, data, eval_data = make_inputs(args, dev)
    executor = build_executor(args, dev)
    transport = getattr(executor, "transport", None)
    print(f"executor={executor.name} scheme={args.scheme} M={args.workers} "
          f"tau={args.tau} network={args.network} n={args.points} "
          f"d={args.dim} kappa={args.kappa} device={dev} "
          f"transport={transport.name if transport else 'none'}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = executor.run(args.scheme, w0, data, eval_data, tau=args.tau,
                       eps0=args.eps0,
                       generator=torch.Generator().manual_seed(args.seed))
    curve = res.distortion.cpu()   # waits for the device
    wall = time.perf_counter() - t0
    ticks = res.wall_ticks.cpu()
    n = len(curve)
    for i in sorted({int(j * (n - 1) / 9) for j in range(10)}):
        print(f"  ticks {float(ticks[i]):>8.1f}  C = {float(curve[i]):.5f}")
    pts = args.workers * args.points
    print(f"done: C(final)={float(curve[-1]):.5f} in {wall:.2f}s wall "
          f"({wall / pts * 1e6:.2f} us/point over {pts} points)")
    last_comm = getattr(executor, "last_comm", None)
    if last_comm:
        merge_b = last_comm["by_tag"].get(
            "merge", {"wire_bytes": 0, "logical_bytes": 0})
        print(f"comm[{transport.name}]: merge wire "
              f"{merge_b['wire_bytes']:,} B / logical "
              f"{merge_b['logical_bytes']:,} B per worker "
              f"({last_comm['calls']} collective calls, measured)")
    return res, executor, wall


def main(argv=None) -> int:
    device_lib.pin_full_f32()
    args = parse_args(argv)
    if args.points < args.tau:
        print(f"error: --points {args.points} is less than one tau="
              f"{args.tau} window")
        return 2
    if args.transport != "xla" and args.executor != "mesh":
        # the sim oracles issue no collective for a transport to reroute
        print(f"error: --transport {args.transport} needs --executor mesh "
              f"(the sim backend issues no collectives)")
        return 2
    if args.wire_quant != "off" and args.executor != "mesh":
        print(f"error: --wire-quant quantizes the mesh transport's "
              f"collectives; got --executor {args.executor}")
        return 2
    run_vq(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
