"""The quantization service end to end, counterpart of
``repro/launch/serve.py --mode vq``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode vq \\
        --requests 10000 --kappa 4096 --dim 128 --points 4096 \\
        [--network geometric --p-delay 0.5] [--device cpu]

A ``CodebookStore`` holding a k-means++-style codebook drawn from
``--seed`` (or the caller's codebook, through ``run_vq``), a micro-batching
``QuantizeService`` over the ``direct`` lookup (the assign kernel), and an
open-loop load with the network's arrival process.  Prints the load report
and the flush counters; exits 1 when any request failed or the served
versions were not monotonic.  ``--train-publish`` needs the elastic
executor, which is not ported yet (ROADMAP.md queue 1, item 5): it exits 2
with an ``error:`` line.  The reference's ``--trace`` and ``--metrics`` come
with the observability slice (item 6).
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import NamedTuple

import torch

from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.engine import get_network
from repro_torch.serve import (CodebookStore, LoadReport, QuantizeService,
                               ServiceStats, ShardedLookup, run_load)


class ServeRun(NamedTuple):
    rc: int                 # the launcher's exit code
    report: LoadReport | None
    stats: ServiceStats | None
    store: CodebookStore | None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="The VQ quantization service on the PyTorch port.")
    ap.add_argument("--mode", choices=("vq",), default="vq",
                    help="only the VQ service is ported")
    ap.add_argument("--smoke", action="store_true",
                    help="at most 100 requests and 200 points")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--rows", type=int, default=1,
                    help="query vectors per request")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--kappa", type=int, default=64)
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="micro-batcher flush deadline")
    ap.add_argument("--network", choices=("instant", "fixed", "geometric"),
                    default="geometric",
                    help="arrival process (geometric = paper cloud model)")
    ap.add_argument("--latency", type=int, default=1)
    ap.add_argument("--p-delay", type=float, default=0.5)
    ap.add_argument("--tick-ms", type=float, default=0.05,
                    help="milliseconds per arrival tick (0 = saturating)")
    ap.add_argument("--train-publish", action="store_true",
                    help="not ported yet: needs the elastic executor")
    ap.add_argument("--points", type=int, default=400,
                    help="points the served codebook is drawn from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def run_vq(args, *, codebook: torch.Tensor | None = None,
           sample: int = 0) -> ServeRun:
    """Store -> service -> load -> report.  ``codebook`` (kappa, d), when
    given, is served instead of one drawn from ``args.seed``; ``sample``
    keeps that many (query, response) pairs in the report."""
    if args.train_publish:
        print("error: --train-publish needs the elastic mesh executor, not "
              "ported yet (ROADMAP.md queue 1, item 5)")
        return ServeRun(2, None, None, None)
    if args.smoke:
        args.requests = min(args.requests, 100)
        args.points = min(args.points, 200)
    dev = device_lib.resolve(args.device)
    if codebook is None:
        if args.points < args.kappa:
            print(f"error: --points {args.points} is less than --kappa "
                  f"{args.kappa}; the codebook is kappa distinct points")
            return ServeRun(2, None, None, None)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        data = synthetic.replicate_stream(gen, 1, n=args.points, d=args.dim)
        codebook = synthetic.kmeanspp_init(gen, data[0], args.kappa)

    net_kw = {}
    if args.network == "fixed":
        net_kw["latency_ticks"] = args.latency
    elif args.network == "geometric":
        net_kw["p_delay"] = args.p_delay
    network = get_network(args.network, **net_kw)

    store = CodebookStore(codebook, device=dev)
    lookup = ShardedLookup(device=dev)
    kappa, d = store.latest().w.shape
    print(f"serve: devices={lookup.n_shards} plan={lookup.plan(kappa, d)} "
          f"max_batch={lookup.n_shards * 128} "
          f"max_delay={args.max_delay_ms}ms network={args.network} "
          f"kappa={kappa} d={d} device={dev}")
    t0 = time.perf_counter()
    with QuantizeService(store, lookup,
                         max_delay_s=args.max_delay_ms * 1e-3) as service:
        # a full collection scans every object the process holds, torch's
        # own included, and stalls the flush thread for as long: freeze the
        # start-up heap so that passes during the load scan what it makes
        gc.freeze()
        try:
            report = run_load(
                service, n_requests=args.requests, d=d,
                rows_per_request=args.rows, network=network,
                tick_s=args.tick_ms * 1e-3,
                generator=torch.Generator().manual_seed(args.seed),
                sample=sample)
        finally:
            gc.unfreeze()
    wall = time.perf_counter() - t0

    print(report.summary())
    st = service.stats
    print(f"flushes={st.flushes} (full={st.full_flushes} "
          f"deadline={st.deadline_flushes}) mean_fill={st.mean_fill:.1f} "
          f"rows/flush, padded_rows={st.padded_rows}, "
          f"warmups={st.warmups}")
    print(f"done in {wall:.2f}s wall")
    rc = 0
    if report.failed:
        print(f"error: {report.failed} requests failed")
        rc = 1
    elif not report.versions_monotonic:
        print("error: served codebook versions were not monotonic")
        rc = 1
    return ServeRun(rc, report, st, store)


def main(argv=None) -> int:
    device_lib.pin_full_f32()
    return run_vq(parse_args(argv)).rc


if __name__ == "__main__":
    raise SystemExit(main())
