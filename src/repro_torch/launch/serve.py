"""The quantization service end to end, counterpart of
``repro/launch/serve.py --mode vq``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode vq \\
        --requests 10000 --kappa 4096 --dim 128 --points 4096 \\
        [--network geometric --p-delay 0.5] [--train-publish] \\
        [--trace OUT.json] [--metrics OUT.jsonl] [--device cpu]

A ``CodebookStore`` holding a k-means++-style codebook drawn from
``--seed`` (or the caller's codebook, through ``run_vq``), a micro-batching
``QuantizeService`` over the ``direct`` lookup (the assign kernel), and an
open-loop load with the network's arrival process.  Prints the load report
and the flush counters; exits 1 when any request failed or the served
versions were not monotonic, 2 for ``--points < --kappa``.

``--train-publish`` trains while serving, as the reference does: an
``ElasticMeshExecutor`` on a background thread runs the delta scheme on 8
stacked workers of ``--points`` points each (the reference's ``min(8,
devices)`` on an 8-device mesh), growing and shrinking at the reference's
schedule (M/2 at a third of the windows, M at two thirds), and publishes
its codebook into the store every ``--publish-every`` windows
(``store.publisher()``); the load starts once the first trained codebook
is published (version 2).  The report adds "trainer published N codebook
versions (served a..b, max staleness s)", and a trainer exception exits 1.
The trainer and the flush thread launch on the device's default stream,
one stream: ``CodebookStore.publish`` copies the codebook to the host and
back, and a host-to-device copy from pageable memory can return before it
lands, so a flush on another stream could read a half-written snapshot.
On one stream a flush waits behind the training windows queued before it.

``--trace OUT.json`` / ``--metrics OUT.jsonl`` write the trace (flush,
load and trainer spans, the trainer's tick timeline) and append the
metrics registry (latency, fill and queue histograms, the trainer's
metrics) as JSON lines.
"""

from __future__ import annotations

import argparse
import gc
import threading
import time
from typing import NamedTuple

import torch

from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.engine import (ElasticMeshExecutor, InstantNetwork,
                                ResizeSchedule, get_network)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (CodebookStore, LoadReport, QuantizeService,
                               ServiceStats, ShardedLookup, run_load)

#: Stacked workers of the --train-publish trainer (the reference's
#: ``min(8, n_dev)`` on an 8-device mesh).
TRAIN_WORKERS = 8
#: Seconds the load waits for the trainer's first publication.
TRAIN_WAIT_S = 300.0


class ServeRun(NamedTuple):
    rc: int                 # the launcher's exit code
    report: LoadReport | None
    stats: ServiceStats | None
    store: CodebookStore | None
    trainer: ElasticMeshExecutor | None = None   # --train-publish
    tracer: Tracer | None = None                 # --trace / --metrics
    metrics: MetricsRegistry | None = None


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
                    help="run an elastic training in the background, "
                         "hot-swapping the served codebook at windows")
    ap.add_argument("--publish-every", type=int, default=2,
                    help="training windows per codebook publication")
    ap.add_argument("--points", type=int, default=400,
                    help="points the served codebook is drawn from; with "
                         "--train-publish, training points per worker")
    ap.add_argument("--tau", type=int, default=10,
                    help="--train-publish: the trainer's window")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="write a Chrome trace-event file (Perfetto): "
                         "flush spans, load spans, trainer windows")
    ap.add_argument("--metrics", default="", metavar="OUT.jsonl",
                    help="append the metrics registry (latency/fill/queue "
                         "histograms) as JSONL")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def run_vq(args, *, codebook: torch.Tensor | None = None,
           sample: int = 0, keep: int = 16) -> ServeRun:
    """Store -> service -> load -> report.  ``codebook`` (kappa, d), when
    given, is served instead of one drawn from ``args.seed`` (not with
    ``--train-publish``, whose trainer starts from its own); ``sample``
    keeps that many (query, response) pairs in the report; ``keep`` is the
    store's snapshot history."""
    if args.smoke:
        args.requests = min(args.requests, 100)
        args.points = min(args.points, 200)
        if args.train_publish:
            # stretch the load over several training windows, so the
            # monotonic-versions check sees hot swaps mid-load
            args.tick_ms = max(args.tick_ms, 4.0)
    if args.train_publish and codebook is not None:
        raise ValueError("--train-publish serves its trainer's codebooks; "
                         "pass no codebook")
    if args.publish_every < 1:
        print(f"error: --publish-every must be >= 1, got "
              f"{args.publish_every}")
        return ServeRun(2, None, None, None)
    dev = device_lib.resolve(args.device)
    observe = bool(args.trace or args.metrics)
    tracer = Tracer() if observe else None
    metrics = MetricsRegistry() if observe else None
    data = None
    if codebook is None:
        n_points = TRAIN_WORKERS * args.points if args.train_publish else \
            args.points
        if n_points < args.kappa:
            print(f"error: --points {args.points} is less than --kappa "
                  f"{args.kappa}; the codebook is kappa distinct points")
            return ServeRun(2, None, None, None)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        m = TRAIN_WORKERS if args.train_publish else 1
        data = synthetic.replicate_stream(gen, m, n=args.points, d=args.dim)
        codebook = synthetic.kmeanspp_init(gen, data.reshape(-1, args.dim),
                                           args.kappa)

    net_kw = {}
    if args.network == "fixed":
        net_kw["latency_ticks"] = args.latency
    elif args.network == "geometric":
        net_kw["p_delay"] = args.p_delay
    network = get_network(args.network, **net_kw)

    store = CodebookStore(codebook, device=dev, keep=keep)
    lookup = ShardedLookup(device=dev)
    kappa, d = store.latest().w.shape
    print(f"serve: devices={lookup.n_shards} plan={lookup.plan(kappa, d)} "
          f"max_batch={lookup.n_shards * 128} "
          f"max_delay={args.max_delay_ms}ms network={args.network} "
          f"kappa={kappa} d={d} device={dev}"
          + (" train-publish" if args.train_publish else ""))

    trainer = trainer_thread = None
    trainer_err: list[Exception] = []
    if args.train_publish:
        # a live elastic run publishes into the store mid-load: it grows
        # and shrinks its worker set AND hot-swaps the served codebook
        n_windows = args.points // args.tau
        schedule = ResizeSchedule(
            [(max(1, n_windows // 3), max(1, TRAIN_WORKERS // 2)),
             (max(2, 2 * n_windows // 3), TRAIN_WORKERS)])
        trainer = ElasticMeshExecutor(
            schedule, network=InstantNetwork(), on_window=store.publisher(),
            publish_every=args.publish_every, max_workers=TRAIN_WORKERS,
            tracer=tracer, metrics=metrics, device=dev)
        eval_data = data[:, : min(100, args.points)]

        def train() -> None:
            try:
                trainer.run("delta", codebook, data, eval_data,
                            tau=args.tau)
            except Exception as e:  # noqa: BLE001 - reported after the load
                trainer_err.append(e)

        trainer_thread = threading.Thread(target=train, name="train-publish")

    t0 = time.perf_counter()
    with QuantizeService(store, lookup,
                         max_delay_s=args.max_delay_ms * 1e-3,
                         tracer=tracer, metrics=metrics) as service:
        if trainer_thread is not None:
            trainer_thread.start()
            # the load overlaps the trainer's publications: it starts at the
            # first trained codebook (else it could see version 1 only)
            deadline = time.monotonic() + TRAIN_WAIT_S
            while not (store.wait_for(2, timeout=0.05)
                       or not trainer_thread.is_alive()
                       or time.monotonic() > deadline):
                pass
            if store.version < 2:
                trainer_thread.join()
                print("error: trainer never published a codebook"
                      + (f": {trainer_err[0]}" if trainer_err else ""))
                return ServeRun(1, None, service.stats, store, trainer,
                                tracer, metrics)
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
                sample=sample, tracer=tracer, metrics=metrics)
        finally:
            gc.unfreeze()
            if trainer_thread is not None:
                trainer_thread.join()
    wall = time.perf_counter() - t0

    print(report.summary())
    st = service.stats
    print(f"flushes={st.flushes} (full={st.full_flushes} "
          f"deadline={st.deadline_flushes}) mean_fill={st.mean_fill:.1f} "
          f"rows/flush, padded_rows={st.padded_rows}, "
          f"warmups={st.warmups}")
    if trainer is not None:
        print(f"trainer published {store.version} codebook versions "
              f"(served {report.versions_min}..{report.versions_max}, "
              f"max staleness {report.staleness_max})")
    print(f"done in {wall:.2f}s wall")
    if metrics is not None:
        print("metrics:")
        print(metrics.summary_table())
    if args.trace:
        tracer.export_chrome(args.trace)
        print(f"trace: {len(tracer.spans())} spans -> {args.trace} "
              f"(load at https://ui.perfetto.dev)")
    if args.metrics:
        n_rows = metrics.dump_jsonl(args.metrics, run="serve-vq")
        print(f"metrics: {n_rows} rows appended -> {args.metrics}")
    rc = 0
    if trainer_err:
        print(f"error: training thread failed: {trainer_err[0]!r}")
        rc = 1
    elif report.failed:
        print(f"error: {report.failed} requests failed")
        rc = 1
    elif not report.versions_monotonic:
        print("error: served codebook versions were not monotonic")
        rc = 1
    return ServeRun(rc, report, st, store, trainer, tracer, metrics)


def main(argv=None) -> int:
    device_lib.pin_full_f32()
    return run_vq(parse_args(argv)).rc


if __name__ == "__main__":
    raise SystemExit(main())
