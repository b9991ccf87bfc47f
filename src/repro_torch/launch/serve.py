"""Serving launchers, counterpart of ``repro/launch/serve.py``: the LM decode
loop and the VQ quantization service.

LM mode (the default): waves of requests, each prefilled once and decoded
greedily to completion, then the throughput:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \\
        [--smoke] [--waves 3 --batch 4 --prompt 16 --gen 16] [--seed 0] \\
        [--device cpu]

The weights are random, drawn on the device from ``--seed`` (nothing is
read from disk), in the config's dtype (bf16 at the published widths,
f32 for ``--smoke``); the prompts come from a generator seeded by
``--seed``.  It prints the reference's two lines, ``wave i: generated G
tokens x B requests`` and ``served R requests, N tokens in S s (X tok/s)``,
and a line of prefill ms and decode ms a token (the device synced around
each).  A VLM request's cache also holds its patch positions
(``img_tokens`` of them), so ``max_len`` counts them: the reference's
``run_lm`` leaves them out and its decode writes past the cache, which
JAX's ``dynamic_update_slice`` clamps to the last slot.

VQ mode:

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

Under a torchrun world (``torchrun --standalone --nproc-per-node P -m
repro_torch.launch.serve --mode vq ...``) the service spans the world:
``ShardedLookup`` over a group of every rank with ``auto`` routing (past
the shared-memory budget, as kappa 4,096 at d 128, ``shard_kappa``), rank
0 owning the store, the queue, the flush thread and the load, the other
ranks following its flushes (``serve.service.follow``); rank 0 prints the
report and each rank's flushes, warm-ups, failures and assign launches,
and every rank exits with the run's code (the largest rank's).
``--train-publish`` there runs its elastic trainer on ``min(8, P)`` ranks
on a thread of every rank, over groups of its own, rank 0's store
publishing.

``--trace OUT.json`` / ``--metrics OUT.jsonl`` write the trace (flush,
load and trainer spans, the trainer's tick timeline) and append the
metrics registry (latency, fill and queue histograms, the trainer's
metrics) as JSON lines.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import threading
import time
from typing import NamedTuple

import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import process_group
from repro_torch.engine import (ElasticMeshExecutor, InstantNetwork,
                                ResizeSchedule, get_network)
from repro_torch.models.api import get_api
from repro_torch.models.common import ModelConfig
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (CodebookStore, LoadReport, QuantizeService,
                               ServiceStats, ShardedLookup, follow, run_load)
from repro_torch.training import steps as steps_lib

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


class LmRun(NamedTuple):
    rc: int                 # the launcher's exit code
    cfg: ModelConfig
    params: dict            # the served weights
    tokens: list            # per wave: (batch, gen) greedy tokens
    init_s: float           # drawing the weights on the device
    prefill_ms: list        # per wave
    decode_ms: list         # per wave, ms a decode step (a token a request)
    tok_s: float            # tokens generated over every wave's wall


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="LM serving and the VQ quantization service on the "
                    "PyTorch port.")
    ap.add_argument("--mode", choices=("lm", "vq"), default="lm")
    ap.add_argument("--arch", default="granite_8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="lm: the arch's reduced smoke config; vq: at most "
                         "100 requests and 200 points")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    # VQ-mode options (--mode vq): service + load + optional live trainer
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


def _no_publish(window: int, w: torch.Tensor) -> None:
    """A follower's trainer hook: rank 0 publishes (every rank's trainer
    takes the same chunks)."""


def _follow(lookup, trainer, trainer_thread, trainer_err) -> ServeRun:
    """A follower rank: its trainer thread, if any, beside the service's
    follower loop until rank 0's stop header."""
    if trainer_thread is not None:
        trainer_thread.start()
    try:
        stats = follow(lookup)
    finally:
        if trainer_thread is not None:
            trainer_thread.join()
    rc = 1 if stats.failed or trainer_err else 0
    return ServeRun(rc, None, stats, None, trainer)


def run_vq(args, *, codebook: torch.Tensor | None = None,
           sample: int = 0, keep: int = 16, group=None,
           dev: torch.device | None = None) -> ServeRun:
    """Store -> service -> load -> report.  ``codebook`` (kappa, d), when
    given, is served instead of one drawn from ``args.seed`` (not with
    ``--train-publish``, whose trainer starts from its own); ``sample``
    keeps that many (query, response) pairs in the report; ``keep`` is the
    store's snapshot history.  ``group``: a process group spanning the
    world, whose ranks share the lookup (rank 0 serves, the others
    follow), on ``dev``; a follower's ``ServeRun`` holds its code and its
    ``follow`` counts only."""
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
    dev = device_lib.resolve(args.device) if dev is None else dev
    leader = group is None or process_group.group_rank(group) == 0
    m_train = (TRAIN_WORKERS if group is None
               else min(TRAIN_WORKERS, process_group.group_size(group)))
    observe = bool(args.trace or args.metrics)
    tracer = Tracer() if observe else None
    metrics = MetricsRegistry() if observe else None
    data = None
    if codebook is None:
        n_points = m_train * args.points if args.train_publish else \
            args.points
        if n_points < args.kappa:
            print(f"error: --points {args.points} is less than --kappa "
                  f"{args.kappa}; the codebook is kappa distinct points")
            return ServeRun(2, None, None, None)
        if leader or args.train_publish:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            m = m_train if args.train_publish else 1
            data = synthetic.replicate_stream(gen, m, n=args.points,
                                              d=args.dim)
            codebook = synthetic.kmeanspp_init(
                gen, data.reshape(-1, args.dim), args.kappa)

    lookup = ShardedLookup(group=group, device=dev)
    store = CodebookStore(codebook, device=dev, keep=keep) if leader else None
    if leader:
        kappa, d = store.latest().w.shape
        print(f"serve: devices={lookup.n_shards} plan="
              f"{lookup.plan(kappa, d)} max_batch={lookup.n_shards * 128} "
              f"max_delay={args.max_delay_ms}ms network={args.network} "
              f"kappa={kappa} d={d} device={dev}"
              + (" train-publish" if args.train_publish else ""))

    trainer = trainer_thread = None
    trainer_err: list[Exception] = []
    if args.train_publish:
        # a live elastic run publishes into the store mid-load: it grows
        # and shrinks its worker set AND hot-swaps the served codebook.
        # Over a process group it runs on every rank, over groups of its
        # own made here, before any thread starts; rank 0 publishes.
        n_windows = args.points // args.tau
        schedule = ResizeSchedule(
            [(max(1, n_windows // 3), max(1, m_train // 2)),
             (max(2, 2 * n_windows // 3), m_train)])
        trainer = ElasticMeshExecutor(
            schedule, network=InstantNetwork(),
            on_window=store.publisher() if leader else _no_publish,
            publish_every=args.publish_every, max_workers=m_train,
            tracer=tracer, metrics=metrics,
            group=None if group is None else process_group.world_group(),
            device=dev)
        trainer.prepare(m_train)
        eval_data = data[:, : min(100, args.points)]

        def train() -> None:
            try:
                trainer.run("delta", codebook, data, eval_data,
                            tau=args.tau)
            except Exception as e:  # noqa: BLE001 - reported after the load
                trainer_err.append(e)

        trainer_thread = threading.Thread(target=train, name="train-publish")
    if not leader:
        return _follow(lookup, trainer, trainer_thread, trainer_err)

    net_kw = {}
    if args.network == "fixed":
        net_kw["latency_ticks"] = args.latency
    elif args.network == "geometric":
        net_kw["p_delay"] = args.p_delay
    network = get_network(args.network, **net_kw)

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


def lm_batch(cfg: ModelConfig, batch: int, prompt: int,
             gen: torch.Generator, dev: torch.device) -> dict:
    """One wave's requests: ``batch`` random prompts of ``prompt`` tokens
    and the stub frontends' inputs (whisper's frames, InternVL2's patch
    embeddings), drawn from ``gen`` on ``dev``."""
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt),
                                   generator=gen, device=dev)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn(
            (batch, cfg.encoder_frames, cfg.d_model), generator=gen,
            device=dev).to(cfg.dtype)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(
            (batch, cfg.img_tokens, cfg.d_model), generator=gen,
            device=dev).to(cfg.dtype)
    return out


def run_lm(args) -> LmRun:
    """Waves of prefill + greedy decode over weights drawn from
    ``--seed``."""
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    dev = device_lib.resolve(args.device)
    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init(args.seed, device=dev)
    device_lib.synchronize(dev)
    init_s = time.perf_counter() - t0
    max_len = args.prompt + args.gen + (cfg.img_tokens
                                        if cfg.family == "vlm" else 0)
    prefill = steps_lib.make_prefill_step(cfg, max_len=max_len)
    serve = steps_lib.make_serve_step(cfg)
    print(f"serve lm: {cfg.name} ({cfg.family}, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_params():,} params, "
          f"{str(cfg.dtype).split('.')[-1]}) on {dev}; weights drawn in "
          f"{init_s:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tokens, prefill_ms, decode_ms = [], [], []
    total_tok, t0 = 0, time.perf_counter()
    for wave in range(args.waves):
        batch = lm_batch(cfg, args.batch, args.prompt, gen, dev)
        device_lib.synchronize(dev)
        ta = time.perf_counter()
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits.reshape(args.batch, -1), dim=-1)[:, None]
        device_lib.synchronize(dev)
        tb = time.perf_counter()
        out = []
        for _ in range(args.gen):
            out.append(tok)
            logits, cache = serve(params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            total_tok += args.batch
        device_lib.synchronize(dev)
        tc = time.perf_counter()
        prefill_ms.append((tb - ta) * 1e3)
        decode_ms.append((tc - tb) * 1e3 / max(args.gen, 1))
        tokens.append(torch.cat(out, dim=1) if out else tok[:, :0])
        print(f"wave {wave}: generated {args.gen} tokens x "
              f"{args.batch} requests")
    dt = time.perf_counter() - t0
    tok_s = total_tok / dt if dt > 0 else 0.0
    print(f"served {args.waves * args.batch} requests, "
          f"{total_tok} tokens in {dt:.1f}s ({tok_s:,.0f} tok/s)")
    print(f"prefill ms per wave {[round(x, 2) for x in prefill_ms]}, "
          f"decode ms a token {[round(x, 3) for x in decode_ms]}")
    return LmRun(0, cfg, params, tokens, init_s, prefill_ms, decode_ms, tok_s)


def run_process(args) -> int:
    """The VQ service across the torchrun world (joined here, or the world
    this process is already in): rank 0 serves and prints, the others
    follow; returns the run's exit code, every rank the same."""
    from repro_torch.kernels import vq_assign
    own = not process_group.in_world()
    world = (process_group.init(device=args.device) if own
             else process_group.current())
    try:
        group = process_group.world_group()
        quiet = (contextlib.redirect_stdout(io.StringIO()) if world.rank
                 else contextlib.nullcontext())
        with quiet:
            run = run_vq(args, group=group, dev=world.device)
        st = run.stats
        mine = (run.rc, (st.flushes, st.warmups, st.failed) if st else None,
                vq_assign.launches_assign)
        every = process_group.all_gather_object(mine, group)
        if world.rank == 0 and all(e[1] for e in every):
            print("per rank: flushes "
                  f"{[e[1][0] for e in every]}, warmups "
                  f"{[e[1][1] for e in every]}, failed "
                  f"{[e[1][2] for e in every]}, assign launches "
                  f"{[e[2] for e in every]}", flush=True)
        process_group.barrier(group)
    finally:
        if own:
            process_group.destroy()
    return max(e[0] for e in every)


def main(argv=None) -> int:
    device_lib.pin_full_f32()
    args = parse_args(argv)
    if args.mode == "vq":
        from repro_torch.launch.train import in_torchrun_world
        if in_torchrun_world():
            return run_process(args)
        return run_vq(args).rc
    return run_lm(args).rc


if __name__ == "__main__":
    raise SystemExit(main())
