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

``--hosts H`` (mesh only) splits the workers into H host groups: merges
run inside each group over ``--transport`` (tier 0) and across groups over
``--tier1-transport`` (tier 1; sparse by default, at ``--tier1-frac``, by
default ``acceptance_sparse_frac(kappa, d)``), and the report prints each
tier's wire; ``--tier1-frac auto`` sizes tier 1's top-k to
``--tier1-budget-ticks`` of the network's tier-1 bandwidth, a chunk of
windows at a time.  ``--quorum [--quorum-frac F]`` merges eq. 8 when a
quorum of the workers' deltas arrives (the network's late matrix decides
who is late); ``--merge dynamic --divergence-thresh T --max-stale S``
merges only when the workers' drift reaches T.  Both need ``--scheme
delta``.

``--resize WINDOW:M,...`` (mesh only) runs the ``ElasticMeshExecutor``:
the worker count changes after those global windows, the departing
workers' in-flight window merged late, with a checkpoint after each resize
into ``--ckpt-dir``; ``--resume`` restores the latest one and runs the
rest.  ``--chaos SEED:kill=K,slow=S,part=P`` draws that many faults from
SEED over the run's windows (partition targets index ``--hosts``' groups,
or two logical ones): slow workers and partitioned groups are late at the
quorum merge (``--chaos`` implies it, hence ``--scheme delta``), and kills
shrink the run by one worker each, elastically::

    PYTHONPATH=src python -m repro_torch.launch.train --mode vq \\
        --executor mesh --workers 4 --points 300 --resize 10:2,20:4 \\
        --ckpt-dir /tmp/ckpt --device cpu

``--executor thread --scheme async_delta`` runs the real-thread runtime
(``engine.threads``): M worker threads and a reducer for ``--duration-s``
wall seconds, each round delayed ``--comm-delay-s``; its curve is printed
against seconds.  It refuses a tick-based ``--network`` (other than
``instant``), ``--transport`` and ``--hosts`` with exit code 2, as the
reference does.

``--trace OUT.json`` writes a Chrome trace-event file (Perfetto) and
``--metrics OUT.jsonl`` appends the metrics registry as JSON lines; either
turns the executor's tracer and registry on, prints the registry's table,
and writes the files even when the run dies (``obs.ExitFlush``).

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
from repro_torch.checkpoint import Checkpointer
from repro_torch.comm.sweep import acceptance_sparse_frac
from repro_torch.data import synthetic
from repro_torch.engine import (ChaosNetwork, ChaosSchedule,
                                Tier1BudgetController, Topology,
                                get_executor, get_network)
from repro_torch.kernels import autotune
from repro_torch.obs import ExitFlush, MetricsRegistry, Tracer

#: Eval points per worker (the reference's ``launch/train.py`` takes 1000).
N_EVAL = 1000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="The paper's VQ schemes on the PyTorch port.")
    ap.add_argument("--mode", choices=("vq",), default="vq",
                    help="only the VQ schemes are ported")
    ap.add_argument("--executor", choices=("sim", "mesh", "thread"),
                    default="sim")
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
    ap.add_argument("--hosts", type=int, default=1,
                    help="split the M workers into this many host groups "
                         "(M must divide evenly): merges run over "
                         "--transport inside a group (tier 0) and over "
                         "--tier1-transport across groups (tier 1), with "
                         "per-tier wire accounting (mesh executor)")
    ap.add_argument("--tier1-transport", choices=("xla", "ring", "sparse"),
                    default="sparse",
                    help="--hosts > 1: the tier-1 transport across host "
                         "groups; sparse (top-k with error feedback), or "
                         "dense")
    ap.add_argument("--tier1-frac", nargs="?", default=None, const=None,
                    help="sparse tier 1: fraction of entries kept per merge "
                         "(given without a value, or not given: kappa/4 "
                         "entries of the kappa x d "
                         "displacement), or 'auto' to size it from the "
                         "measured tier-1 bytes so the transfer stays on "
                         "--tier1-budget-ticks wall ticks a window")
    ap.add_argument("--tier1-budget-ticks", type=int, default=2,
                    help="--tier1-frac auto: wall ticks a window for the "
                         "tier-1 transfer")
    ap.add_argument("--quorum", action="store_true",
                    help="the straggler-tolerant quorum merge (delta "
                         "scheme): merge when --quorum-frac of the deltas "
                         "arrive, late deltas folded in damped")
    ap.add_argument("--quorum-frac", type=float, default=0.6,
                    help="quorum merge: fraction of workers whose deltas "
                         "must arrive")
    ap.add_argument("--merge", choices=("quorum", "dynamic"), default=None,
                    help="merge override (delta scheme, mesh executor): "
                         "'quorum' (as --quorum) or 'dynamic', merging only "
                         "when the workers' drift reaches "
                         "--divergence-thresh, at the latest every "
                         "--max-stale windows")
    ap.add_argument("--divergence-thresh", type=float, default=0.0,
                    help="--merge dynamic: global squared drift that "
                         "triggers a merge; 0 merges every window (the "
                         "plain delta merge bit for bit)")
    ap.add_argument("--max-stale", type=int, default=8,
                    help="--merge dynamic: merge after this many skipped "
                         "windows")
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
    ap.add_argument("--resize", default="",
                    help="elastic resize schedule 'WINDOW:M,...' (e.g. "
                         "'20:4,40:8'): the worker count changes after "
                         "those global windows (mesh executor)")
    ap.add_argument("--chaos", default="", metavar="SEED:SCHEDULE",
                    help="seeded fault injection, e.g. '7:kill=2,slow=1,"
                         "part=1': that many worker deaths, stragglers and "
                         "host-group partitions drawn from SEED; kills "
                         "become unscheduled elastic resizes, slow and part "
                         "ride the quorum merge's late matrix (mesh "
                         "executor, --scheme delta)")
    ap.add_argument("--ckpt-dir", default="",
                    help="elastic runs: checkpoint after every resize into "
                         "this directory")
    ap.add_argument("--resume", action="store_true",
                    help="elastic runs: restore the latest checkpoint in "
                         "--ckpt-dir and skip the consumed prefix")
    ap.add_argument("--duration-s", type=float, default=2.0,
                    help="thread backend: wall seconds to run")
    ap.add_argument("--comm-delay-s", type=float, default=0.0,
                    help="thread backend: per-round comm latency (seconds)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="write a Chrome trace-event file (Perfetto): wall "
                         "spans, the modeled per-worker tick timeline, "
                         "distortion and divergence counters")
    ap.add_argument("--metrics", default="", metavar="OUT.jsonl",
                    help="append the metrics registry (counters, gauges, "
                         "histograms) as JSON lines")
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


def build_executor(args, dev: torch.device, *, tracer: Tracer | None = None,
                   metrics: MetricsRegistry | None = None):
    """The run's executor, observed by ``tracer`` / ``metrics``; raises
    ValueError on a configuration the reference refuses (``main`` prints
    it and exits 2)."""
    obs = {"tracer": tracer, "metrics": metrics}
    if args.executor == "thread":
        return get_executor("thread", duration_s=args.duration_s,
                            comm_delay_s=args.comm_delay_s, device=dev, **obs)
    net_kw = {}
    if args.network == "fixed":
        net_kw["latency_ticks"] = args.latency
    elif args.network == "geometric":
        net_kw["p_delay"] = args.p_delay
    network = get_network(args.network, **net_kw)
    if args.executor != "mesh":
        return get_executor(args.executor, network=network, device=dev,
                            **obs)
    transport = comm.get_transport(
        args.transport, **({"frac": args.compress_frac}
                           if args.transport == "sparse" else {}))
    tier1_auto = args.tier1_frac == "auto"
    kw = {}
    topology = None
    if args.hosts > 1:
        if args.tier1_frac is None or tier1_auto:
            tier1_frac = acceptance_sparse_frac(args.kappa, args.dim)
        else:
            try:
                tier1_frac = float(args.tier1_frac)
            except ValueError:
                raise ValueError(f"--tier1-frac must be a float or 'auto', "
                                 f"got {args.tier1_frac!r}") from None
        # the tier-1 transport first: a bad --tier1-frac reports as such
        tier1 = (comm.get_transport("sparse", frac=tier1_frac)
                 if args.tier1_transport == "sparse"
                 else args.tier1_transport)
        topology = Topology.from_spec(args.workers, hosts=args.hosts)
        transport = comm.HierarchicalTransport(transport, tier1,
                                               topology=topology)
        kw["topology"] = topology
    if args.wire_quant != "off":
        # the narrow wire decorates the whole stack, flat or hierarchical
        transport = comm.get_transport("quant", inner=transport,
                                       mode=args.wire_quant)
    if tier1_auto:
        if args.hosts <= 1 and args.transport != "sparse":
            raise ValueError(
                "--tier1-frac auto needs a sparse tier to adapt (--hosts > "
                "1 with a sparse --tier1-transport, or a flat --transport "
                "sparse)")
        kw["tier1_controller"] = Tier1BudgetController(
            network, budget_ticks=args.tier1_budget_ticks)
    chaos = None
    if args.chaos:
        # the faults reach the executors through the network model; the
        # partition targets index --hosts' groups, or 2 logical ones
        chaos = ChaosSchedule.from_spec(
            args.chaos, windows=args.points // args.tau, m=args.workers,
            hosts=args.hosts if args.hosts > 1 else 2)
        network = ChaosNetwork(network, chaos, topology=topology)
        print(f"chaos: {chaos.describe()}")
    merge = "quorum" if (args.quorum or args.chaos) else args.merge
    if merge == "quorum":
        kw.update(merge=merge, quorum_frac=args.quorum_frac)
    elif merge == "dynamic":
        kw.update(merge=merge, divergence_thresh=args.divergence_thresh,
                  max_stale=args.max_stale)
    if not (args.resize or (chaos is not None and chaos.kill_events)):
        return get_executor("mesh", network=network, transport=transport,
                            device=dev, **obs, **kw)
    # elastic: a schedule, or a chaos kill to shrink at
    if args.resume and not args.ckpt_dir:
        raise ValueError("--resume needs --ckpt-dir (the elastic resume "
                         "restores the latest resize checkpoint)")
    if args.wire_quant != "off":
        raise ValueError("--wire-quant does not compose with elastic resizes "
                         "(the error-feedback residual is per-worker state "
                         "the resharder does not carry across a resize)")
    return get_executor(
        "elastic", schedule=args.resize or [], network=network,
        transport=transport, resume=args.resume, chaos=chaos, device=dev,
        checkpointer=Checkpointer(args.ckpt_dir) if args.ckpt_dir else None,
        **obs, **kw)


def run_vq(args):
    """Run the scheme and print the reference's report; returns
    ``(result, executor, wall_s)``."""
    dev = device_lib.resolve(args.device)
    autotune.set_mode(args.autotune)
    if args.autotune_cache:
        autotune.set_cache_path(args.autotune_cache)
    # either flag turns the executor's tracer and registry on
    observe = bool(args.trace or args.metrics)
    tracer = Tracer() if observe else None
    metrics = MetricsRegistry() if observe else None
    executor = build_executor(args, dev, tracer=tracer, metrics=metrics)
    # armed before the run: a run that dies still leaves its files
    flusher = None
    if observe:
        flusher = ExitFlush(
            tracer=tracer if args.trace else None,
            trace_path=args.trace or None,
            metrics=metrics if args.metrics else None,
            metrics_path=args.metrics or None,
            run=f"train-vq-{args.scheme}-{executor.name}",
            catch_sigterm=True)
    w0, data, eval_data = make_inputs(args, dev)
    transport = getattr(executor, "transport", None)
    topology = getattr(executor, "topology", None)
    print(f"executor={executor.name} scheme={args.scheme} M={args.workers} "
          f"tau={args.tau} network={args.network} n={args.points} "
          f"d={args.dim} kappa={args.kappa} device={dev} "
          f"transport={transport.name if transport else 'none'}"
          + (f" topology={topology.describe()} tier1={args.tier1_transport}"
             if topology is not None else "")
          + (f" resize={args.resize}" if args.resize else ""))
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
    unit = "s" if executor.name == "thread" else "ticks"
    for i in sorted({int(j * (n - 1) / 9) for j in range(10)}):
        print(f"  {unit} {float(ticks[i]):>8.1f}  C = {float(curve[i]):.5f}")
    for ev in getattr(executor, "resize_events", []):
        ck = (f" ckpt@{ev.checkpoint_step}"
              if ev.checkpoint_step is not None else "")
        print(f"  resize @window {ev.window}: M {ev.old_m} -> {ev.new_m} "
              f"(late points merged: {ev.late_points}, "
              f"{ev.wall_s * 1e3:.1f} ms{ck})")
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
        for tier, t in sorted(merge_b.get("by_tier", {}).items()):
            label = "intra-host" if tier == 0 else "inter-host"
            print(f"  tier {tier} ({label}): wire {t['wire_bytes']:,} B "
                  f"/ logical {t['logical_bytes']:,} B per worker")
        probe = last_comm["by_tag"].get("probe")
        if probe:
            print(f"  probe: wire {probe['wire_bytes']:,} B over "
                  f"{probe['calls']} windows, merges {merge_b.get('calls', 0)}")
    if metrics is not None:
        print("metrics:")
        print(metrics.summary_table())
    if flusher is not None:
        flusher.flush()
        if args.trace:
            print(f"trace: {len(tracer.spans())} spans -> {args.trace} "
                  f"(load at https://ui.perfetto.dev)")
        if args.metrics:
            print(f"metrics: appended -> {args.metrics}")
    ckpt = getattr(executor, "checkpointer", None)
    if ckpt is not None:
        ckpt.wait()
    return res, executor, wall


def main(argv=None) -> int:
    device_lib.pin_full_f32()
    args = parse_args(argv)
    if args.points < args.tau:
        print(f"error: --points {args.points} is less than one tau="
              f"{args.tau} window")
        return 2
    if args.transport != "xla" and args.executor != "mesh":
        # the sim oracles and the threads issue no collective to reroute
        print(f"error: --transport {args.transport} needs --executor mesh "
              f"(the sim/thread backends issue no collectives)")
        return 2
    if args.executor == "thread" and args.network != "instant":
        # real threads have no tick clock: a tick-based network would be
        # dropped silently and mislabel the run
        print(f"error: --network {args.network} is tick-based; the thread "
              f"backend models communication in seconds — use "
              f"--comm-delay-s instead")
        return 2
    if args.wire_quant != "off" and args.executor != "mesh":
        print(f"error: --wire-quant quantizes the mesh transport's "
              f"collectives; got --executor {args.executor}")
        return 2
    if args.hosts > 1 and args.executor != "mesh":
        print(f"error: --hosts {args.hosts} needs --executor mesh (the "
              f"sim/thread backends issue no collectives)")
        return 2
    if args.tier1_frac == "auto" and (args.resize or args.chaos):
        print("error: --tier1-frac auto is a plain-mesh feature; it does not "
              "compose with --resize/--chaos")
        return 2
    if args.chaos and args.executor != "mesh":
        print(f"error: --chaos injects faults into the mesh executors; got "
              f"--executor {args.executor}")
        return 2
    if args.resume and not args.resize:
        # only the elastic path has VQ resume state: a plain run would
        # restart from scratch, which is not a resume
        print("error: --resume in VQ mode needs --resize (elastic runs "
              "checkpoint at resize events; plain runs have no VQ "
              "checkpoint to restore)")
        return 2
    merge = args.merge
    if args.quorum or args.chaos:
        if merge == "dynamic":
            print("error: --merge dynamic conflicts with --chaos/--quorum "
                  "(faults ride the quorum merge's late matrix; the dynamic "
                  "merge has no lateness channel)")
            return 2
        merge = "quorum"
    if merge is not None and args.scheme != "delta":
        print(f"error: the {merge} merge folds eq.-8 displacements, so it "
              f"needs --scheme delta; got {args.scheme!r}")
        return 2
    if merge is not None and args.executor != "mesh":
        print(f"error: --merge {merge} runs in the mesh executor's merge; "
              f"got --executor {args.executor}")
        return 2
    if merge == "dynamic" and args.resize:
        print("error: --merge dynamic does not compose with --resize (the "
              "elastic path reshards quorum and plain merge state only)")
        return 2
    if args.resize and args.executor != "mesh":
        print(f"error: --resize is a mesh-executor feature (elastic "
              f"resharding of the stacked workers); got --executor "
              f"{args.executor}")
        return 2
    if args.tier1_frac == "auto" and args.executor != "mesh":
        print(f"error: --tier1-frac auto adapts the mesh transport's sparse "
              f"tier; got --executor {args.executor}")
        return 2
    try:
        run_vq(args)
    except ValueError as e:  # a configuration the executor refuses
        print(f"error: {e}")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
