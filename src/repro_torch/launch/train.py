"""Training launcher, counterpart of ``repro/launch/train.py``: LM
training (the default mode) and the paper's VQ schemes.

LM mode trains one of the registry's architectures on the step-indexed
synthetic pipeline (``data.pipeline.lm_batch``) with AdamW under a cosine
schedule (20 warm-up steps), checkpointing asynchronously every
``--ckpt-every`` steps into ``--ckpt-dir``; ``--resume`` continues from the
latest checkpoint there, bit for bit, since batch i is a function of
(seed, i)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \\
        --smoke --steps 200 --ckpt-dir /tmp/ckpt [--resume] --device cpu

It prints ``arch=... device=... mesh=...``, then ``step N  loss ...
gnorm ...  tok/s ...`` every ``--log-every`` steps (the only place the
host waits for the card) and ``done: ...``.  An encoder-decoder arch
(whisper-tiny) exits 2: the pipeline draws no encoder frames.

``--data-axis D`` is data parallelism, the reference's ``make_host_mesh
(data=D)`` (its lines 526-544): under a torchrun world the first D ranks
form a (data, model) = (D, 1) grid (``topology.make_host_groups``, clamped
to the world as the reference clamps to its devices), every rank holds
the whole state and takes its rows of each step's batch
(``sharding.batch_specs``: every rank the whole batch where D does not
divide it), and the grads and loss are averaged over the data group in
one flat f32 bucket a step (``steps.mean_over_group``) before the clip and
AdamW, which run identically on every rank::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --mode lm --arch granite_8b --smoke \
        --data-axis 2 --steps 20 --ckpt-dir /tmp/ckpt --device cpu

Rank 0 prints the lines and writes the checkpoints; ``--resume`` restores
on every rank; ranks past the grid take no part and exit 0.  In one
process ``--data-axis D`` clamps to 1 and prints the mesh, as the
reference does on one device.

VQ mode::

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

``--profile PROF.json`` (mesh executor, elastic runs included) attributes
the run's wall to compute, memory, collective and host terms per window
(``obs.Profiler``; on the card ``host`` is the residual the model does not
explain), prints the attribution table, writes the export and prints the
command that renders it (``python -m repro_torch.obs.report --profile
PROF.json``); any other ``--executor`` exits 2.

Under a torchrun world (``torchrun --standalone --nproc-per-node N -m
repro_torch.launch.train --mode vq --executor mesh ...``) the mesh
executor runs one worker a process (``distributed.process_group``): gloo
on the CPU, NCCL when every rank has a card of its own, gloo over CUDA
tensors when ranks share one (the ring's hops then run the hop kernel over
CUDA IPC).  ``--workers`` must equal the world size; ``--hosts H`` splits
the ranks as ``Topology.simulate`` splits workers, tier 1 over
``--tier1-transport`` (sparse by default, a top-k per rank gathered over
the ranks with its worker coordinate).  Every rank draws the same global
inputs and keeps its own rows; rank 0 prints the report and the kernels'
launches on every rank, and every rank exits with the run's code.  The
sparse transport, ``--quorum``, ``--merge``, ``--chaos``,
``--tier1-frac auto``, ``--trace``, ``--metrics`` and ``--profile`` run
there (every rank observes its run; rank 0 writes the files), and so do
``--resize``, ``--resume`` and chaos kills: the elastic executor over the
world (``ElasticMeshExecutor(group=)``), a count of M on ranks 0 .. M - 1,
the ranks past it idle until a grow includes them, a kill leaving the
last active rank idle; rank 0 writes the checkpoints and prints the resize
events.  ``--save-result OUT.pt`` writes the run's ``w_shared``, curve and
ticks (rank 0 in a world).

``--autotune {off,cache,search}`` picks the kernels' tiles
(``kernels.autotune``; tiles change no bit) and ``--autotune-cache
TILES.json`` keeps the picks in a file.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time
from typing import NamedTuple

import torch

from repro_torch import comm
from repro_torch import device as device_lib
from repro_torch.checkpoint import Checkpointer
from repro_torch.comm.sweep import acceptance_sparse_frac
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed import process_group
from repro_torch.engine import (ChaosNetwork, ChaosSchedule,
                                Tier1BudgetController, Topology,
                                get_executor, get_network)
from repro_torch.kernels import autotune
from repro_torch.obs import ExitFlush, MetricsRegistry, Profiler, Tracer
from repro_torch.optim import optimizers
from repro_torch.training import steps as steps_lib

#: Eval points per worker (the reference's ``launch/train.py`` takes 1000).
N_EVAL = 1000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="LM training and the paper's VQ schemes on the "
                    "PyTorch port.")
    ap.add_argument("--mode", choices=("lm", "vq"), default="lm")
    # LM-mode options (--mode lm)
    ap.add_argument("--arch", default="granite_8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-axis", type=int, default=1,
                    help="data-parallel ranks of a torchrun world (clamped "
                         "to the world; 1 in one process)")
    ap.add_argument("--log-every", type=int, default=10)
    # VQ-mode options (--mode vq): engine backend + paper hyperparameters
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
                    help="LM mode: checkpoint every --ckpt-every steps "
                         "into this directory; elastic VQ runs: after "
                         "every resize")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir and "
                         "skip the consumed prefix (LM mode, elastic VQ "
                         "runs)")
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
    ap.add_argument("--profile", default="", metavar="PROF.json",
                    help="roofline-attribute the run (mesh executor only): "
                         "decompose the measured per-window wall into "
                         "hand-counted compute and HBM terms, the run's "
                         "collective bytes from its CommRecords, and the "
                         "host residual; prints the attribution table and "
                         "writes the Profiler export (render with "
                         "repro_torch.obs.report --profile)")
    ap.add_argument("--save-result", default="", metavar="OUT.pt",
                    help="write the run's w_shared, distortion curve and "
                         "wall ticks with torch.save (rank 0 in a world)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def in_torchrun_world() -> bool:
    """Started by torchrun (its RANK, WORLD_SIZE and LOCAL_RANK are set)."""
    return all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                           "LOCAL_RANK"))


def process_refusal(args, world_size: int) -> str | None:
    """Why this configuration cannot run one worker a process, or None."""
    if args.executor != "mesh":
        return (f"under a torchrun world the mesh executor runs one worker "
                f"a process; --executor {args.executor} runs in one process")
    if args.workers != world_size:
        return (f"--workers {args.workers} must equal the world size "
                f"{world_size} (one worker a rank)")
    return None


def _chaos_schedule(args) -> ChaosSchedule:
    """``--chaos``'s faults over the run's windows; partition targets index
    ``--hosts``' groups, or 2 logical ones."""
    return ChaosSchedule.from_spec(
        args.chaos, windows=args.points // args.tau, m=args.workers,
        hosts=args.hosts if args.hosts > 1 else 2)


def _chaos_kills(args) -> bool:
    """Does ``--chaos`` draw a kill?  A bad spec is the executor's to
    refuse."""
    if not args.chaos:
        return False
    try:
        return bool(_chaos_schedule(args).kill_events)
    except ValueError:
        return False


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from repro_torch.comm import ring
    from repro_torch.kernels import vq_assign, vq_fused
    return {"window": vq_fused.launches, "delta": vq_assign.launches,
            "assign": vq_assign.launches_assign,
            "blocked": vq_fused.launches_blocked,
            "topk": vq_fused.launches_topk, "ring": ring.launches_ring,
            "ring_hop": ring.launches_ring_hop,
            "divergence": vq_fused.launches_divergence}


def run_process(args) -> int:
    """The mesh executor with one worker a process of the torchrun world
    (joined here, or the world this process is already in); returns the
    run's exit code (every rank the same)."""
    own = not process_group.in_world()
    world = (process_group.init(device=args.device) if own
             else process_group.current())
    try:
        topology = Topology.from_spec(world.world_size, hosts=args.hosts)
        process_group.set_topology(topology)
        groups = topology.make_groups()
        quiet = (contextlib.redirect_stdout(io.StringIO()) if world.rank
                 else contextlib.nullcontext())
        with quiet:
            run_vq(args, groups=groups, dev=world.device)
        counts = process_group.all_gather_object(_launch_counts())
        if world.rank == 0:
            print("launches per rank: " + json.dumps(
                {k: [c[k] for c in counts] for k in counts[0]}), flush=True)
        process_group.barrier()
    finally:
        if own:
            process_group.destroy()
    return 0


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
                   metrics: MetricsRegistry | None = None,
                   profiler: Profiler | None = None, groups=None):
    """The run's executor, observed by ``tracer`` / ``metrics`` and, on the
    mesh executors, ``profiler``; with ``groups`` (``Topology.make_groups``
    of a torchrun world) the mesh executor with one worker a process.
    Raises ValueError on a configuration the reference refuses (``main``
    prints it and exits 2)."""
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
    tier1_auto = args.tier1_frac == "auto"
    kw = {}
    topology = None
    tier1_frac = None
    if args.hosts > 1:
        if args.tier1_frac is None or tier1_auto:
            tier1_frac = acceptance_sparse_frac(args.kappa, args.dim)
        else:
            try:
                tier1_frac = float(args.tier1_frac)
            except ValueError:
                raise ValueError(f"--tier1-frac must be a float or 'auto', "
                                 f"got {args.tier1_frac!r}") from None
    elastic = bool(args.resize) or _chaos_kills(args)
    if groups is not None and not elastic:
        # one worker a process: the transports over the world's groups
        from repro_torch.engine.mesh import process_transport
        topology = process_group.current().topology
        transport = process_transport(
            args.transport, groups, topology, tier1=args.tier1_transport,
            frac=args.compress_frac, tier1_frac=tier1_frac or 0.01)
        kw["group"] = groups
        topology = None if topology.is_flat else topology
    else:
        # the stacked transport; an elastic run over processes rebuilds it
        # over each worker count's groups
        if groups is not None:
            kw["group"] = process_group.world_group()
        transport = comm.get_transport(
            args.transport, **({"frac": args.compress_frac}
                               if args.transport == "sparse" else {}))
        if args.hosts > 1:
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
        # the faults reach the executors through the network model
        chaos = _chaos_schedule(args)
        network = ChaosNetwork(network, chaos, topology=topology)
        print(f"chaos: {chaos.describe()}")
    if profiler is not None:
        kw["profiler"] = profiler
    merge = "quorum" if (args.quorum or args.chaos) else args.merge
    if merge == "quorum":
        kw.update(merge=merge, quorum_frac=args.quorum_frac)
    elif merge == "dynamic":
        kw.update(merge=merge, divergence_thresh=args.divergence_thresh,
                  max_stale=args.max_stale)
    if not elastic:
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


def run_vq(args, *, groups=None, dev: torch.device | None = None):
    """Run the scheme and print the reference's report; returns
    ``(result, executor, wall_s)``.  ``groups``: one worker a process of
    the current world, on ``dev``."""
    dev = device_lib.resolve(args.device) if dev is None else dev
    autotune.set_mode(args.autotune)
    if args.autotune_cache:
        autotune.set_cache_path(args.autotune_cache)
    # either flag turns the executor's tracer and registry on
    observe = bool(args.trace or args.metrics)
    tracer = Tracer() if observe else None
    metrics = MetricsRegistry() if observe else None
    profiler = Profiler(metrics=metrics) if args.profile else None
    executor = build_executor(args, dev, tracer=tracer, metrics=metrics,
                              profiler=profiler, groups=groups)
    # one worker a process: every rank observes its run, rank 0 writes
    writer = groups is None or process_group.current().rank == 0
    # armed before the run: a run that dies still leaves its files
    flusher = None
    if observe and writer:
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
          + (f" resize={args.resize}" if args.resize else "")
          + (" one worker a process" if groups is not None else ""))
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
    if args.save_result and writer:
        torch.save({"w_shared": res.w_shared.cpu(), "distortion": curve,
                    "wall_ticks": ticks, "wall_s": wall}, args.save_result)
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
        if getattr(executor, "merge", None) == "quorum":
            print(f"  quorum: late worker-windows "
                  f"{executor.last_late_worker_windows:,}")
        if getattr(executor, "last_tier1_fracs", None):
            print(f"  tier-1 frac after each chunk: "
                  f"{executor.last_tier1_fracs}")
    if profiler is not None and writer:
        print("profile (roofline attribution):")
        print(profiler.summary_table())
        profiler.export_json(args.profile)
        print(f"profile: {len(profiler.attributions)} run(s) -> "
              f"{args.profile} (render: python -m repro_torch.obs.report "
              f"--profile {args.profile})")
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


class LmRun(NamedTuple):
    """What ``run_lm`` leaves: the final train state, the loss and grad
    norm of each step it ran (host tensors), its first step and its wall
    seconds (from a device sync to a device sync)."""
    state: dict
    losses: torch.Tensor
    grad_norms: torch.Tensor
    start: int
    wall_s: float


def run_lm(args, cfg=None, *, groups=None, dev=None) -> LmRun:
    """LM training, the reference's ``--mode lm`` block: ``cfg`` (default:
    the registry's ``--arch``, reduced with ``--smoke``) trained for
    ``--steps`` steps on ``--device`` (or ``dev``), with its checkpoints and
    resume.  ``groups``: this rank's (data, model) groups of a
    ``--data-axis`` world (``run_lm_process``), None for one process; its
    rank 0 prints and writes the checkpoints."""
    from repro_torch.distributed import sharding
    from repro_torch.models import common
    dev = device_lib.resolve(args.device) if dev is None else dev
    if cfg is None:
        cfg = (registry.get_smoke_config(args.arch) if args.smoke
               else registry.get_config(args.arch))
    sizes = (common.layout_sizes(groups) if groups is not None
             else {"data": 1, "model": 1})
    coords = (sharding.layout_coords(groups) if groups is not None
              else {"data": 0, "model": 0})
    data_group = groups.group("data") if sizes["data"] > 1 else None
    rank0 = coords["data"] == 0
    say = print if rank0 else (lambda *a, **k: None)   # rank 0 prints
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    say(f"arch={cfg.name} device={where} params={cfg.n_params():,} "
        f"mesh={sizes}")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.seed)
    opt = optimizers.adamw(optimizers.cosine_schedule(
        args.lr, warmup=20, total=args.steps))
    # the state is donated to the step, as the reference's launcher donates
    # it to its jitted step
    step_fn = steps_lib.make_train_step(cfg, opt, donate=True,
                                        data_group=data_group)
    state = steps_lib.init_train_state(cfg, opt, args.seed, device=dev)
    shape = torch.empty((args.batch, args.seq_len), device="meta")
    bspecs = sharding.batch_specs(cfg, sizes, {"tokens": shape,
                                               "labels": shape})
    ckpt = (Checkpointer(args.ckpt_dir) if args.ckpt_dir
            and (rank0 or args.resume) else None)
    start = 0
    if ckpt and args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            pspecs = sharding.param_specs(cfg, sizes, use_fsdp=False)
            specs = {"params": pspecs,
                     "opt_state": sharding.opt_specs_like(
                         pspecs, state["opt_state"]),
                     "step": sharding.P()}
            state = ckpt.restore(latest, state, device=dev,
                                 placement=sharding.Placement(specs, sizes,
                                                              coords))
            start = latest
            say(f"resumed from step {start}")
    if not rank0:
        ckpt = None                 # rank 0 writes the checkpoints
    losses, gnorms = [], []
    opts = common.get_run_options()
    held = opts.data_group
    opts.data_group = data_group    # the MoE's load-balance statistics
    try:
        device_lib.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(start, args.steps):
            # step-indexed: restartable; this rank's rows of it
            batch = sharding.local_tree(lm_batch(dcfg, i, device=dev),
                                        bspecs, sizes, coords)
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
            gnorms.append(metrics["grad_norm"])
            if (i + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                tps = ((i + 1 - start) * args.batch * args.seq_len
                       / (time.perf_counter() - t0))
                say(f"step {i + 1:5d}  loss {loss:.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.2f}  "
                    f"tok/s {tps:,.0f}")
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save_async(i + 1, state)
        if ckpt:
            ckpt.wait()
        device_lib.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        opts.data_group = held
    say(f"done: {args.steps - start} steps in {wall:.1f}s")

    def host(xs):
        return torch.stack(xs).cpu() if xs else torch.zeros(0)

    return LmRun(state, host(losses), host(gnorms), start, wall)


def run_lm_process(args) -> int:
    """LM mode over the torchrun world (joined here, or the world this
    process is already in): the first ``--data-axis`` ranks train data
    parallel, rank 0 printing; ranks past the grid take no part.  Returns
    0."""
    from repro_torch.topology import make_host_groups
    own = not process_group.in_world()
    world = (process_group.init(device=args.device) if own
             else process_group.current())
    try:
        groups = make_host_groups(data=args.data_axis)
        if groups.coords:           # rank 0 is always on the grid
            run_lm(args, groups=groups, dev=world.device)
    finally:
        if own:
            process_group.destroy()
    return 0


def lm_refusal(args) -> str | None:
    """Why LM mode cannot run these arguments, or None."""
    if registry.get_smoke_config(args.arch).family == "encdec":
        return (f"--arch {args.arch} is an encoder-decoder: the synthetic "
                f"LM pipeline draws tokens, not the encoder's frames")
    if min(args.steps, args.batch, args.seq_len, args.log_every,
           args.ckpt_every, args.data_axis) < 1:
        return ("--steps, --batch, --seq-len, --log-every, --ckpt-every "
                "and --data-axis must be >= 1")
    return None


def main(argv=None) -> int:
    device_lib.pin_full_f32()
    args = parse_args(argv)
    if args.mode == "lm":
        why = lm_refusal(args)
        if why is not None:
            if os.environ.get("RANK", "0") == "0":
                print(f"error: {why}")
            return 2
        if in_torchrun_world():
            return run_lm_process(args)
        run_lm(args)
        return 0
    if args.points < args.tau:
        print(f"error: --points {args.points} is less than one tau="
              f"{args.tau} window")
        return 2
    if args.profile and args.executor != "mesh":
        # attribution reads the mesh executors' segments; the sim oracles
        # and the threads report none
        print(f"error: --profile attributes the mesh executor's segments; "
              f"got --executor {args.executor}")
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
    if in_torchrun_world():
        why = process_refusal(args, int(os.environ["WORLD_SIZE"]))
        if why is not None:
            if os.environ["RANK"] == "0":
                print(f"error: {why}")
            return 2
    try:
        if in_torchrun_world():
            return run_process(args)
        run_vq(args)
    except ValueError as e:  # a configuration the executor refuses
        print(f"error: {e}")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
