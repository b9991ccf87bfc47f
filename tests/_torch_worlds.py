"""Rank bodies of the port's process-group tests.

Each function runs on every rank of a gloo world that
``repro_torch.distributed.process_group.spawn`` starts on a ``FileStore``
(the CPU, one thread a rank) and returns what the test holds in the
parent.  This module imports torch, numpy and the port only, so a rank
starts without JAX.  Inputs come from the parent as numpy arrays, made from
a seed there.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch.comm import ring
from repro_torch.distributed import process_group
from repro_torch.topology import (Topology, grid_groups, make_host_groups,
                                  make_production_groups, make_worker_groups)

TAU = 10


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _members(groups) -> dict:
    """The groups' own ranks (from torch.distributed) beside what
    ``Groups`` says."""
    return {"axes": groups.axes, "shape": groups.shape,
            "members": groups.members, "coords": groups.coords,
            "dist": tuple(None if g is None
                          else tuple(dist.get_process_group_ranks(g))
                          for g in groups.groups)}


def transports_and_groups(rank: int, world, xs: dict) -> dict:
    """The group ring and dense transports, and the group builders."""
    out: dict = {}
    flat = Topology.flat(world.world_size).make_groups()
    g = flat.groups[0]
    for name in ("x1000", "x1280"):
        x = _t(xs[name])
        out[f"ring_{name}"] = _np(ring.ring_all_reduce_group(x[rank], g))
        m = _t(xs["mask"])[rank:rank + 1]
        out[f"ring_{name}_masked"] = _np(
            ring.ring_all_reduce_group(x[rank], g, m))
    # M = 3: a group of the first three ranks; rank 3 has none
    g3 = grid_groups(np.arange(3), ("workers",)).groups[0]
    if g3 is not None:
        x3 = _t(xs["x3"])
        out["ring3"] = _np(ring.ring_all_reduce_group(x3[rank], g3))
        out["ring3_masked"] = _np(ring.ring_all_reduce_group(
            x3[rank], g3, _t(xs["mask3"])[rank:rank + 1]))
    x = _t(xs["x1000"])[rank:rank + 1]
    mask = _t(xs["mask"])[rank:rank + 1]
    for name, tr in (("xla", comm.XlaTransport(group=g)),
                     ("ringtr", comm.RingTransport(group=g))):
        out[f"{name}_sum"] = _np(tr.all_reduce(x)[0])
        out[f"{name}_mean"] = _np(tr.all_reduce(x, op="mean")[0])
        out[f"{name}_masked"] = _np(tr.masked_all_reduce(x, mask)[0])
        pair, _ = tr.all_reduce((x, x[:, :7] * 2.0), tag="eval")
        out[f"{name}_tuple"] = tuple(_np(p) for p in pair)
        out[f"{name}_records"] = list(tr.log.records)
    quant = comm.get_transport("quant", inner=comm.XlaTransport(group=g),
                               mode="int8")
    state = quant.init_state(x)
    got, state = quant.all_reduce(x, state=state)
    out["quant"] = _np(got)
    out["quant_residual"] = _np(state)
    out["quant_records"] = list(quant.log.records)
    out["groups_flat"] = _members(flat)
    out["groups_2x2"] = _members(Topology.simulate(2, 2).make_groups())
    out["groups_model2"] = _members(Topology.flat(4).make_groups(model=2))
    out["detect"] = Topology.detect().describe()
    out["worker_groups"] = _members(make_worker_groups(4))
    out["host_groups"] = _members(make_host_groups(data=2, model=2))
    out["host_groups_small"] = _members(make_host_groups(data=1, model=1))
    from repro_torch.distributed.elastic import RemeshPlan, build_groups
    out["build_groups"] = _members(build_groups(RemeshPlan(
        data=1, model=2, dropped_hosts=0, tp_preserved=True)))
    try:
        make_production_groups()
    except ValueError as e:
        out["production_error"] = str(e)
    v = torch.tensor([float(rank), 5.0 - rank])
    out["gather"] = _np(process_group.all_gather(v, g))
    out["min"] = _np(process_group.all_reduce(v.clone(), "min", g))
    return out


def fail_on_rank_one(rank: int, world) -> int:
    if rank == 1:
        raise RuntimeError("deliberate failure on this rank")
    return rank


def executor_runs(rank: int, world, ins: dict) -> dict:
    """Process-mode runs of ``MeshExecutor`` and its refusals."""
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import GeometricDelayNetwork, \
        InstantNetwork
    w0, data, ev = _t(ins["w0"]), _t(ins["data"]), _t(ins["eval"])
    flat = Topology.flat(4).make_groups()
    out: dict = {}

    def run(key, scheme, transport, group=flat, network=None, **kw):
        ex = MeshExecutor(network or InstantNetwork(), transport=transport,
                          group=group, device="cpu")
        res = ex.run(scheme, w0, data, ev, tau=TAU, **kw)
        out[key] = (_np(res.w_shared), _np(res.distortion),
                    _np(res.wall_ticks), ex.last_comm)

    for scheme in ("delta", "average"):
        for tr in ("xla", "ring"):
            run(f"{scheme}_{tr}", scheme, tr)
    geo = GeometricDelayNetwork(0.5)
    for tr in ("xla", "ring"):
        run(f"async_{tr}", "async_delta", tr, network=geo,
            lengths=_t(ins["lengths"]))
    # a raw ProcessGroup is a flat group too
    run("delta_ring_pg", "delta", "ring", group=flat.groups[0])
    hier = Topology.simulate(2, 2).make_groups()
    run("hier_xla", "delta", "xla", group=hier)
    run("hier_async_ring", "async_delta", "ring", group=hier, network=geo,
        lengths=_t(ins["lengths"]))
    quant = comm.get_transport("quant", inner=comm.RingTransport(
        group=flat.groups[0]), mode="int8")
    run("quant_ring", "delta", quant)
    out["cloud"] = {name: cloud_run(name, flat, hier, w0, data, ev)
                    for name in CLOUD_MODES}
    # an elastic segment over the group, its step schedule from t0
    ex = MeshExecutor(InstantNetwork(), transport="ring", group=flat,
                      device="cpu")
    seg = ex.run_segment("delta", w0, data, ev, tau=TAU, t0=SEGMENT_T0)
    out["segment"] = (_np(seg.w_shared), _np(seg.distortion),
                      _np(seg.wall_ticks), ex.last_comm)
    return out


#: The global step an elastic segment of ``executor_runs`` starts from.
SEGMENT_T0 = 30


#: The process-mode configurations ``cloud_config`` builds, each held
#: against the stacked port and the reference.
CLOUD_MODES = ("sparse", "sparse_tier1", "quorum", "dynamic0", "dynamic",
               "chaos", "tracer", "metrics", "profiler")
CLOUD_FRAC = 0.25          # the flat sparse transport's frac
CLOUD_TIER1_FRAC = 0.0625  # the sparse tier 1's
CLOUD_THRESH = 1e-4        # the dynamic merge's drift threshold
CLOUD_CHAOS = "7:kill=1,slow=1,part=1"


def cloud_config(name: str, groups=None):
    """``(network, executor keywords)`` of a cloud mode; with ``groups``
    (a flat and a 2 x 2 ``Groups``) the transports over them, else the
    stacked run's, so a test builds both from one place."""
    from repro_torch.engine.chaos import ChaosNetwork, ChaosSchedule
    from repro_torch.engine.network import GeometricDelayNetwork, \
        InstantNetwork
    from repro_torch.obs import MetricsRegistry, Profiler, Tracer
    topo = Topology.simulate(2, 2)
    flat, hier = groups if groups is not None else (None, None)
    g = None if flat is None else flat.groups[0]
    kw: dict = {}
    net = InstantNetwork()
    if name == "sparse":
        kw["transport"] = comm.SparseTransport(CLOUD_FRAC, group=g)
    elif name == "sparse_tier1":
        t0 = comm.XlaTransport(group=None if hier is None
                               else hier.group(topo.worker_axis))
        t1 = comm.SparseTransport(CLOUD_TIER1_FRAC, group=None
                                  if hier is None
                                  else hier.group(topo.host_axis))
        kw["transport"] = comm.HierarchicalTransport(t0, t1, topology=topo)
        if hier is None:
            kw["topology"] = topo
    elif name == "quorum":
        net = GeometricDelayNetwork(0.2)
        kw["merge"] = "quorum"
    elif name in ("dynamic0", "dynamic"):
        kw.update(merge="dynamic", divergence_thresh=(
            0.0 if name == "dynamic0" else CLOUD_THRESH))
    elif name == "chaos":
        net = ChaosNetwork(InstantNetwork(), ChaosSchedule.from_spec(
            CLOUD_CHAOS, windows=20, m=4, hosts=2))
        kw["merge"] = "quorum"
    else:
        # observed over the ring: its sums are the stacked ring's bits, so
        # every metric is the stacked run's
        kw["transport"] = comm.RingTransport(group=g)
        kw[name] = {"tracer": Tracer, "metrics": MetricsRegistry,
                    "profiler": Profiler}[name]()
    if groups is not None:
        kw["group"] = hier if name == "sparse_tier1" else flat
    return net, kw


def observed(ex) -> dict:
    """What an executor observed: the modeled (tick-timeline) spans and
    counters, the metrics but the run's wall, the profiler's terms."""
    from repro_torch.obs import NULL_TRACER
    out: dict = {}
    tr = ex.tracer
    if tr is not NULL_TRACER:
        out["spans"] = [(e.name, e.start_us, e.dur_us, e.track, e.attrs)
                        for e in tr.spans() if e.process == tr.TICK_PROCESS]
        out["counters"] = [(e.name, e.value, e.ts_us)
                           for e in tr.counters()]
    if ex.metrics is not None:
        out["metrics"] = [m for m in ex.metrics.snapshot()
                          if m["name"] != "run_wall_s"]
    if ex.profiler is not None:
        rec = ex.profiler.attributions[-1]
        out["profile"] = {k: rec[k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s", "m",
            "window_flops", "window_hbm_bytes",
            "collective_bytes_per_window", "workers_per_device")}
    return out


def cloud_run(name, flat, hier, w0, data, ev) -> tuple:
    """One cloud mode over the groups: (w_shared, curve, ticks, last_comm,
    trigger bits, late worker-windows, what it observed)."""
    from repro_torch.engine.mesh import MeshExecutor
    net, kw = cloud_config(name, (flat, hier))
    ex = MeshExecutor(net, device="cpu", **kw)
    res = ex.run("delta", w0, data, ev, tau=TAU)
    return (_np(res.w_shared), _np(res.distortion), _np(res.wall_ticks),
            ex.last_comm,
            None if ex.last_triggers is None else _np(ex.last_triggers),
            ex.last_late_worker_windows, observed(ex))


def lookups(rank: int, world, ins: dict) -> dict:
    """Both sharded plans, the routing and the tournament."""
    from repro_torch.serve.lookup import ShardedLookup
    g = make_worker_groups(4).groups[0]
    out: dict = {}
    z = _t(ins["z"])
    for name in ("w64", "w67", "ties"):
        w = _t(ins[name])
        for mode in ("shard_batch", "shard_kappa"):
            a, m = ShardedLookup(mode=mode, group=g, device="cpu").assign(
                z, w)
            out[f"{name}_{mode}"] = (_np(a), _np(m))
    look = ShardedLookup(group=g, device="cpu")
    out["n_shards"] = look.n_shards
    out["plans"] = (look.plan(64, 8),
                    ShardedLookup(group=g, budget_bytes=1024,
                                  device="cpu").plan(64, 8),
                    ShardedLookup(n_devices=1, group=g,
                                  device="cpu").plan(64, 8))
    a, m = look.assign(z, _t(ins["w64"]))
    out["auto"] = (_np(a), _np(m))
    errors = {}
    for name, fn in (
            ("batch", lambda: ShardedLookup(mode="shard_kappa", group=g,
                                            device="cpu").assign(
                z[:6], _t(ins["w64"]))),
            ("n_devices", lambda: ShardedLookup(n_devices=3, group=g,
                                                device="cpu")),
            ("mode", lambda: ShardedLookup(mode="psum", group=g,
                                           device="cpu"))):
        try:
            fn()
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def dvq_steps(rank: int, world, ins: dict) -> dict:
    """``core.dvq`` over the world: the window step per rank, and the
    minibatch step over (data 2, model 2)."""
    from repro_torch.core import dvq
    flat = make_worker_groups(4)
    w, zwin = _t(ins["w"]), _t(ins["zwin"])
    out: dict = {}
    for tr in ("xla", "ring"):
        step = dvq.make_window_vq_step(tau=TAU, group=flat.groups[0],
                                       transport=tr)
        w1, t1 = step(w, 7, zwin[rank:rank + 1])
        w2, t2 = step(w1, t1, _t(ins["zwin2"])[rank:rank + 1])
        out[f"window_{tr}"] = (_np(w1), _np(w2), t2,
                               list(step.transport.log.records))
    grid = Topology.flat(4).make_groups(model=2)
    data_g, model_g = grid.group("data"), grid.group("model")
    z = _t(ins["z"])
    rows = z.shape[0] // 2
    zl = z[grid.index("data") * rows:(grid.index("data") + 1) * rows]
    k_local = w.shape[0] // 2
    wl = w[grid.index("model") * k_local:(grid.index("model") + 1) * k_local]
    step = dvq.make_minibatch_vq_step(data_group=data_g, model_group=model_g)
    counts, zsum, assign = step.stats(wl, zl)
    w_new, t = step(wl, 3, zl)
    out["minibatch"] = (grid.index("data"), grid.index("model"),
                        _np(counts), _np(zsum), _np(assign), _np(w_new), t)
    return out


def launcher(rank: int, world, argvs: list, vq_sizes: tuple) -> dict:
    """``launch.train.main`` and the ``paper_vq`` dry run under a
    torchrun-like environment, each call's output captured."""
    from repro_torch.launch import dryrun, train
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world.world_size),
                      LOCAL_RANK=str(rank))
    out = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = train.main(argv)
        out.append((code, buf.getvalue()))
    dryrun.VQ_KAPPA, dryrun.VQ_D, dryrun.VQ_TAU, dryrun.VQ_BATCH = vq_sizes
    for argv in (["--arch", "paper_vq", "--device", "cpu"],
                 ["--arch", "paper_vq", "--shape", "vq_batch", "--model",
                  "2", "--device", "cpu"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = dryrun.main(argv)
        out.append((code, buf.getvalue()))
    return out


def cloud_checks(rank: int, world, ins: dict) -> dict:
    """The cloud setting's pieces over a 4-rank world: the sparse
    transport and its hierarchical tier 1 call by call, the quorum's
    count, the dynamic merge's triggers, the tier-1 controller and eq. 9
    over the sparse transport."""
    from repro_torch.engine import merge as merge_lib
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (FixedLatencyNetwork,
                                            GeometricDelayNetwork,
                                            InstantNetwork,
                                            Tier1BudgetController)
    flat = Topology.flat(world.world_size).make_groups()
    g = flat.groups[0]
    out: dict = {"ranks_per_device": process_group.ranks_per_device()}
    xs = [_t(a)[rank:rank + 1] for a in ins["xs"]]
    mask = _t(ins["mask"])[rank:rank + 1]
    # three calls of the sparse transport, its residual threaded: plain,
    # masked, and a tuple payload
    for name, frac in (("sparse", ins["frac"]), ("lossless", 1.0)):
        tr = comm.SparseTransport(frac, group=g)
        state = tr.init_state(xs[0])
        sums = []
        for i, x in enumerate(xs):
            if i == 1:
                y, state = tr.masked_all_reduce(x, mask, state=state)
            else:
                y, state = tr.all_reduce(x, state=state)
            sums.append(_np(y))
        pair, _ = tr.all_reduce((xs[0], xs[1][:, :5] * 2.0))
        out[name] = (sums, _np(state), tuple(_np(p) for p in pair),
                     list(tr.log.records))
    # a sparse tier 1 over the host groups of a 2 x 2 grid, tier 0 the ring
    topo = Topology.simulate(2, 2)
    hg = topo.make_groups()
    hier = comm.HierarchicalTransport(
        comm.RingTransport(group=hg.group(topo.worker_axis)),
        comm.SparseTransport(ins["frac"], group=hg.group(topo.host_axis)),
        topology=topo)
    state = hier.init_state(xs[0])
    sums = []
    for i, x in enumerate(xs):
        if i == 1:
            y, state = hier.masked_all_reduce(x, mask, state=state)
        else:
            y, state = hier.all_reduce(x, state=state)
        sums.append(_np(y))
    out["hier"] = (sums, _np(state["t1"]), list(hier.log.records))
    # the quorum: 2 of 4 arrive, and 0.75 of 4 is 3
    w0 = _t(ins["w0"])
    w_local = _t(ins["w_local"])[rank:rank + 1]
    q = merge_lib.QuorumMerge(comm.XlaTransport(group=g), quorum_frac=0.75)
    late = torch.tensor([float(rank % 2)])
    merged, _ = q(w0, w_local, state=q.init_state(w_local), late=late)
    out["quorum"] = (q.quorum(q.transport.workers(w_local)), _np(merged))
    data, ev = _t(ins["data"]), _t(ins["eval"])
    # the dynamic merge's trigger bits, read on every rank
    ex = MeshExecutor(InstantNetwork(), merge="dynamic",
                      divergence_thresh=ins["thresh"], group=flat,
                      device="cpu")
    ex.run("delta", w0, data, ev, tau=TAU)
    out["triggers"] = _np(ex.last_triggers)
    # the tier-1 controller over a sparse tier 1, chunks of 5 windows
    net = FixedLatencyNetwork(latency_ticks=1, dcn_bytes_per_tick=64)
    ex = MeshExecutor(net, transport=comm.HierarchicalTransport(
        comm.XlaTransport(group=hg.group(topo.worker_axis)),
        comm.SparseTransport(0.5, group=hg.group(topo.host_axis)),
        topology=topo), tier1_controller=Tier1BudgetController(net),
        publish_every=5, group=hg, device="cpu")
    res = ex.run("delta", w0, data, ev, tau=TAU)
    out["controller"] = (list(ex.last_tier1_fracs), _np(res.w_shared),
                         ex.last_comm)
    # eq. 9 over the lossless sparse transport
    ex = MeshExecutor(GeometricDelayNetwork(0.5),
                      transport=comm.SparseTransport(ins["eq9_frac"],
                                                     group=g),
                      group=flat, device="cpu")
    res = ex.run("async_delta", w0, data, ev, tau=TAU,
                 lengths=_t(ins["lengths"]))
    out["eq9"] = (_np(res.w_shared), _np(res.distortion),
                  _np(res.wall_ticks), ex.last_comm)
    return out


# -- elastic runs and serving over processes ------------------------------------

#: The elastic runs' schedule: 4 -> 2 -> 4 (and, over 2 hosts of 2 ranks,
#: whole host groups leave and return).
ELASTIC_SCHEDULE = ((20, 2), (40, 4))
#: Periodic checkpoints every 10 windows: 30 falls inside the shrunk
#: segment, with ranks 2-3 idle until the grow at 40.
ELASTIC_EVERY = 10
#: The steps a resume starts from: both resizes and the periodic one.
ELASTIC_RESUMES = (20, 30, 40)
#: A kill of worker 1 at window 10 shrinks 4 -> 3; the late row of index 1
#: stays with the survivor that holds it (the reference's quirk).
ELASTIC_CHAOS = ((10, "kill", 1), (14, "slow", 0, 3), (30, "partition", 0, 2))
ELASTIC_FRAC = 1.0 / 32.0   # the sparse tier 1 of the host-group run


def _result(ex, res) -> tuple:
    return (_np(res.w_shared), _np(res.distortion), _np(res.wall_ticks),
            ex.last_comm,
            [(e.window, e.old_m, e.new_m, e.late_points, e.cause,
              e.checkpoint_step) for e in ex.resize_events],
            ex.last_late_worker_windows)


def elastic_config(name: str):
    """``(schedule, executor keywords)`` of an elastic run over 4 workers,
    stacked; ``elastic_runs`` runs each over the world."""
    from repro_torch.engine import ChaosNetwork, ChaosSchedule, \
        InstantNetwork
    if name == "chaos":
        sched = ChaosSchedule(ELASTIC_CHAOS, hosts=2)
        return (), {"network": ChaosNetwork(InstantNetwork(), sched),
                    "chaos": sched, "merge": "quorum"}
    if name == "hosts":
        topo = Topology.from_spec(4, hosts=2)
        return ELASTIC_SCHEDULE, {
            "topology": topo, "transport": comm.HierarchicalTransport(
                "xla", comm.SparseTransport(ELASTIC_FRAC), topology=topo)}
    return ELASTIC_SCHEDULE, {}


def elastic_runs(rank: int, world, ins: dict, ckdir: str) -> dict:
    """``ElasticMeshExecutor`` over the world: the 4 -> 2 -> 4 run with
    its checkpoints (rank 0 writes them under ``ckdir/flat``), a resume
    from each, a resume from the reference's checkpoint in
    ``ckdir/ref``, a chaos kill and whole host groups."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.engine import ElasticMeshExecutor
    w0, data, ev = _t(ins["w0"]), _t(ins["data"]), _t(ins["eval"])
    g = process_group.world_group()
    out: dict = {}

    def run(key, name="flat", **kw):
        sched, cfg = elastic_config(name)
        ex = ElasticMeshExecutor(sched, group=g, device="cpu", **cfg, **kw)
        out[key] = _result(ex, ex.run("delta", w0, data, ev, tau=TAU))

    run("flat", checkpointer=Checkpointer(os.path.join(ckdir, "flat"),
                                          keep=10),
        checkpoint_every=ELASTIC_EVERY)
    for step in ELASTIC_RESUMES:
        # a directory holding only that step: a resume restores the latest
        where = os.path.join(ckdir, f"resume_{step}")
        if rank == 0:
            name = f"step_{step:09d}"
            shutil.copytree(os.path.join(ckdir, "flat", name),
                            os.path.join(where, name))
        process_group.barrier(g)
        run(f"resume_{step}", checkpointer=Checkpointer(where), resume=True)
    run("from_ref", checkpointer=Checkpointer(os.path.join(ckdir, "ref")),
        resume=True)
    run("chaos", "chaos")
    run("hosts", "hosts")
    return out


def _served(futures) -> tuple:
    """The responses' assignments, min distances and versions, or the
    exception of each future that failed."""
    got = []
    for f in futures:
        try:
            got.append(f.result(timeout=60))
        except Exception as e:  # noqa: BLE001 - the test reads it
            got.append(e)
    return got


def serve_runs(rank: int, world, ins: dict, argvs: list) -> dict:
    """``QuantizeService`` over the world under both sharded plans (rank 0
    serves, the others follow), a codebook published mid-load; a lookup
    that raises on rank 2; then ``launch.serve.main`` under a torchrun-like
    environment."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import (CodebookStore, QuantizeService,
                                   ShardedLookup, follow)
    g = process_group.world_group()
    out: dict = {}
    queries = [_t(q).numpy() for q in ins["queries"]]
    half = len(queries) // 2

    def leg(key, mode, publish=True):
        lookup = ShardedLookup(mode=mode, group=g, device="cpu")
        if rank:
            out[key] = follow(lookup)
            return
        # every call's padded batch, codebook and result, held against the
        # direct plan on the same arguments
        calls, assign = [], lookup.assign

        def recorded(z, w):
            a, m = assign(z, w)
            calls.append((_np(z), _np(w), _np(a), _np(m)))
            return a, m

        lookup.assign = recorded
        store = CodebookStore(ins["w"], device="cpu")
        with QuantizeService(store, lookup, max_delay_s=1e-3) as svc:
            got = _served([svc.submit(q) for q in queries[:half]])
            if publish:
                store.publish(ins["w2"])
            got += _served([svc.submit(q) for q in queries[half:]])
        out[key] = (got, svc.stats, svc.batch_align, svc.max_batch, calls)

    for mode in ("auto", "shard_batch", "shard_kappa"):
        leg(mode, mode)
    # rank 2's kernel raises on its third call: the first flush after the
    # two warm-ups
    real, calls = ops.vq_assign, [0]

    def flaky(z, w):
        calls[0] += 1
        if rank == 2 and calls[0] == 3:
            raise RuntimeError("deliberate kernel failure on this rank")
        return real(z, w)

    ops.vq_assign = flaky
    try:
        leg("failing", "shard_kappa", publish=False)
    finally:
        ops.vq_assign = real
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world.world_size),
                      LOCAL_RANK=str(rank))
    runs = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = serve.main(argv)
        runs.append((code, buf.getvalue()))
    out["launcher"] = runs
    return out


# -- the LM's placement over processes -----------------------------------------

def _tree_np(tree):
    """A tree of tensors as numpy arrays (f32 for floats)."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree.float() if tree.is_floating_point() else tree)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


def shard_round_trips(rank: int, world, ins: dict) -> dict:
    """Every rank's ``local_shard`` of each leaf on a (2, 2) (data, model)
    grid, gathered back with ``gather_shards``."""
    from repro_torch.distributed import sharding
    groups = grid_groups(np.arange(4).reshape(2, 2), ("data", "model"))
    sizes = dict(zip(groups.axes, groups.shape))
    coords = sharding.layout_coords(groups)
    out = {}
    for name, (x, spec) in ins.items():
        spec = sharding.P(*spec)
        local = sharding.local_shard(_t(x), spec, sizes, coords)
        out[name] = (_np(local), _np(sharding.gather_shards(local, spec,
                                                            groups)))
    return out


def _ep_config(name: str):
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_smoke_config(name),
                               dtype=torch.float32)


def moe_ep_runs(rank: int, world, ins: dict) -> dict:
    """Expert parallelism over a (1, 2) (data, model) grid: layer 0's
    ``moe_apply_ep`` on ``ins["x"]`` and its grads under the cotangent
    ``ins["r"]``, and the whole smoke model's loss, logits and grads with
    ``RunOptions.moe_ep``; this rank's experts only."""
    from repro_torch.distributed import sharding
    from repro_torch.models import blocks, common
    from repro_torch.models.api import get_api
    from repro_torch.training import steps
    cfg = _ep_config("olmoe_1b_7b")
    groups = grid_groups(np.arange(2).reshape(1, 2), ("data", "model"))
    g = groups.group("model")
    params = sharding.moe_ep_params(cfg, _tree_t(ins["params"]), groups)
    p0 = common.layer_slice(params["blocks"], 0)
    x = _t(ins["x"]).requires_grad_()
    leaves = {k: p0[k].detach().requires_grad_()
              for k in ("router", "w_gate", "w_up", "w_down")}
    y = blocks.moe_apply_ep(cfg, leaves, x, g)
    grads = torch.autograd.grad((y * _t(ins["r"])).sum(),
                                [x, *leaves.values()])
    out = {"y": _np(y), "grads": [_np(t) for t in grads],
           "shard": {k: _np(params["blocks"][k])
                     for k in ("w_gate", "w_up", "w_down")}}
    batch = _tree_t(ins["batch"])
    common.set_run_options(moe_ep=True, model_group=g)
    try:
        loss, grads = steps.loss_and_grads(get_api(cfg).loss_fn, params,
                                           batch)
        with torch.no_grad():
            logits = get_api(cfg).forward(params, batch)
    finally:
        common.set_run_options(moe_ep=False, model_group=None)
    out.update(loss=float(loss), logits=_np(logits), model_grads=_tree_np(
        grads))
    return out


def pipeline_runs(rank: int, world, ins: dict) -> dict:
    """GPipe over a (2, 1, 1) (pod, data, model) grid: the pipelined loss
    and grads of the granite smoke model, this rank's stage."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.training import pipeline, steps
    cfg = dataclasses.replace(registry.get_smoke_config("granite_8b"),
                              dtype=torch.float32, n_layers=ins["layers"])
    groups = grid_groups(np.arange(2).reshape(2, 1, 1),
                         ("pod", "data", "model"))
    out = {}
    for n_micro in ins["n_micro"]:
        loss_fn = pipeline.make_pp_loss_fn(cfg, groups, n_micro=n_micro)
        params = pipeline.stage_params(_tree_t(ins["params"]), groups)
        loss, grads = steps.loss_and_grads(loss_fn, params,
                                           _tree_t(ins["batch"]))
        out[n_micro] = {"loss": float(loss), "grads": _tree_np(grads),
                        "records": list(loss_fn.transport.log.records)}
    return out


def lm_data_parallel(rank: int, world, ins: dict) -> dict:
    """``launch.train``'s LM mode over this world: ``run_lm`` on the (2, 1)
    grid for each config named, then the launcher itself under a
    torchrun-like environment (a straight run with checkpoints, its
    resume, a grid of one rank beside an idle one)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.topology import make_host_groups
    groups = make_host_groups(data=2)
    out: dict = {}
    for arch in ins["archs"]:
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  dtype=torch.float32)
        args = train.parse_args(ins["argv"] + ["--arch", arch])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run = train.run_lm(args, cfg=cfg, groups=groups,
                               dev=torch.device("cpu"))
        out[arch] = {"losses": _np(run.losses), "gnorms": _np(run.grad_norms),
                     "params": _tree_np(run.state["params"]),
                     "log": buf.getvalue()}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world.world_size),
                      LOCAL_RANK=str(rank))
    runs = []
    for argv in ins["launcher"]:
        if argv == "drop":   # a crash: rank 0 moves the last step aside
            dist.barrier()
            if rank == 0:
                import shutil
                shutil.move(ins["drop"], ins["keep"])
            dist.barrier()
            continue
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = train.main(argv)
        runs.append((code, buf.getvalue()))
    out["launcher"] = runs
    return out


# -- the placement as a program: tensor, sequence and FSDP parallelism ---------

#: the layouts of the tensor-parallel world of 4 ranks: (data, model) grids;
#: (1, 2) twice, on ranks 0-1 and 2-3
TP_GRIDS = {"1x2": (np.arange(2).reshape(1, 2), np.arange(2, 4).reshape(1, 2)),
            "1x4": (np.arange(4).reshape(1, 4),),
            "2x2": (np.arange(4).reshape(2, 2),)}


def _tp_layouts() -> dict:
    """This rank's groups on each layout of ``TP_GRIDS`` (every rank makes
    every grid's groups, in the same order)."""
    out = {}
    for name, grids in TP_GRIDS.items():
        for grid in grids:
            groups = grid_groups(grid, ("data", "model"))
            if groups.coords:
                out[name] = groups
    return out


#: the layouts of the bf16 loss, where the vocabulary does not split:
#: (data 2, model 1), on ranks 0-1 and 2-3
BF16_GRIDS = (np.arange(2).reshape(2, 1), np.arange(2, 4).reshape(2, 1))


def _greedy(api, params, batch: dict, max_len: int, steps_n: int):
    """Greedy tokens: the prompt's last logits (``api.prefill``; the
    encoder-decoder's cache from its frames and its first token from the
    forward's last position), then ``steps_n`` decode steps over the cache.
    Returns the tokens, the bytes by kind of the collectives of the
    prefill and of the first decode step, and the cache."""
    with torch.no_grad():
        with process_group.record_collectives() as pre:
            logits, cache = api.prefill(params, batch, max_len)
        toks = [logits.argmax(-1)]
        dec = None
        for _ in range(steps_n):
            with process_group.record_collectives() as log:
                logits, cache = api.decode_step(params, cache,
                                                toks[-1][:, None])
            dec = log.bytes_by_kind() if dec is None else dec
            toks.append(logits[:, 0].argmax(-1))
    return torch.stack(toks, 1), pre.bytes_by_kind(), dec, cache


def _past_the_cache(api, params, cache: dict, max_len: int) -> bool:
    """Does a decode step at ``cur_len`` = ``max_len`` (no position of the
    whole cache left) raise ValueError?"""
    tokens = torch.zeros((cache["ssm" if "ssm" in cache else "k"].shape[1],
                          1), dtype=torch.int32)
    try:
        with torch.no_grad():
            api.decode_step(params, {**cache, "cur_len": max_len}, tokens)
    except ValueError:
        return True
    return False


def tensor_parallel_runs(rank: int, world, ins: dict) -> dict:
    """Each smoke config of ``ins["archs"]`` (f32, the reference's init) on
    each layout of ``TP_GRIDS``, FSDP off and on, this rank's shards: the
    loss and the synced grads (``steps.sync_grads``) of the placed loss, its
    logits, and the collectives recorded over the loss, the sync and the
    clip; then greedy decoding on the sequence-split cache (FSDP off), the
    collectives of its prefill and of its first decode step, and whether a
    step past the cache raises.  Last, each config's loss in bf16 on the
    (data 2, model 1) layouts of ``BF16_GRIDS``, this rank's rows."""
    import dataclasses

    from repro_torch.distributed import sharding
    from repro_torch.models import common
    from repro_torch.models.api import get_api
    from repro_torch.training import steps
    layouts = _tp_layouts()
    out: dict = {}
    for arch in ins["archs"]:
        cfg = _ep_config(arch)
        api = get_api(cfg)
        params = _tree_t(ins["params"][arch])
        batch = _tree_t(ins["batch"][arch])
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        for name, groups in layouts.items():
            sizes = common.layout_sizes(groups)
            coords = sharding.layout_coords(groups)
            local_batch = sharding.local_tree(
                batch, sharding.batch_specs(cfg, sizes, batch), sizes, coords)
            local_prompt = {k: v for k, v in local_batch.items()
                            if k != "labels"}
            for fsdp in (False, True):
                specs = sharding.param_specs(cfg, sizes, use_fsdp=fsdp)
                local = sharding.local_tree(params, specs, sizes, coords)
                common.set_run_options(layout=groups, fsdp=fsdp)
                try:
                    with process_group.record_collectives() as log:
                        loss, grads = steps.loss_and_grads(api.loss_fn, local,
                                                           local_batch)
                        pl = common.placement(cfg)
                        loss, grads = steps.sync_grads(pl, loss, grads)
                        steps.clip_placed(pl, grads, 1.0)
                    with torch.no_grad():
                        logits = api.forward(local, local_batch)
                    run = {"coords": coords, "sizes": sizes,
                           "loss": float(loss), "grads": _tree_np(grads),
                           "logits": _np(logits),
                           "bytes": log.bytes_by_kind()}
                    if not fsdp:
                        toks, pre, dec, cache = _greedy(
                            api, local, local_prompt, ins["max_len"],
                            ins["decode_steps"])
                        run.update(tokens=_np(toks), prefill_bytes=pre,
                                   decode_bytes=dec,
                                   past_the_cache=_past_the_cache(
                                       api, local, cache, ins["max_len"]))
                finally:
                    common.set_run_options(layout=None, fsdp=False)
                out[(arch, name, fsdp)] = run
        del prompt
    # the bf16 loss where the vocabulary does not split: each rank's rows
    for grid in BF16_GRIDS:
        groups = grid_groups(grid, ("data", "model"))
        if not groups.coords:
            continue
        sizes = common.layout_sizes(groups)
        coords = sharding.layout_coords(groups)
        for arch in ins["archs"]:
            cfg = dataclasses.replace(_ep_config(arch), dtype=torch.bfloat16)
            params = as_dtypes(cfg, _tree_t(ins["params"][arch]))
            batch = _tree_t(ins["batch"][arch])
            local = sharding.local_tree(
                params, sharding.param_specs(cfg, sizes, use_fsdp=False),
                sizes, coords)
            local_batch = sharding.local_tree(
                batch, sharding.batch_specs(cfg, sizes, batch), sizes, coords)
            common.set_run_options(layout=groups)
            try:
                with torch.no_grad():
                    loss = get_api(cfg).loss_fn(local, local_batch)
            finally:
                common.set_run_options(layout=None)
            out[(arch, "bf16", coords["data"])] = {
                "coords": coords, "sizes": sizes, "loss": float(loss)}
    return out


def as_dtypes(cfg, params: dict) -> dict:
    """``params`` with each leaf cast to the dtype ``cfg``'s init gives it
    (in bf16: the weights bf16, the norms and the SSM's scalars f32)."""
    from repro_torch.models.api import get_api
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda x, m: x.to(m.dtype), params,
                    get_api(cfg).init(0, device="meta"))
