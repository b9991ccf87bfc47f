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
    refusals = {}
    from repro_torch.engine.chaos import ChaosNetwork, ChaosSchedule
    from repro_torch.obs import MetricsRegistry, Profiler, Tracer
    chaos = ChaosNetwork(InstantNetwork(), ChaosSchedule.from_spec(
        "7:slow=1", windows=20, m=4, hosts=2))
    cases = {"sparse": dict(transport="sparse"),
             "quorum": dict(merge="quorum"),
             "dynamic": dict(merge="dynamic"),
             "tracer": dict(tracer=Tracer()),
             "metrics": dict(metrics=MetricsRegistry()),
             "profiler": dict(profiler=Profiler()),
             "chaos": dict(network=chaos)}
    for name, kw in cases.items():
        try:
            MeshExecutor(**{"network": InstantNetwork(), **kw},
                         group=flat, device="cpu")
        except ValueError as e:
            refusals[name] = str(e)
    try:
        MeshExecutor(InstantNetwork(), group=flat,
                     device="cpu").run_segment("delta", w0, data, ev,
                                               tau=TAU)
    except ValueError as e:
        refusals["elastic"] = str(e)
    try:
        comm.HierarchicalTransport(comm.XlaTransport(group=hier.groups[1]),
                                   "sparse", topology=Topology.simulate(2, 2))
    except ValueError as e:
        refusals["sparse_tier1"] = str(e)
    out["refusals"] = refusals
    return out


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
