"""The port's elastic executor (``repro_torch.engine.elastic``) held against
``repro.engine.elastic`` and ``repro.distributed.elastic``, mirroring
``tests/test_elastic.py`` and the host-group resizes of
``tests/test_topology.py``.

Inputs are made with numpy from a seed and handed to both packages; runs
agree with the reference's at ``rtol=1e-4, atol=1e-6``, with equal resize
events and exact ``CommLog`` bytes (the late deltas' included).  Within the
port, bit for bit: a schedule that never fires is the plain mesh run, a
hierarchical run with dense tiers is the flat elastic run, and a resumed
run is the suffix of the run that wrote the checkpoint.  The closeness to
the fixed-M oracle is statistical, so that check takes the reference
test's own inputs (``repro.data.synthetic`` from ``PRNGKey(42)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import HierarchicalTransport as JHier
from repro.data import synthetic as jsynthetic
from repro.distributed import elastic as jelastic
from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import InstantNetwork as JInstant
from repro.topology import Topology as JTopology
from repro_torch import comm, interop
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import schemes
from repro_torch.distributed import elastic as elastic_lib
from repro_torch.engine import (ElasticMeshExecutor, InstantNetwork,
                                ResizeSchedule, Topology, get_executor)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU, D, KAPPA = 10, 8, 16
RTOL, ATOL = 1e-4, 1e-6
FRAC_Q = 1.0 / 32.0     # acceptance_sparse_frac(16, 8): 4 of 128 entries


def _setup(m, n=600, seed=42, n_eval=200):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _port(w0, data, eval_data):
    return interop.from_reference(w0, data, eval_data, device="cpu")


def _elastic(schedule, **kw):
    kw.setdefault("network", InstantNetwork())
    return ElasticMeshExecutor(schedule, device="cpu", **kw)


def _events(ex):
    return [(e.window, e.old_m, e.new_m, e.late_points, e.cause)
            for e in ex.resize_events]


def _held(got, ref):
    np.testing.assert_allclose(got.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.w_shared.numpy(), np.asarray(ref.w_shared),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.wall_ticks.numpy(),
                                  np.asarray(ref.wall_ticks))


def _same(a, b):
    return (torch.equal(a.distortion, b.distortion)
            and torch.equal(a.w_shared, b.w_shared)
            and torch.equal(a.wall_ticks, b.wall_ticks))


# ---------------------------------------------------------------------------
# ResizeSchedule, the factory, plan_remesh, merge_late_delta
# ---------------------------------------------------------------------------

def test_resize_schedule_parse_and_validate():
    s = ResizeSchedule.parse("20:4, 40:8")
    assert [(e.window, e.new_m) for e in s] == [(20, 4), (40, 8)]
    assert len(s) == 2 and len(ResizeSchedule([(5, 2)])) == 1
    with pytest.raises(ValueError, match="bad resize spec"):
        ResizeSchedule.parse("20-4")
    with pytest.raises(ValueError, match="empty resize spec"):
        ResizeSchedule.parse(" , ")
    for bad, msg in (([(20, 4), (20, 8)], "strictly increasing"),
                     ([(40, 4), (20, 8)], "strictly increasing"),
                     ([(0, 4)], "window must be >= 1"),
                     ([(10, 0)], "M must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            ResizeSchedule(bad)


def test_elastic_factory_and_validation():
    ex = get_executor("elastic", schedule="10:2", device="cpu")
    assert ex.name == "elastic"
    assert [(e.window, e.new_m) for e in ex.schedule] == [(10, 2)]
    assert [(e.window, e.new_m) for e in get_executor(
        "elastic", schedule=[(3, 1)], device="cpu").schedule] == [(3, 1)]
    with pytest.raises(ValueError, match="schedule"):
        get_executor("elastic")
    with pytest.raises(ValueError, match="late_policy"):
        ElasticMeshExecutor([(10, 2)], late_policy="teleport", device="cpu")
    with pytest.raises(ValueError, match="resume=True needs a checkpointer"):
        ElasticMeshExecutor([(10, 2)], resume=True, device="cpu")
    with pytest.raises(ValueError, match="max_workers"):
        ElasticMeshExecutor([], max_workers=0, device="cpu")
    with pytest.raises(ValueError, match="merge"):
        ElasticMeshExecutor([], merge="dynamic", device="cpu")
    with pytest.raises(ValueError, match="differs"):
        ElasticMeshExecutor([], topology=Topology.from_spec(8, hosts=4),
                            transport=comm.HierarchicalTransport(
                                "xla", "xla",
                                topology=Topology.from_spec(8, hosts=2)),
                            device="cpu")
    w0, data, eval_data = _port(*_setup(1, n=100))
    with pytest.raises(ValueError, match="async_delta"):
        ex.run("async_delta", w0, data, eval_data, tau=TAU)
    with pytest.raises(ValueError, match="unknown scheme"):
        ex.run("gossip", w0, data, eval_data, tau=TAU)
    with pytest.raises(ValueError, match=r"\(M, n, d\)"):
        ex.run("delta", w0, data[0], eval_data, tau=TAU)
    with pytest.raises(ValueError, match="at least one"):
        ex.run("delta", w0, data[:, :5], eval_data, tau=TAU)


@pytest.mark.parametrize("n,prev_data,prev_model", [
    (1, 8, 1), (1, 2, 4), (6, 8, 1), (7, 4, 2), (12, 4, 4), (3, 2, 4),
    (8, 8, 1), (5, 1, 8), (0, 4, 1)])
def test_plan_remesh_equals_reference(n, prev_data, prev_model):
    got = elastic_lib.plan_remesh(n, prev_data=prev_data,
                                  prev_model=prev_model)
    want = jelastic.plan_remesh(n, prev_data=prev_data,
                                prev_model=prev_model)
    assert (got.data, got.model, got.dropped_hosts, got.tp_preserved) == (
        want.data, want.model, want.dropped_hosts, want.tp_preserved)


@pytest.mark.parametrize("delay,gamma", [(0, 0.5), (1, 0.5), (3, 1.0)])
def test_merge_late_delta_equals_reference(delay, gamma):
    rng = np.random.default_rng(delay)
    w = rng.standard_normal((KAPPA, D)).astype(np.float32)
    dl = rng.standard_normal((KAPPA, D)).astype(np.float32)
    got = elastic_lib.merge_late_delta(torch.from_numpy(w),
                                       torch.from_numpy(dl),
                                       delay_windows=delay, gamma=gamma)
    want = jelastic.merge_late_delta(jnp.asarray(w), jnp.asarray(dl),
                                     delay_windows=delay, gamma=gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    # trees: a dict and a tuple, and the dtype of w kept (bf16)
    wt = {"a": torch.from_numpy(w), "b": torch.from_numpy(w).bfloat16()}
    out = elastic_lib.merge_late_delta(
        wt, {"a": torch.from_numpy(dl), "b": torch.from_numpy(dl)},
        delay_windows=delay, gamma=gamma)
    assert torch.equal(out["a"], got) and out["b"].dtype == torch.bfloat16
    pair = elastic_lib.merge_late_delta(
        (torch.from_numpy(w),), (torch.from_numpy(dl),),
        delay_windows=delay, gamma=gamma)
    assert isinstance(pair, tuple) and torch.equal(pair[0], got)


def test_record_host_transfer_and_regroup_share_one_log():
    topo = Topology.from_spec(8, hosts=2)
    hier = comm.HierarchicalTransport("xla", "sparse", topology=topo)
    small = hier.regroup(Topology.from_spec(4, hosts=1))
    assert small.log is hier.log and small.tier1 is hier.tier1
    assert small.topology.describe() == "1x4" and hier.topology is topo
    hier.record_host_transfer(logical_bytes=512, wire_bytes=512,
                              participants=4, tier=1)
    small.all_reduce(torch.ones(4, 3), op="sum")
    out = comm.CommLog.summarize(hier.log.records)
    assert out["by_tag"]["late_delta"] == {
        "calls": 1, "logical_bytes": 512, "wire_bytes": 512,
        "by_tier": {1: {"calls": 1, "logical_bytes": 512,
                        "wire_bytes": 512}}}
    assert hier.log.records[0].op == "host"
    assert out["by_tag"]["merge"]["by_tier"] == {0: {
        "calls": 1, "logical_bytes": 12,
        "wire_bytes": comm.ring_wire_bytes(12, 4)}}


# ---------------------------------------------------------------------------
# elastic runs against the plain mesh, the reference and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["delta", "average"])
def test_no_event_is_the_plain_mesh_run_bitwise(scheme):
    args = _port(*_setup(8))
    ex = _elastic([(10_000, 4)])
    got = ex.run(scheme, *args, tau=TAU)
    pex = MeshExecutor(InstantNetwork(), device="cpu")
    plain = pex.run(scheme, *args, tau=TAU)
    assert _same(got, plain) and ex.resize_events == []
    assert ex.last_comm == pex.last_comm


@pytest.fixture(scope="module")
def ref_848():
    w0, data, eval_data = _setup(8)
    ex = JElastic([(20, 4), (40, 8)], network=JInstant())
    return ex.run("delta", w0, data, eval_data, tau=TAU), ex


def test_8_4_8_matches_the_reference(ref_848):
    ref, jex = ref_848
    ex = _elastic([(20, 4), (40, 8)])
    got = ex.run("delta", *_port(*_setup(8)), tau=TAU)
    _held(got, ref)
    assert _events(ex) == _events(jex) == [(20, 8, 4, 40, "schedule"),
                                           (40, 4, 8, 0, "schedule")]
    assert ex.last_comm == jex.last_comm
    assert ex.last_comm["by_tag"]["late_delta"]["wire_bytes"] == (
        4 * KAPPA * D)
    assert len(got.distortion) > 60    # M=4 windows use half the points
    assert bool((got.wall_ticks[1:] > got.wall_ticks[:-1]).all())


def test_8_4_8_within_1e2_of_the_fixed_m_oracle():
    kd, kw = jax.random.split(jax.random.PRNGKey(42))
    data = jsynthetic.replicate_stream(kd, 8, n=600, d=D)
    w0 = jsynthetic.kmeanspp_init(kw, data.reshape(-1, D), KAPPA)
    args = _port(w0, data, data[:, :200])
    oracle = schemes.scheme_delta(*args, tau=TAU)
    got = _elastic([(20, 4), (40, 8)]).run("delta", *args, tau=TAU)
    np.testing.assert_allclose(float(got.distortion[-1]),
                               float(oracle.distortion[-1]), rtol=1e-2)


def test_shrink_to_single_worker():
    ex = _elastic([(10, 1)])
    res = ex.run("delta", *_port(*_setup(4, n=400)), tau=TAU)
    assert ex.resize_events[0].new_m == 1
    assert float(res.distortion[-1]) < float(res.distortion[0])
    assert len(res.distortion) == 10 + (4 * 400 - 10 * 4 * TAU
                                        - 3 * TAU) // TAU


def test_grow_clamps_to_max_workers():
    ex = _elastic([(10, 64)], max_workers=8)
    res = ex.run("delta", *_port(*_setup(4, n=400)), tau=TAU)
    assert ex.resize_events[0].new_m == 8
    assert float(res.distortion[-1]) < float(res.distortion[0])
    ex = _elastic([(10, 64)])          # no cap: the card holds any M
    ex.run("delta", *_port(*_setup(4, n=400)), tau=TAU)
    assert ex.resize_events[0].new_m == 64


def test_late_delta_merge_vs_drop():
    args = _port(*_setup(4, n=400))
    ex_m, ex_d = _elastic([(10, 2)]), _elastic([(10, 2)], late_policy="drop")
    r_m, r_d = (ex.run("delta", *args, tau=TAU) for ex in (ex_m, ex_d))
    assert ex_m.resize_events[0].late_points == 2 * TAU
    assert ex_d.resize_events[0].late_points == 0
    assert "late_delta" not in ex_d.last_comm["by_tag"]
    assert not torch.allclose(r_m.w_shared, r_d.w_shared)
    for r in (r_m, r_d):
        assert float(r.distortion[-1]) < float(r.distortion[0])


def test_late_delta_skipped_when_the_pool_is_dry():
    # 4 x 100 points: 10 windows of 40 use the pool up at window 10
    ex = _elastic([(10, 2)])
    ex.run("delta", *_port(*_setup(4, n=100)), tau=TAU)
    ev = ex.resize_events[0]
    assert ev.late_skipped and ev.late_points == 0


def test_average_scheme_runs():
    ex = _elastic([(10, 2)])
    res = ex.run("average", *_port(*_setup(4, n=300)), tau=TAU)
    assert float(res.distortion[-1]) < float(res.distortion[0])


# ---------------------------------------------------------------------------
# checkpoint and resume
# ---------------------------------------------------------------------------

def test_checkpoint_and_resume_bitwise(tmp_path):
    args = _port(*_setup(4, n=400))
    ck = Checkpointer(str(tmp_path))
    ex1 = _elastic([(10, 2)], checkpointer=ck)
    r1 = ex1.run("delta", *args, tau=TAU)
    assert ex1.resize_events[0].checkpoint_step == 10
    assert ck.latest_step() == 10
    assert 0.0 < ex1.resize_events[0].checkpoint_s <= (
        ex1.resize_events[0].wall_s)
    ex2 = _elastic([(10, 2)], checkpointer=ck, resume=True)
    r2 = ex2.run("delta", *args, tau=TAU)
    n2 = len(r2.distortion)
    assert 0 < n2 < len(r1.distortion) and ex2.resize_events == []
    assert torch.equal(r1.w_shared, r2.w_shared)
    assert torch.equal(r1.distortion[-n2:], r2.distortion)
    assert torch.equal(r1.wall_ticks[-n2:], r2.wall_ticks)


def test_resume_of_a_completed_run_returns_its_state(tmp_path):
    args = _port(*_setup(4, n=100))     # 10 windows of 40 points
    ck = Checkpointer(str(tmp_path))
    r1 = _elastic([(10, 2)], checkpointer=ck).run("delta", *args, tau=TAU)
    assert ck.latest_step() == 10
    r2 = _elastic([(10, 2)], checkpointer=ck, resume=True).run(
        "delta", *args, tau=TAU)
    assert torch.equal(r1.w_shared, r2.w_shared)
    assert r2.distortion.shape == (1,) and bool(
        torch.isfinite(r2.distortion).all())
    with pytest.raises(ValueError, match="no checkpoint"):
        _elastic([], checkpointer=Checkpointer(str(tmp_path / "empty")),
                 resume=True).run("delta", *args, tau=TAU)


# ---------------------------------------------------------------------------
# host groups: whole groups leave and return
# ---------------------------------------------------------------------------

def _hier(topo, tier1="sparse"):
    t1 = comm.get_transport("sparse", frac=FRAC_Q) if tier1 == "sparse" \
        else tier1
    return comm.HierarchicalTransport("xla", t1, topology=topo)


def test_hier_dense_tiers_equal_the_flat_elastic_run_bitwise():
    args = _port(*_setup(8, n=800))
    sched = [(26, 4), (53, 8)]
    topo = Topology.from_spec(8, hosts=2)
    ex_h = _elastic(sched, topology=topo, transport=_hier(topo, "xla"))
    ex_f = _elastic(sched)
    assert _same(ex_h.run("delta", *args, tau=TAU),
                 ex_f.run("delta", *args, tau=TAU))
    assert _events(ex_h) == _events(ex_f)
    late = ex_h.last_comm["by_tag"]["late_delta"]
    assert late["by_tier"] == {1: {"calls": 1, "logical_bytes": 4 * KAPPA * D,
                                   "wire_bytes": 4 * KAPPA * D}}
    assert "by_tier" not in ex_f.last_comm["by_tag"]["late_delta"]


def test_hier_resize_matches_the_reference():
    w0, data, eval_data = _setup(8, n=800)
    sched = [(26, 4), (53, 8)]
    jtopo = JTopology.from_spec(8, hosts=2)
    jex = JElastic(sched, network=JInstant(), topology=jtopo,
                   transport=JHier(tier0="xla", tier1="sparse",
                                   tier1_frac=FRAC_Q,
                                   host_axis=jtopo.host_axis,
                                   worker_axis=jtopo.worker_axis))
    ref = jex.run("delta", w0, data, eval_data, tau=TAU)
    topo = Topology.from_spec(8, hosts=2)
    ex = _elastic(sched, topology=topo, transport=_hier(topo))
    got = ex.run("delta", *_port(w0, data, eval_data), tau=TAU)
    _held(got, ref)
    assert _events(ex) == _events(jex)
    assert ex.last_comm == jex.last_comm
    late = ex.last_comm["by_tag"]["late_delta"]
    assert late["wire_bytes"] == late["by_tier"][1]["wire_bytes"] == (
        4 * KAPPA * D)


def test_hier_clamps_to_whole_host_groups():
    topo = Topology.from_spec(8, hosts=2)
    ex = _elastic([(2, 6), (5, 2)], topology=topo, transport=_hier(topo))
    ex.run("delta", *_port(*_setup(8, n=200)), tau=TAU)
    assert [(e.old_m, e.new_m) for e in ex.resize_events] == [(8, 4),
                                                              (4, 4)]
    with pytest.raises(ValueError, match="host group needs 4"):
        _elastic([], topology=topo, max_workers=2).run(
            "delta", *_port(*_setup(8, n=40)), tau=TAU)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_elastic_run(tmp_path, capsys):
    rc = train.main([
        "--mode", "vq", "--executor", "mesh", "--workers", "4",
        "--points", "300", "--resize", "10:2,20:4", "--ckpt-dir",
        str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "executor=elastic" in out and "resize=10:2,20:4" in out
    assert "resize @window 10: M 4 -> 2 (late points merged: 20," in out
    assert "resize @window 20: M 2 -> 4 (late points merged: 0," in out
    assert "ckpt@10" in out and "ckpt@20" in out
    rc = train.main([
        "--mode", "vq", "--executor", "mesh", "--workers", "4",
        "--points", "300", "--resize", "10:2,20:4", "--ckpt-dir",
        str(tmp_path), "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "resize @window" not in out


@pytest.mark.parametrize("argv,msg", [
    (["--executor", "sim", "--resize", "10:2"], "mesh-executor feature"),
    (["--executor", "mesh", "--resize", "banana"], "bad resize spec"),
    (["--executor", "mesh", "--resume"], "needs --resize"),
    (["--executor", "mesh", "--resize", "10:2", "--resume"],
     "needs --ckpt-dir"),
    (["--executor", "mesh", "--resize", "10:2", "--wire-quant", "int8"],
     "--wire-quant does not compose"),
    (["--executor", "mesh", "--resize", "10:2", "--merge", "dynamic"],
     "does not compose with --resize"),
    (["--executor", "mesh", "--resize", "10:2", "--hosts", "2",
      "--workers", "4", "--tier1-frac", "auto"], "plain-mesh feature"),
])
def test_train_cli_resize_refusals(argv, msg, capsys):
    rc = train.main(["--mode", "vq", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert rc == 2 and any(line.startswith("error: ") and msg in line
                           for line in out.splitlines())


def test_quantized_wire_over_host_groups_regroups_and_keeps_the_bits():
    """A quantized wire over a hierarchical transport is regrouped under
    its codec: over dense tiers it equals the quantized flat run."""
    args = _port(*_setup(8, n=200))
    sched = [(5, 4), (10, 8)]
    topo = Topology.from_spec(8, hosts=2)
    ex_h = _elastic(sched, topology=topo, transport=comm.get_transport(
        "quant", inner=_hier(topo, "xla"), mode="bf16"))
    ex_f = _elastic(sched, transport=comm.get_transport("quant", mode="bf16"))
    assert _same(ex_h.run("delta", *args, tau=TAU),
                 ex_f.run("delta", *args, tau=TAU))
    assert ex_h.last_comm["by_tag"]["late_delta"]["by_tier"][1][
        "wire_bytes"] == 4 * KAPPA * D
