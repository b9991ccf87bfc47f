"""``MeshExecutor`` with one worker a process, held against the stacked
executor, the reference's ``MeshExecutor`` and ``scheme_async``.

One 4-rank gloo world (``_torch_worlds.executor_runs``) runs every
process-mode configuration once, on inputs made with numpy from a seed;
each rank keeps its own worker's rows.  Over the group ``xla`` transport
the runs agree with the stacked run and the reference's mesh at the bar the
port's runs are held to (``rtol=1e-4, atol=1e-6``), with equal wire bytes
and ticks.  Over the group ring the codebook equals the stacked ring run's
bit for bit: the ring keeps the stacked fold, and on the CPU a ``(1, tau,
d)`` window and a ``(1, n, d)`` eval give row i of the ``(M, ...)`` ones,
so the curve does too.  The cloud modes (the sparse transport flat and as
tier 1, the quorum and dynamic merges, chaos, and the tracer, metrics and
profiler) are each held against the stacked run of the same configuration
and the reference's mesh; an elastic segment over the group (its step
schedule from a global step) equals the stacked ring's segment bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.core import async_vq as jasync
from repro.comm import HierarchicalTransport as JHier
from repro.comm import get_transport as jget_transport
from repro.engine import ChaosNetwork as JChaosNetwork
from repro.engine import ChaosSchedule as JSchedule
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro.obs import Tracer as JTracer
from repro.topology import Topology as JTopology
from repro_torch import comm, interop
from repro_torch.core import async_vq
from repro_torch.distributed import process_group
from repro_torch.engine import GeometricDelayNetwork, InstantNetwork
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.topology import Topology

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
W_RTOL = 1e-5
TAU = 10
M = 4


def _setup(n=200, d=8, kappa=16, seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(M, n))]
            + 0.05 * rng.standard_normal((M, n, d))).astype(np.float32)
    w0 = data.reshape(-1, d)[rng.choice(M * n, kappa, replace=False)].copy()
    return w0, data, data[:, :100].copy()


def _ref_lengths(n=200):
    key = jax.random.fold_in(jax.random.PRNGKey(42), 9)
    return key, JGeometric(0.5).round_lengths(key, M, n // TAU + 2, TAU)


@pytest.fixture(scope="module")
def runs():
    w0, data, ev = _setup()
    _, lengths = _ref_lengths()
    ins = {"w0": w0, "data": data, "eval": ev,
           "lengths": np.array(lengths, np.int32)}
    return ins, process_group.spawn(worlds.executor_runs, M, ins,
                                    device="cpu")


def _stacked(ins, scheme, transport, **kw):
    net = (GeometricDelayNetwork(0.5) if scheme == "async_delta"
           else InstantNetwork())
    ex = MeshExecutor(net, transport=transport, device="cpu", **kw)
    args = [torch.from_numpy(ins[k]) for k in ("w0", "data", "eval")]
    extra = ({"lengths": torch.from_numpy(ins["lengths"])}
             if scheme == "async_delta" else {})
    res = ex.run(scheme, *args, tau=TAU, **extra)
    return res, ex.last_comm


def _same_on_every_rank(outs, key):
    for r in range(1, M):
        for a, b in zip(outs[r][key][:3], outs[0][key][:3]):
            np.testing.assert_array_equal(a, b)
        assert outs[r][key][3] == outs[0][key][3]


@pytest.mark.parametrize("scheme", ["delta", "average", "async_delta"])
def test_group_ring_run_equals_stacked_ring_run_bitwise(runs, scheme):
    ins, outs = runs
    key = ("async" if scheme == "async_delta" else scheme) + "_ring"
    res, last = _stacked(ins, scheme, "ring")
    _same_on_every_rank(outs, key)
    w, curve, ticks, comm_ = outs[0][key]
    np.testing.assert_array_equal(w, res.w_shared.numpy())
    np.testing.assert_array_equal(curve, res.distortion.numpy())
    np.testing.assert_array_equal(ticks, res.wall_ticks.numpy())
    assert comm_ == last


def test_raw_process_group_is_the_flat_groups(runs):
    _, outs = runs
    for a, b in zip(outs[0]["delta_ring_pg"], outs[0]["delta_ring"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.devices(4)
@pytest.mark.parametrize("scheme", ["delta", "average"])
def test_group_xla_run_matches_stacked_and_reference(runs, scheme):
    ins, outs = runs
    _same_on_every_rank(outs, f"{scheme}_xla")
    w, curve, ticks, last = outs[0][f"{scheme}_xla"]
    res, stacked_comm = _stacked(ins, scheme, "xla")
    theirs = JMeshExecutor(network=JInstant())
    ref = theirs.run(scheme, jnp.asarray(ins["w0"]), jnp.asarray(ins["data"]),
                     jnp.asarray(ins["eval"]), tau=TAU)
    for want_w, want_c, want_t in (
            (res.w_shared.numpy(), res.distortion.numpy(),
             res.wall_ticks.numpy()),
            (np.asarray(ref.w_shared), np.asarray(ref.distortion),
             np.asarray(ref.wall_ticks))):
        np.testing.assert_allclose(w, want_w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(curve, want_c, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ticks, want_t)
    assert last == stacked_comm
    for k in ("wire_bytes", "logical_bytes", "calls"):
        for tag in ("merge", "eval"):
            assert (last["by_tag"][tag][k]
                    == theirs.last_comm["by_tag"][tag][k])


@pytest.mark.parametrize("transport", ["xla", "ring"])
def test_group_eq9_matches_scheme_async(runs, transport):
    ins, outs = runs
    key, lengths = _ref_lengths()
    want = jasync.scheme_async(jnp.asarray(ins["w0"]),
                               jnp.asarray(ins["data"]),
                               jnp.asarray(ins["eval"]), key, tau=TAU,
                               lengths=lengths)
    _same_on_every_rank(outs, f"async_{transport}")
    w, curve, ticks, _ = outs[0][f"async_{transport}"]
    np.testing.assert_array_equal(ticks, np.asarray(want.wall_ticks))
    np.testing.assert_allclose(curve, np.asarray(want.distortion),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w, np.asarray(want.w_shared), rtol=W_RTOL,
                               atol=ATOL)
    # and the port's own oracle on the same lengths
    mine = async_vq.scheme_async(
        *interop.from_reference(ins["w0"], ins["data"], ins["eval"],
                                device="cpu"),
        tau=TAU, lengths=interop.lengths_from_reference(lengths))
    np.testing.assert_allclose(curve, mine.distortion.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_hierarchical_dense_tiers_equal_flat(runs):
    ins, outs = runs
    _same_on_every_rank(outs, "hier_xla")
    w, curve, ticks, last = outs[0]["hier_xla"]
    flat_w, flat_curve, flat_ticks, _ = outs[0]["delta_xla"]
    np.testing.assert_allclose(w, flat_w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(curve, flat_curve, rtol=RTOL, atol=ATOL)
    # the per-tier records are the stacked 2x2 run's, field for field
    topo = Topology.simulate(2, 2)
    res, stacked_comm = _stacked(
        ins, "delta", comm.HierarchicalTransport("xla", "xla",
                                                 topology=topo),
        topology=topo)
    assert last == stacked_comm
    np.testing.assert_array_equal(ticks, res.wall_ticks.numpy())
    assert set(last["by_tag"]["merge"]["by_tier"]) == {0, 1}


def test_hierarchical_masked_ring_matches_stacked(runs):
    ins, outs = runs
    _same_on_every_rank(outs, "hier_async_ring")
    w, curve, ticks, last = outs[0]["hier_async_ring"]
    topo = Topology.simulate(2, 2)
    res, stacked_comm = _stacked(
        ins, "async_delta", comm.HierarchicalTransport("ring", "ring",
                                                       topology=topo),
        topology=topo)
    np.testing.assert_allclose(w, res.w_shared.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(curve, res.distortion.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ticks, res.wall_ticks.numpy())
    assert last == stacked_comm


def test_quantized_ring_over_group_equals_stacked(runs):
    ins, outs = runs
    _same_on_every_rank(outs, "quant_ring")
    w, curve, _, last = outs[0]["quant_ring"]
    res, stacked_comm = _stacked(
        ins, "delta", comm.get_transport("quant", inner="ring", mode="int8"))
    np.testing.assert_array_equal(w, res.w_shared.numpy())
    np.testing.assert_array_equal(curve, res.distortion.numpy())
    assert last == stacked_comm


@pytest.mark.parametrize("t0", [worlds.SEGMENT_T0])
def test_elastic_segment_over_the_group_equals_stacked(runs, t0):
    ins, outs = runs
    _same_on_every_rank(outs, "segment")
    w, curve, ticks, last = outs[0]["segment"]
    ex = MeshExecutor(InstantNetwork(), transport="ring", device="cpu")
    res = ex.run_segment("delta", *(torch.from_numpy(ins[k])
                                     for k in ("w0", "data", "eval")),
                         tau=TAU, t0=t0)
    np.testing.assert_array_equal(w, res.w_shared.numpy())
    np.testing.assert_array_equal(curve, res.distortion.numpy())
    np.testing.assert_array_equal(ticks, res.wall_ticks.numpy())
    assert last == ex.last_comm


def _ref_cloud(ins, mode):
    """The reference's mesh in a cloud mode: (result, executor, the
    dynamic merge's trigger bits from its tracer's merge spans)."""
    kw: dict = {"network": JInstant()}
    if mode == "sparse":
        kw["transport"] = jget_transport("sparse", frac=worlds.CLOUD_FRAC)
    elif mode == "sparse_tier1":
        topo = JTopology.from_spec(M, hosts=2)
        kw.update(topology=topo, transport=JHier(
            tier0="xla", tier1="sparse", tier1_frac=worlds.CLOUD_TIER1_FRAC,
            host_axis=topo.host_axis, worker_axis=topo.worker_axis))
    elif mode == "quorum":
        kw.update(network=JGeometric(0.2), merge="quorum")
    elif mode in ("dynamic0", "dynamic"):
        kw.update(merge="dynamic", divergence_thresh=(
            0.0 if mode == "dynamic0" else worlds.CLOUD_THRESH),
            tracer=JTracer())
    elif mode == "chaos":
        kw.update(merge="quorum", network=JChaosNetwork(
            JInstant(), JSchedule.from_spec(worlds.CLOUD_CHAOS, windows=20,
                                            m=M, hosts=2)))
    else:
        # observed as the port's run is, so its eval reduce carries the
        # divergence too
        kw.update(transport=jget_transport("ring"), tracer=JTracer())
    ex = JMeshExecutor(**kw)
    res = ex.run("delta", jnp.asarray(ins["w0"]), jnp.asarray(ins["data"]),
                 jnp.asarray(ins["eval"]), tau=TAU)
    bits = ([int(sp.attrs["triggered"]) for sp in ex.tracer.spans("merge")
             if "triggered" in sp.attrs]
            if kw.get("merge") == "dynamic" else None)
    return res, ex, bits


@pytest.mark.devices(4)
@pytest.mark.parametrize("mode", worlds.CLOUD_MODES)
def test_cloud_mode_matches_stacked_and_reference(runs, mode):
    """A cloud mode in 4 processes == the stacked run of the same
    configuration (bit for bit where the sums keep the stacked order: the
    sparse gather and the ring; else at the bar below) and the reference's
    mesh, with equal bytes, ticks, triggers, late counts and, observed, the
    stacked run's modeled spans, counters, metrics and profiler terms."""
    ins, outs = runs
    got = [o["cloud"][mode] for o in outs]
    for g in got[1:]:                          # every rank reads one run
        for a, b in zip(g[:3], got[0][:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == got[0][3] and g[5] == got[0][5]
        if g[4] is not None:
            np.testing.assert_array_equal(g[4], got[0][4])
    w, curve, ticks, last, trig, late, obs = got[0]
    net, kw = worlds.cloud_config(mode)
    ex = MeshExecutor(net, device="cpu", **kw)
    res = ex.run("delta", *[torch.from_numpy(ins[k])
                            for k in ("w0", "data", "eval")], tau=TAU)
    if mode in ("sparse", "tracer", "metrics", "profiler"):
        # the gather-and-sum and the ring keep the stacked order, and a
        # mean over a group is the stacked mean of the gathered rows
        np.testing.assert_array_equal(w, res.w_shared.numpy())
        np.testing.assert_array_equal(curve, res.distortion.numpy())
    ref, jex, ref_bits = _ref_cloud(ins, mode)
    for want_w, want_c, want_t in (
            (res.w_shared.numpy(), res.distortion.numpy(),
             res.wall_ticks.numpy()),
            (np.asarray(ref.w_shared), np.asarray(ref.distortion),
             np.asarray(ref.wall_ticks))):
        np.testing.assert_allclose(w, want_w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(curve, want_c, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ticks, want_t)
    assert last == ex.last_comm
    for tag, t in jex.last_comm["by_tag"].items():
        if tag == "eval" and mode.startswith("dynamic"):
            continue         # the reference's traced eval adds divergence
        for k in ("wire_bytes", "logical_bytes", "calls"):
            assert last["by_tag"][tag][k] == t[k]
    assert late == ex.last_late_worker_windows
    if mode == "quorum":
        assert late == int(JGeometric(0.2).late_matrix(M, 20, TAU).sum()) > 0
    if mode == "chaos":
        want = JChaosNetwork(JInstant(), JSchedule.from_spec(
            worlds.CLOUD_CHAOS, windows=20, m=M, hosts=2)).late_matrix(
                M, 20, TAU)
        assert late == int(want.sum()) > 0
    if ref_bits is not None:
        np.testing.assert_array_equal(trig, ex.last_triggers.numpy())
        np.testing.assert_array_equal(trig, ref_bits)
        if mode == "dynamic":
            assert 0 < trig.sum() < len(trig)
    assert obs == worlds.observed(ex)
    if mode == "metrics":
        # the comm_* mirror is the rank's CommLog
        mirror = {}
        for m_ in obs["metrics"]:
            if m_["name"] == "comm_wire_bytes":
                tag = m_["labels"]["tag"]
                mirror[tag] = mirror.get(tag, 0) + m_["value"]
        assert mirror == {t: v["wire_bytes"]
                          for t, v in last["by_tag"].items()}
