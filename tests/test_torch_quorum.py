"""The port's quorum merge and the networks' late matrix held against
``repro.engine.merge.QuorumMerge`` and ``repro.engine.network``
(``ChaosNetwork``, which comes with the elastic executor, is left out).

``late_matrix`` is host numpy (Philox), so its bits are compared exactly.
Inputs for whole runs are made with numpy from a seed and handed to both
packages through ``repro_torch.interop``; the quorum merge with no late
worker is the plain delta merge bit for bit (the port's contract), and
against the reference's mesh under geometric lateness the runs agree at
``rtol=1e-4, atol=1e-6`` with equal wire bytes.  The merge state after a
run (the quorum carry, the dynamic merge's carry and staleness over a
hierarchical sparse tier 1) is held against the reference's through
``interop.merge_state_from_reference`` at the same tolerance.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import HierarchicalTransport as JHier
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro.engine.mesh import make_worker_mesh
from repro.topology import Topology as JTopology
from repro_torch import comm, interop
from repro_torch.engine import (GeometricDelayNetwork, InstantNetwork,
                                Topology)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
D, KAPPA = 8, 16
RTOL, ATOL = 1e-4, 1e-6


def _setup(m, n=400, seed=42, n_eval=200):
    """Reference-shaped inputs, numpy (as tests/test_torch_comm.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _run(m, network=None, n=400, transport=None, **ex_kw):
    w0, data, eval_data = _setup(m, n)
    ex = MeshExecutor(network or InstantNetwork(), transport=transport,
                      device="cpu", **ex_kw)
    res = ex.run("delta", *interop.from_reference(w0, data, eval_data,
                                                  device="cpu"), tau=TAU)
    return res, ex


# ---------------------------------------------------------------------------
# late_matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n_windows,tau,window0,p", [
    (8, 20, 2, 0, 0.3), (8, 12, 2, 8, 0.3), (64, 64, 2, 0, 0.3),
    (8, 125, 10, 0, 0.2), (3, 7, 10, 1234, 0.5), (5, 9, 0, 3, 1.0),
    (8, 40, 10, 0, 0.05)])
def test_late_matrix_equals_reference_bitwise(m, n_windows, tau, window0, p):
    got = GeometricDelayNetwork(p).late_matrix(m, n_windows, tau,
                                               window0=window0)
    want = JGeometric(p).late_matrix(m, n_windows, tau, window0=window0)
    assert got.dtype == np.float32 and got.shape == (m, n_windows)
    np.testing.assert_array_equal(got, want)


def test_late_matrix_segment_aligned_and_tail():
    g = GeometricDelayNetwork(0.3)
    a = g.late_matrix(8, 20, 2)
    np.testing.assert_array_equal(g.late_matrix(8, 12, 2, window0=8),
                                  a[:, 8:])
    # P(late) = (1-p)^(tau+1): more slack, rarer stragglers
    frac = float(g.late_matrix(64, 64, 2).mean())
    assert abs(frac - 0.7 ** 3) < 0.05
    assert float(g.late_matrix(64, 64, 8).mean()) < frac
    # the base model is always on time; p = 1 has no delay at all
    for net in (InstantNetwork(), GeometricDelayNetwork(1.0)):
        np.testing.assert_array_equal(net.late_matrix(4, 6, TAU),
                                      np.zeros((4, 6), np.float32))


# ---------------------------------------------------------------------------
# the quorum merge through the executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["xla", "ring"])
@pytest.mark.parametrize("m", [4, 8])
def test_quorum_without_lateness_is_exactly_delta(m, transport):
    ref, ex_d = _run(m, transport=transport)
    q, ex_q = _run(m, transport=transport, merge="quorum")
    assert torch.equal(ref.w_shared, q.w_shared)
    assert torch.equal(ref.distortion, q.distortion)
    # the count leaf rides the same record: logical + 4 B, one ring on the
    # sum of the two leaves
    merge = ex_q.last_comm["by_tag"]["merge"]
    logical = 4 * KAPPA * D + 4
    assert merge["calls"] == 40 and merge["logical_bytes"] == 40 * logical
    assert merge["wire_bytes"] == 40 * comm.ring_wire_bytes(logical, m)
    assert ex_q.transport.log.records[0].logical_bytes == logical


def test_quorum_validation():
    with pytest.raises(ValueError, match="merge"):
        MeshExecutor(merge="bogus", device="cpu")
    with pytest.raises(ValueError, match="quorum_frac"):
        MeshExecutor(merge="quorum", quorum_frac=0.0, device="cpu")
    w0, data, eval_data = _setup(4, n=40)
    ex = MeshExecutor(InstantNetwork(), merge="quorum", device="cpu")
    for scheme in ("average", "async_delta"):
        with pytest.raises(ValueError, match="delta"):
            ex.run(scheme, *interop.from_reference(w0, data, eval_data,
                                                   device="cpu"), tau=TAU)


@pytest.mark.devices(8)
@pytest.mark.parametrize("quorum_frac", [0.6, 1.0])
def test_quorum_geometric_lateness_matches_reference(quorum_frac):
    """p_delay = 0.2, tau = 10: about 0.8^11 = 8.6% of worker-windows are
    late; at quorum_frac 1.0 every window with a late worker fails its
    quorum and carries everything."""
    net = GeometricDelayNetwork(0.2)
    late = net.late_matrix(8, 40, TAU)
    assert 0 < late.sum() < late.size
    ours, ex = _run(8, net, quorum_frac=quorum_frac, merge="quorum")
    w0, data, eval_data = _setup(8)
    jex = JMeshExecutor(network=JGeometric(0.2), merge="quorum",
                        quorum_frac=quorum_frac)
    theirs = jex.run("delta", jnp.asarray(w0), jnp.asarray(data),
                     jnp.asarray(eval_data), tau=TAU)
    np.testing.assert_allclose(ours.distortion.numpy(),
                               np.asarray(theirs.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ours.w_shared.numpy(),
                               np.asarray(theirs.w_shared), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ours.wall_ticks.numpy(),
                                  np.asarray(theirs.wall_ticks))
    assert ex.last_comm == jex.last_comm
    delta, _ = _run(8)
    assert not torch.equal(ours.w_shared, delta.w_shared)


@pytest.mark.devices(8)
def test_quorum_carry_matches_reference_state():
    net = GeometricDelayNetwork(0.2)
    w0, data, eval_data = _setup(8, n=200)
    ex = MeshExecutor(net, merge="quorum", device="cpu")
    tw0, tdata, teval = interop.from_reference(w0, data, eval_data,
                                               device="cpu")
    strategy = ex._strategy("delta")
    _, ours = ex._run_sync(strategy, tw0, tdata, teval, tau=TAU, eps0=0.5,
                           decay=1.0, t0=0,
                           state=strategy.init_state(tw0.expand(8, KAPPA, D)))
    jex = JMeshExecutor(network=JGeometric(0.2), merge="quorum")
    _, theirs = jex._run_sync(make_worker_mesh(8), "delta", jnp.asarray(w0),
                              jnp.asarray(data), jnp.asarray(eval_data),
                              tau=TAU, eps0=0.5, decay=1.0)
    got = interop.merge_state_from_reference(theirs, device="cpu")
    assert ours.shape == got.shape == (8, KAPPA, D)
    np.testing.assert_allclose(ours.numpy(), got.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.devices(8)
def test_dynamic_state_over_hier_matches_reference_state():
    """The dynamic merge's {carry, stale} and a hierarchical sparse tier
    1's per-host residual after 20 windows, against the reference's."""
    m, n = 8, 200
    w0, data, eval_data = _setup(m, n)
    topo = Topology.from_spec(m, hosts=2)
    hier = comm.HierarchicalTransport(
        "xla", comm.get_transport("sparse", frac=1 / 32), topology=topo)
    ex = MeshExecutor(InstantNetwork(), transport=hier, merge="dynamic",
                      divergence_thresh=1e-3, device="cpu")
    tw0, tdata, teval = interop.from_reference(w0, data, eval_data,
                                               device="cpu")
    strategy = ex._strategy("delta")
    _, ours = ex._run_sync(strategy, tw0, tdata, teval, tau=TAU, eps0=0.5,
                           decay=1.0, t0=0,
                           state=strategy.init_state(tw0.expand(m, KAPPA, D)))
    jtopo = JTopology.from_spec(m, hosts=2)
    jex = JMeshExecutor(topology=jtopo, network=JInstant(), transport=JHier(
        tier0="xla", tier1="sparse", tier1_frac=1 / 32), merge="dynamic",
        divergence_thresh=1e-3)
    _, theirs = jex._run_sync(jtopo.make_mesh(), "delta", jnp.asarray(w0),
                              jnp.asarray(data), jnp.asarray(eval_data),
                              tau=TAU, eps0=0.5, decay=1.0)
    got = interop.merge_state_from_reference(theirs, topology=topo,
                                             device="cpu")
    assert set(got) == set(ours) == {"own", "comm"}
    assert float(ours["own"]["stale"]) == float(got["own"]["stale"])
    assert got["own"]["stale"].shape == ()
    np.testing.assert_allclose(ours["own"]["carry"].numpy(),
                               got["own"]["carry"].numpy(), rtol=RTOL,
                               atol=ATOL)
    assert got["comm"]["t0"] is None and ours["comm"]["t0"] is None
    np.testing.assert_allclose(ours["comm"]["t1"].numpy(),
                               got["comm"]["t1"].numpy(), rtol=RTOL,
                               atol=ATOL)
    assert float(ours["comm"]["t1"].abs().max()) > 0


def test_merge_state_from_reference_checks_its_folds():
    topo = Topology.from_spec(4, hosts=2)
    ok = {"t0": None, "t1": np.repeat(np.arange(2, dtype=np.float32), 2)}
    got = interop.merge_state_from_reference(ok, topology=topo,
                                             device="cpu")
    assert got["t1"].tolist() == [0.0, 1.0]
    with pytest.raises(ValueError, match="rows differ"):
        interop.merge_state_from_reference(
            {"t1": np.arange(4, dtype=np.float32)}, topology=topo,
            device="cpu")
    with pytest.raises(ValueError, match="rows differ"):
        interop.merge_state_from_reference(
            {"stale": np.array([1.0, 2.0], np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        interop.merge_state_from_reference(ok, device="cpu")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv + ["--device", "cpu"])
    return rc, out.getvalue()


def test_train_cli_quorum():
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--points", "200", "--quorum", "--network", "geometric",
                     "--p-delay", "0.2"])
    assert rc == 0
    # 20 windows x ring(16 x 8 x 4 + 4 = 516 B, 8): 18,060 B
    assert f"merge wire {20 * comm.ring_wire_bytes(516, 8):,} B" in out
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--points", "200", "--quorum", "--scheme", "average"])
    assert rc == 2 and "needs --scheme delta" in out
    rc, out = _main(["--mode", "vq", "--executor", "sim", "--workers", "8",
                     "--points", "200", "--merge", "quorum"])
    assert rc == 2 and out.startswith("error: ")
