"""The port's topology and hierarchical transport held against
``repro.topology`` and ``repro.comm.hier``.

Inputs are made with numpy from a seed and handed to both packages through
``repro_torch.interop`` (tests/test_torch_comm.py's mixture).  The port's
own contracts are bit for bit: a hierarchical run with a dense tier 1
equals the flat run, and ``hosts=1`` the flat path.  Against the reference:
wire bytes and whole ``last_comm`` summaries exactly; runs with a sparse
tier 1 at ``rtol=1e-4, atol=1e-6``; the tier-1 residual, kept one per host
in the port, against the reference's residual of every worker of that host
at the same tolerance.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import HierarchicalTransport as JHier
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro.topology import Topology as JTopology
from repro_torch import comm, interop
from repro_torch.comm import HierarchicalTransport, get_transport
from repro_torch.comm.sweep import acceptance_sparse_frac
from repro_torch.engine import (FixedLatencyNetwork, InstantNetwork,
                                Topology, get_network)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
D, KAPPA = 8, 16
FRAC_Q = acceptance_sparse_frac(KAPPA, D)   # k = kappa/4 = 4 of 128
RTOL, ATOL = 1e-4, 1e-6


def _setup(m, n=400, seed=42, n_eval=200):
    """Reference-shaped inputs, numpy (as tests/test_torch_comm.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _hier(topo, tier1="sparse", frac=FRAC_Q, tier0="xla"):
    if tier1 == "sparse":
        tier1 = comm.get_transport("sparse", frac=frac)
    return HierarchicalTransport(tier0, tier1, topology=topo)


def _run(scheme, transport=None, *, m=8, n=400, network=None, **ex_kw):
    w0, data, eval_data = _setup(m, n)
    ex = MeshExecutor(network or InstantNetwork(), transport=transport,
                      device="cpu", **ex_kw)
    res = ex.run(scheme, *interop.from_reference(w0, data, eval_data,
                                                 device="cpu"), tau=TAU)
    return res, ex


def _ref_run(scheme, tier1, *, m=8, n=400, frac=FRAC_Q):
    w0, data, eval_data = _setup(m, n)
    topo = JTopology.from_spec(m, hosts=2)
    ex = JMeshExecutor(topology=topo, network=JInstant(), transport=JHier(
        tier0="xla", tier1=tier1,
        tier1_frac=frac if tier1 == "sparse" else None,
        host_axis=topo.host_axis, worker_axis=topo.worker_axis))
    res = ex.run(scheme, jnp.asarray(w0), jnp.asarray(data),
                 jnp.asarray(eval_data), tau=TAU)
    return res, ex


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

def test_topology_validation():
    with pytest.raises(ValueError, match="non-empty"):
        Topology.flat(1, worker_axis="")
    with pytest.raises(ValueError, match="distinct"):
        Topology.simulate(1, 1, host_axis="w", worker_axis="w")
    with pytest.raises(ValueError, match="hosts >= 1"):
        Topology.simulate(0, 2)
    with pytest.raises(ValueError, match="equal host groups"):
        Topology.from_spec(8, hosts=3)
    with pytest.raises(ValueError, match="hosts must be >= 1"):
        Topology.from_spec(8, hosts=-2)
    topo = Topology.from_spec(8, hosts=2)
    with pytest.raises(ValueError, match="outside"):
        topo.group_of(8)
    with pytest.raises(ValueError, match="outside"):
        topo.group_members(2)
    with pytest.raises(ValueError, match="holds 8 workers"):
        topo.view(torch.zeros(6, 3))


@pytest.mark.devices(8)
@pytest.mark.parametrize("m,hosts", [(8, 2), (8, 4), (8, None), (4, 1),
                                     (6, 3)])
def test_topology_matches_reference(m, hosts):
    ours = Topology.from_spec(m, hosts=hosts)
    theirs = JTopology.from_spec(m, hosts=hosts)
    for attr in ("hosts", "workers_per_host", "total_workers", "is_flat",
                 "axes", "host_axis", "worker_axis"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.describe() == theirs.describe()
    assert [ours.group_of(w) for w in range(m)] == [
        theirs.group_of(w) for w in range(m)]
    assert [list(ours.group_members(h)) for h in range(ours.hosts)] == [
        list(theirs.group_members(h)) for h in range(theirs.hosts)]
    # row-major: host h's workers are rows h*wph .. of the stacked dim,
    # the order in which the reference's grid lists its devices
    x = torch.arange(m * 3).view(m, 3)
    v = ours.view(x)
    grid = theirs.device_grid
    for h in range(ours.hosts):
        for j in range(ours.workers_per_host):
            assert torch.equal(v[h, j], x[grid[h, j].id])


# ---------------------------------------------------------------------------
# hierarchical transport semantics
# ---------------------------------------------------------------------------

def test_hier_transport_factory_and_validation():
    topo = Topology.from_spec(8, hosts=2)
    t = get_transport("hier", topology=topo, tier1_frac=0.25)
    assert t.name == "hier" and t.stateful and t.tier1_frac == 0.25
    assert t.tier1.frac == 0.25 and t.tier0.name == "xla"
    dense = get_transport("hier", topology=topo, tier1="xla")
    assert not dense.stateful and dense.tier1_frac is None
    with pytest.raises(ValueError, match="one place only"):
        HierarchicalTransport(tier1=get_transport("sparse", frac=0.5),
                              tier1_frac=0.25, topology=topo)
    assert (t.host_axis, t.worker_axis) == ("hosts", "workers")
    pods = Topology.from_spec(8, hosts=2, host_axis="pods")
    assert HierarchicalTransport(topology=pods).host_axis == "pods"
    with pytest.raises(ValueError, match="must not be a Hierarchical"):
        HierarchicalTransport(tier0=dense, topology=topo)
    with pytest.raises(TypeError, match="Topology"):
        HierarchicalTransport(topology=(2, 4))
    with pytest.raises(ValueError, match="unknown reduce op"):
        t.all_reduce(torch.zeros(8, 3), op="max")
    with pytest.raises(ValueError, match="holds 8 workers"):
        t.all_reduce(torch.zeros(6, 3))
    with pytest.raises(ValueError, match="mask"):
        t.masked_all_reduce(torch.zeros(8, 3), torch.ones(6))
    # a sub-transport whose records already carry a tier is refused
    shared = get_transport("sparse", frac=0.5)
    h = HierarchicalTransport("xla", shared, topology=topo)
    mark = shared.log.mark()
    shared.log.append(comm.CommRecord("sum", "sparse", "hosts", 2, 4, 8,
                                      tier=1))
    with pytest.raises(RuntimeError, match="exactly once"):
        h._relog(shared, mark, 1, 1)


def test_hier_transport_state_tree():
    topo = Topology.from_spec(8, hosts=2)
    t = get_transport("hier", topology=topo, tier1_frac=FRAC_Q)
    st = t.init_state(torch.zeros(8, 4, 2))
    assert set(st) == {"t0", "t1"}
    assert st["t0"] is None and st["t1"].shape == (2, 4, 2)   # one a host
    assert get_transport("hier", topology=topo, tier1="xla").init_state(
        torch.zeros(8, 4, 2)) is None
    # a sparse tier 0 keeps one residual a worker
    t0s = HierarchicalTransport(get_transport("sparse", frac=0.5), "xla",
                                topology=topo)
    st = t0s.init_state(torch.zeros(8, 4, 2))
    assert st["t0"].shape == (8, 4, 2) and st["t1"] is None
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4, 2)).astype(np.float32))
    total, st2 = t0s.all_reduce(x, state=st)
    assert st2["t0"].shape == (8, 4, 2) and total.shape == (4, 2)


@pytest.mark.devices(8)
@pytest.mark.parametrize("tier1", ["xla", "sparse"])
def test_hier_per_tier_wire_closed_form(tier1):
    """Tier 0 is the dense ring inside a 4-worker group, tier 1 across the
    2 hosts (dense ring, or (hosts-1)*k*8 sparse); the whole summary equals
    the reference's."""
    n = 400
    n_windows = n // TAU
    logical = 4 * KAPPA * D
    topo = Topology.from_spec(8, hosts=2)
    _, ex = _run("delta", _hier(topo, tier1), n=n)
    tiers = ex.last_comm["by_tag"]["merge"]["by_tier"]
    assert tiers[0]["wire_bytes"] == n_windows * comm.ring_wire_bytes(
        logical, 4)
    if tier1 == "xla":
        want = n_windows * comm.ring_wire_bytes(logical, 2)
    else:
        want = n_windows * (2 - 1) * comm.topk_count(KAPPA * D, FRAC_Q) * 8
    assert tiers[1]["wire_bytes"] == want
    _, theirs = _ref_run("delta", tier1, n=n)
    assert ex.last_comm == theirs.last_comm


@pytest.mark.parametrize("tier0", ["xla", "ring"])
@pytest.mark.parametrize("scheme", ["average", "delta", "async_delta"])
def test_hier_dense_tier1_bitmatches_flat(scheme, tier0):
    """2x4 with a dense tier 1 == the flat 8-worker run, bit for bit (one
    reduction over all rows with tier 0's sum); over the ring, == the flat
    ring run."""
    topo = Topology.from_spec(8, hosts=2)
    flat, _ = _run(scheme, tier0)
    hier, ex = _run(scheme, HierarchicalTransport(tier0, "xla",
                                                  topology=topo))
    assert torch.equal(flat.w_shared, hier.w_shared)
    assert torch.equal(flat.distortion, hier.distortion)
    assert torch.equal(flat.wall_ticks, hier.wall_ticks)
    assert set(ex.last_comm["by_tag"]["merge"]["by_tier"]) == {0, 1}
    assert ex.topology == topo


@pytest.mark.parametrize("tier1", ["xla", "sparse"])
def test_hosts_one_collapses_bit_identically(tier1):
    flat, ex_f = _run("delta")
    topo = Topology.from_spec(8, hosts=1)
    hier, ex = _run("delta", _hier(topo, tier1))
    assert torch.equal(flat.w_shared, hier.w_shared)
    assert torch.equal(flat.distortion, hier.distortion)
    tiers = ex.last_comm["by_tag"]["merge"]["by_tier"]
    assert set(tiers) == {0}                  # tier 1 never ran
    assert tiers[0]["wire_bytes"] == (
        ex_f.last_comm["by_tag"]["merge"]["wire_bytes"])


@pytest.mark.devices(8)
@pytest.mark.parametrize("scheme", ["delta", "async_delta"])
def test_hier_sparse_tier1_distortion_bound(scheme):
    """A sparse tier 1 at k = kappa/4 stays within 25% of the flat dense
    run's final distortion and still converges."""
    flat, _ = _run(scheme)
    topo = Topology.from_spec(8, hosts=2)
    hier, _ = _run(scheme, _hier(topo))
    curve = hier.distortion.numpy()
    assert np.all(np.isfinite(curve)) and curve[-1] < curve[0]
    gap = curve[-1] / float(flat.distortion[-1]) - 1.0
    assert abs(gap) < 0.25, f"hier sparse final C off flat by {gap:+.3f}"


@pytest.mark.devices(8)
def test_hier_sparse_tier1_matches_reference():
    ours, ex = _run("delta", _hier(Topology.from_spec(8, hosts=2)))
    theirs, ex_r = _ref_run("delta", "sparse")
    np.testing.assert_allclose(ours.distortion.numpy(),
                               np.asarray(theirs.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ours.w_shared.numpy(),
                               np.asarray(theirs.w_shared), rtol=RTOL,
                               atol=ATOL)
    assert ex.last_comm == ex_r.last_comm


@pytest.mark.devices(8)
def test_hier_tier1_residual_per_host_matches_reference():
    """The port keeps one tier-1 residual a host; after 20 windows it equals
    the reference's residual of every worker of that host."""
    m, n = 8, 200
    w0, data, eval_data = _setup(m, n)
    topo = Topology.from_spec(m, hosts=2)
    ex = MeshExecutor(InstantNetwork(), transport=_hier(topo), device="cpu")
    tw0, tdata, teval = interop.from_reference(w0, data, eval_data,
                                               device="cpu")
    strategy = ex._strategy("delta")
    state = strategy.init_state(tw0.expand(m, KAPPA, D))
    _, ours = ex._run_sync(strategy, tw0, tdata, teval, tau=TAU, eps0=0.5,
                           decay=1.0, t0=0, state=state)
    jtopo = JTopology.from_spec(m, hosts=2)
    jex = JMeshExecutor(topology=jtopo, network=JInstant(), transport=JHier(
        tier0="xla", tier1="sparse", tier1_frac=FRAC_Q))
    _, theirs = jex._run_sync(jtopo.make_mesh(), "delta", jnp.asarray(w0),
                              jnp.asarray(data), jnp.asarray(eval_data),
                              tau=TAU, eps0=0.5, decay=1.0)
    got = interop.merge_state_from_reference(theirs, topology=topo,
                                             device="cpu")
    assert got["t0"] is None and ours["t0"] is None
    assert ours["t1"].shape == got["t1"].shape == (2, KAPPA, D)
    assert float(ours["t1"].abs().max()) > 0
    np.testing.assert_allclose(ours["t1"].numpy(), got["t1"].numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.devices(8)
def test_hier_sparse_full_density_matches_dense():
    """tier1_frac=1.0 keeps everything: only the order of the sums can
    differ."""
    topo = Topology.from_spec(8, hosts=2)
    dense, _ = _run("delta", _hier(topo, "xla"))
    full, _ = _run("delta", _hier(topo, frac=1.0))
    np.testing.assert_allclose(dense.distortion.numpy(),
                               full.distortion.numpy(), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# per-tier network charging
# ---------------------------------------------------------------------------

def test_fixed_network_charges_dcn_tier_separately():
    net = get_network("fixed", latency_ticks=0, bytes_per_tick=1000,
                      dcn_bytes_per_tick=10)
    assert net.transfer_ticks(1000) == 1
    assert net.transfer_ticks(1000, tier=0) == 1
    assert net.transfer_ticks(1000, tier=1) == 100
    flat = get_network("fixed", latency_ticks=0, bytes_per_tick=1000)
    assert flat.transfer_ticks(1000, tier=1) == 1
    with pytest.raises(ValueError, match="dcn_bytes_per_tick"):
        get_network("fixed", dcn_bytes_per_tick=-1)


def test_slow_dcn_stretches_hier_wall_clock():
    topo = Topology.from_spec(8, hosts=2)
    dcn = comm.ring_wire_bytes(4 * KAPPA * D, 2)  # dense tier 1 a window
    net = FixedLatencyNetwork(latency_ticks=0, dcn_bytes_per_tick=dcn)
    free, _ = _run("delta", _hier(topo, "xla"))
    dense, _ = _run("delta", _hier(topo, "xla"), network=net)
    sparse, _ = _run("delta", _hier(topo), network=net)
    assert torch.equal(free.distortion, dense.distortion)
    assert int(dense.wall_ticks[0]) == TAU + 1
    assert int(sparse.wall_ticks[0]) == TAU + 1
    assert int(dense.wall_ticks[-1]) > int(free.wall_ticks[-1])
    slow = FixedLatencyNetwork(latency_ticks=0, dcn_bytes_per_tick=dcn // 4)
    assert int(_run("delta", _hier(topo, "xla"), network=slow)[0]
               .wall_ticks[0]) == TAU + 4


def test_executor_topology_must_match_transport():
    topo = Topology.from_spec(8, hosts=2)
    with pytest.raises(ValueError, match="one place only"):
        MeshExecutor(InstantNetwork(), transport=_hier(topo),
                     topology=Topology.from_spec(8, hosts=4), device="cpu")
    ex = MeshExecutor(InstantNetwork(), transport=_hier(topo), device="cpu")
    assert ex.topology == topo
    w0, data, eval_data = _setup(4, n=40)
    with pytest.raises(ValueError, match="holds 8 workers"):
        ex.run("delta", *interop.from_reference(w0, data, eval_data,
                                                device="cpu"), tau=TAU)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv + ["--device", "cpu"])
    return rc, out.getvalue()


def test_train_cli_hosts_smoke():
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--scheme",
                     "delta", "--workers", "8", "--hosts", "2",
                     "--points", "200"])
    assert rc == 0
    assert "topology=2x4" in out and "transport=hier" in out
    # tier 0: 20 windows x ring(512 B, 4); tier 1: 20 x (2-1) x 4 x 8
    assert "tier 0 (intra-host): wire 15,360 B" in out
    assert "tier 1 (inter-host): wire 640 B" in out
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--scheme",
                     "delta", "--workers", "8", "--hosts", "2",
                     "--tier1-transport", "xla", "--points", "200"])
    assert rc == 0 and "tier 1 (inter-host): wire 10,240 B" in out


def test_train_cli_hosts_validation():
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--hosts", "3", "--points", "50"])
    assert rc == 2 and "equal host groups" in out
    rc, out = _main(["--mode", "vq", "--executor", "sim", "--workers", "8",
                     "--hosts", "2", "--points", "50"])
    assert rc == 2 and "needs --executor mesh" in out
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--hosts", "2", "--tier1-frac", "2.0", "--points",
                     "50"])
    assert rc == 2 and "compression frac" in out
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--hosts", "2", "--tier1-frac", "bogus", "--points",
                     "50"])
    assert rc == 2 and "--tier1-frac must be a float or 'auto'" in out
