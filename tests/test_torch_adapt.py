"""The port's adaptive communication held against ``repro``: the
divergence-triggered ``DynamicMerge``, the re-pricing of its merge records
(``CommLog.rewrite_since``), a quantized wire over a hierarchical
transport, and the ``Tier1BudgetController``.

Inputs are made with numpy from a seed and handed to both packages through
``repro_torch.interop``, except the ``BENCH_adapt.json`` cell, which runs on
the reference's own data (its ``synthetic`` stream from ``PRNGKey(0)``, as
``repro.comm.sweep.run_adapt_cells`` makes it).  Bit for bit: the dynamic
merge at threshold 0 against the plain delta merge (the port's contract),
trigger bits and wire bytes against the reference.  Curves and codebooks
against the reference's mesh: ``rtol=1e-4, atol=1e-6``.

``BENCH_adapt.json`` records 18 of 24 triggered windows at threshold 2e-5;
the reference run today on its own data, with the JAX this repository
installs, triggers 16 (its data stream differs from the one the file was
written from: its fixed-tau final distortion reads 0.01960, the file's
0.02072).  So the test holds the file's per-window prices (merge and probe,
each quantization) at its 18 triggers, and the port's trigger bits and
bytes to the reference's live run.
"""

import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import get_transport as jget_transport
from repro.data import synthetic as jsynthetic
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro.engine import Tier1BudgetController as JController
from repro.engine import get_network as jget_network
from repro.obs import Tracer
from repro_torch import comm, interop
from repro_torch.comm import (QUANT_WIDTH, HierarchicalTransport,
                              SparseTransport, get_transport, ring_wire_bytes,
                              topk_count)
from repro_torch.comm.sweep import acceptance_sparse_frac
from repro_torch.engine import (InstantNetwork, Tier1BudgetController,
                                Topology, get_network)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
D, KAPPA = 8, 16
FRAC_Q = acceptance_sparse_frac(KAPPA, D)
RTOL, ATOL = 1e-4, 1e-6
REPO = Path(__file__).resolve().parents[1]
BENCH_THRESH = 2e-5


def _setup(m, n=400, seed=42, n_eval=200):
    """Reference-shaped inputs, numpy (as tests/test_torch_comm.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _run(m, transport, n=400, *, network=None, inputs=None, **ex_kw):
    w0, data, eval_data = _setup(m, n) if inputs is None else inputs
    ex = MeshExecutor(network or InstantNetwork(), transport=transport,
                      device="cpu", **ex_kw)
    res = ex.run("delta", *interop.from_reference(w0, data, eval_data,
                                                  device="cpu"), tau=TAU)
    return res, ex


def _ref_run(m, transport, n=400, *, inputs=None, **ex_kw):
    """The reference mesh with a tracer on: its merge spans carry each
    window's trigger bit."""
    w0, data, eval_data = _setup(m, n) if inputs is None else inputs
    tr = Tracer()
    ex = JMeshExecutor(network=JInstant(), transport=transport, tracer=tr,
                       **ex_kw)
    res = ex.run("delta", jnp.asarray(w0), jnp.asarray(data),
                 jnp.asarray(eval_data), tau=TAU)
    bits = [int(s.attrs["triggered"]) for s in tr.spans("merge")
            if "triggered" in s.attrs]
    return res, ex, bits


def _bench_inputs():
    """``repro.comm.sweep.run_adapt_cells``'s workload at the bench cell:
    m=8, n=240, d=8, kappa=16 from ``PRNGKey(0)``."""
    kd, kw, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    data = jsynthetic.replicate_stream(kd, 8, n=240, d=D)
    w0 = jsynthetic.kmeanspp_init(kw, data.reshape(-1, D), KAPPA)
    return (np.asarray(w0), np.asarray(data), np.asarray(data[:, :200]))


# ---------------------------------------------------------------------------
# the dynamic merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["xla", "ring"])
@pytest.mark.parametrize("m", [1, 8])
def test_dynamic_thresh0_bitmatches_delta(m, transport):
    ref, ex_ref = _run(m, get_transport(transport))
    dyn, ex_dyn = _run(m, get_transport(transport), merge="dynamic",
                       divergence_thresh=0.0)
    assert torch.equal(ref.distortion, dyn.distortion)
    assert torch.equal(ref.w_shared, dyn.w_shared)
    assert torch.equal(ref.wall_ticks, dyn.wall_ticks)
    assert bool(ex_dyn.last_triggers.all())
    assert (ex_dyn.last_comm["by_tag"]["merge"]
            == ex_ref.last_comm["by_tag"]["merge"])
    # the probe: 4 bytes a worker, every window
    probe = ex_dyn.last_comm["by_tag"]["probe"]
    assert probe["calls"] == 40
    assert probe["wire_bytes"] == 40 * ring_wire_bytes(4, m)


@pytest.mark.devices(8)
def test_dynamic_skips_reprices_and_matches_reference():
    n, m = 400, 8
    n_windows = n // TAU
    _, ex_ref = _run(m, get_transport("xla"), n=n)
    dyn, ex = _run(m, get_transport("xla"), n=n, merge="dynamic",
                   divergence_thresh=1e-3, max_stale=8)
    merge = ex.last_comm["by_tag"]["merge"]
    probe = ex.last_comm["by_tag"]["probe"]
    n_trig = merge["calls"]
    assert 0 < n_trig < n_windows
    assert n_trig == int(ex.last_triggers.sum())
    per_window = ring_wire_bytes(KAPPA * D * 4, m)
    assert merge["wire_bytes"] == per_window * n_trig
    assert probe["calls"] == n_windows
    assert (merge["wire_bytes"] + probe["wire_bytes"]
            < ex_ref.last_comm["by_tag"]["merge"]["wire_bytes"])
    theirs, jex, bits = _ref_run(m, jget_transport("xla"), n=n,
                                 merge="dynamic", divergence_thresh=1e-3,
                                 max_stale=8)
    assert ex.last_triggers.int().tolist() == bits
    # (the reference's tracer widens its eval reduce; merge and probe agree)
    for tag in ("merge", "probe"):
        assert ex.last_comm["by_tag"][tag] == jex.last_comm["by_tag"][tag]
    np.testing.assert_allclose(dyn.distortion.numpy(),
                               np.asarray(theirs.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dyn.w_shared.numpy(),
                               np.asarray(theirs.w_shared), rtol=RTOL,
                               atol=ATOL)


def test_dynamic_max_stale_forces_syncs():
    n, max_stale = 400, 4
    n_windows = n // TAU
    _, ex = _run(8, get_transport("xla"), n=n, merge="dynamic",
                 divergence_thresh=1e9, max_stale=max_stale)
    assert ex.last_comm["by_tag"]["merge"]["calls"] == n_windows // max_stale
    assert ex.last_triggers.tolist() == [
        float((i + 1) % max_stale == 0) for i in range(n_windows)]


def test_dynamic_never_triggered_drops_the_merge_record():
    _, ex = _run(8, get_transport("xla"), n=40, merge="dynamic",
                 divergence_thresh=1e9, max_stale=8)
    assert "merge" not in ex.last_comm["by_tag"]
    assert ex.last_comm["by_tag"]["probe"]["calls"] == 4


def test_dynamic_rejects_bad_params():
    with pytest.raises(ValueError, match="divergence_thresh"):
        MeshExecutor(InstantNetwork(), merge="dynamic",
                     divergence_thresh=-1.0, device="cpu")
    with pytest.raises(ValueError, match="max_stale"):
        MeshExecutor(InstantNetwork(), merge="dynamic", max_stale=0,
                     device="cpu")
    w0, data, eval_data = _setup(1, n=40)
    ex = MeshExecutor(InstantNetwork(), merge="dynamic", device="cpu")
    for scheme in ("average", "async_delta"):
        with pytest.raises(ValueError, match="delta"):
            ex.run(scheme, *interop.from_reference(w0, data, eval_data,
                                                   device="cpu"), tau=TAU)


def test_dynamic_composes_with_quant():
    dyn, ex = _run(8, get_transport("quant", inner="xla", mode="int8"),
                   merge="dynamic", divergence_thresh=1e-3)
    merge = ex.last_comm["by_tag"]["merge"]
    n_trig = merge["calls"]
    assert 0 < n_trig < 400 // TAU
    per_window = ring_wire_bytes(KAPPA * D * 4, 8) // 4 + 4
    assert merge["wire_bytes"] == per_window * n_trig
    # the probe rides the int8 wire too: 7 B of ring -> 1 B + 4 B scale
    assert ex.last_comm["by_tag"]["probe"]["wire_bytes"] == 40 * 5
    assert np.isfinite(float(dyn.distortion[-1]))


@pytest.mark.devices(8)
@pytest.mark.parametrize("quant", ["dense", "bf16", "int8"])
def test_dynamic_bench_cell_bytes(quant):
    """The ``BENCH_adapt.json`` dynamic cell: its per-window merge and probe
    prices at its 18 triggers give its totals; on the reference's own data
    the port triggers in the reference's windows and moves its bytes."""
    bench = json.loads((REPO / "BENCH_adapt.json").read_text())
    cell = next(r for r in bench["results"] if r.get("kind") == "cell"
                and r["merge"] == "dynamic" and r["quant"] == quant)
    assert (cell["m"], cell["n"], cell["thresh"]) == (8, 240, BENCH_THRESH)
    dense = ring_wire_bytes(4 * KAPPA * D, 8)
    per_merge = dense * QUANT_WIDTH.get(quant, 4) // 4
    per_probe = ring_wire_bytes(4, 8) * QUANT_WIDTH.get(quant, 4) // 4
    if quant == "int8":
        per_merge, per_probe = per_merge + 4, per_probe + 4
    assert cell["merge_wire_bytes"] == cell["n_triggered"] * per_merge
    assert cell["probe_wire_bytes"] == cell["n_windows"] * per_probe
    assert cell["total_wire_bytes"] == {"dense": 16_296, "bf16": 8_136,
                                        "int8": 4_224}[quant]
    inputs = _bench_inputs()
    t = ("xla" if quant == "dense" else
         get_transport("quant", inner="xla", mode=quant))
    jt = (jget_transport("xla") if quant == "dense" else
          jget_transport("quant", inner="xla", mode=quant))
    _, ex = _run(8, t, 240, inputs=inputs, merge="dynamic",
                 divergence_thresh=BENCH_THRESH)
    _, jex, bits = _ref_run(8, jt, 240, inputs=inputs, merge="dynamic",
                            divergence_thresh=BENCH_THRESH)
    assert ex.last_triggers.int().tolist() == bits
    n_trig = sum(bits)
    by_tag = ex.last_comm["by_tag"]
    assert by_tag["merge"]["wire_bytes"] == n_trig * per_merge
    assert by_tag["probe"]["wire_bytes"] == 24 * per_probe
    for tag in ("merge", "probe"):
        assert by_tag[tag] == jex.last_comm["by_tag"][tag]


def test_commlog_rewrite_since_reprices_folded_records():
    """A folded record's ``calls`` is what a rewrite re-prices; records
    before the mark are untouched; ``None`` drops one; the summaries and
    ``logical_bytes_by_tag`` follow, with tiered records under
    ``by_tier``."""
    log = comm.CommLog()
    log.append(comm.CommRecord("sum", "xla", "workers", 8, 512, 896))
    mark = log.mark()
    for _ in range(5):
        log.append(comm.CommRecord("masked_sum", "xla", "workers", 4, 512,
                                   768, tier=0))
        log.append(comm.CommRecord("sum", "sparse", "hosts", 2, 512, 32,
                                   tier=1))
        log.append(comm.CommRecord("sum", "xla", "workers", 8, 4, 7,
                                   tag="probe"))
    assert [r.calls for r in log.since(mark)] == [5, 5, 5]
    log.rewrite_since(mark, lambda r: r if r.tag == "probe" else (
        None if r.tier == 1 else comm.CommRecord(
            r.op, r.transport, r.axis, r.participants, r.logical_bytes,
            r.wire_bytes, calls=2, tag=r.tag, tier=r.tier)))
    s = comm.CommLog.summarize(log.since(mark))
    assert s["by_tag"]["merge"] == {
        "calls": 2, "logical_bytes": 1024, "wire_bytes": 1536,
        "by_tier": {0: {"calls": 2, "logical_bytes": 1024,
                        "wire_bytes": 1536}}}
    assert s["by_tag"]["probe"] == {"calls": 5, "logical_bytes": 20,
                                    "wire_bytes": 35}
    assert log.logical_bytes_by_tag() == {"merge": 512 + 1024, "probe": 20}
    assert log.records[0].calls == 1
    # a rewrite closes the folding window: the next record starts anew
    log.append(comm.CommRecord("sum", "xla", "workers", 8, 4, 7,
                               tag="probe"))
    assert [r.calls for r in log.since(mark)] == [2, 5, 1]


# ---------------------------------------------------------------------------
# a quantized wire over the hierarchy keeps its tiers
# ---------------------------------------------------------------------------

def test_quant_over_hier_preserves_tiers():
    topo = Topology.from_spec(8, hosts=2)
    hier = HierarchicalTransport("xla", SparseTransport(frac=FRAC_Q),
                                 topology=topo)
    res, ex = _run(8, get_transport("quant", inner=hier, mode="int8"),
                   topology=topo)
    by_tier = ex.last_comm["by_tag"]["merge"]["by_tier"]
    assert set(by_tier) == {0, 1}
    n_windows = 400 // TAU
    t0_dense = ring_wire_bytes(KAPPA * D * 4, 4)
    assert by_tier[0]["wire_bytes"] == (t0_dense // 4 + 4) * n_windows
    k = topk_count(KAPPA * D, FRAC_Q)
    assert by_tier[1]["wire_bytes"] == ((2 - 1) * k * 8 * 5 // 8 + 4) * (
        n_windows)
    assert np.isfinite(float(res.distortion[-1]))
    assert ex.topology == topo


# ---------------------------------------------------------------------------
# the tier-1 budget controller
# ---------------------------------------------------------------------------

def test_tier1_controller_ladder_matches_reference():
    net = get_network("fixed", latency_ticks=1, dcn_bytes_per_tick=100)
    jnet = jget_network("fixed", latency_ticks=1, dcn_bytes_per_tick=100)
    ctl = Tier1BudgetController(net, budget_ticks=2, min_frac=1 / 64,
                                max_frac=1.0)
    jctl = JController(jnet, budget_ticks=2, min_frac=1 / 64, max_frac=1.0)
    sp = SparseTransport(frac=0.25)
    jsp = jget_transport("sparse", frac=0.25)
    assert ctl.update(sp, 1000) == jctl.update(jsp, 1000) == 0.125
    wires = [1000] * 10 + [50, 150] + [0] * 10
    for wire in wires:
        assert ctl.update(sp, wire) == jctl.update(jsp, wire)
    assert sp.frac == jsp.frac == pytest.approx(1.0)
    assert ctl.last_frac == jctl.last_frac


def test_tier1_controller_target_resolution():
    net = get_network("fixed", dcn_bytes_per_tick=100)
    ctl = Tier1BudgetController(net)
    assert ctl.update(get_transport("xla"), 1000) is None
    q = get_transport("quant", inner="sparse", mode="bf16", frac=0.5)
    assert ctl.update(q, 10_000) == pytest.approx(0.25)
    assert q.inner.frac == pytest.approx(0.25)
    hier = HierarchicalTransport(topology=Topology.from_spec(8, hosts=2),
                                 tier1_frac=0.5)
    assert ctl.update(hier, 10_000) == pytest.approx(0.25)
    assert hier.tier1_frac == pytest.approx(0.25)


def test_tier1_controller_rejects_bad_params():
    net = InstantNetwork()
    with pytest.raises(ValueError, match="budget_ticks"):
        Tier1BudgetController(net, budget_ticks=0)
    with pytest.raises(ValueError, match="min_frac"):
        Tier1BudgetController(net, min_frac=0.5, max_frac=0.25)
    with pytest.raises(ValueError, match="low_water"):
        Tier1BudgetController(net, low_water=1.5)
    with pytest.raises(ValueError, match="publish_every"):
        MeshExecutor(net, publish_every=0, device="cpu")


@pytest.mark.devices(8)
def test_tier1_controller_mesh_integration():
    """A slow DCN drives the sparse tier-1 frac down chunk by chunk; the
    trajectory is the ladder replayed from each chunk's exact tier-1 bytes
    and equals the reference's; the chunked run equals one unchunked run
    at a frac that does not move (bit for bit)."""
    topo = Topology.from_spec(8, hosts=2)
    hier = HierarchicalTransport("xla", SparseTransport(frac=0.5),
                                 topology=topo)
    net = get_network("fixed", latency_ticks=1, dcn_bytes_per_tick=8)
    ctl = Tier1BudgetController(net, budget_ticks=2)
    res, ex = _run(8, hier, network=net, tier1_controller=ctl,
                   publish_every=8)
    assert ex.last_tier1_fracs[-1] == ctl.last_frac < 0.5
    assert hier.tier1.frac == ctl.last_frac
    assert np.isfinite(float(res.distortion[-1]))
    # host replay: chunk c ran at frac_c, moving (2-1) * k(frac_c) * 8 B a
    # window on tier 1
    replay, frac = [], 0.5
    replica = Tier1BudgetController(net, budget_ticks=2)
    probe = SparseTransport(frac=frac)
    for _ in range(400 // TAU // 8):
        wire = (2 - 1) * topk_count(KAPPA * D, probe.frac) * 8
        replay.append(replica.update(probe, wire))
    assert ex.last_tier1_fracs == replay
    # the reference's controller over its mesh lands on the same frac
    from repro.comm import HierarchicalTransport as JHier
    from repro.topology import Topology as JTopology
    jtopo = JTopology.from_spec(8, hosts=2)
    jhier = JHier(tier0="xla", tier1="sparse", tier1_frac=0.5)
    jnet = jget_network("fixed", latency_ticks=1, dcn_bytes_per_tick=8)
    jctl = JController(jnet, budget_ticks=2)
    w0, data, eval_data = _setup(8)
    theirs = JMeshExecutor(network=jnet, topology=jtopo, transport=jhier,
                           tier1_controller=jctl, publish_every=8).run(
        "delta", jnp.asarray(w0), jnp.asarray(data), jnp.asarray(eval_data),
        tau=TAU)
    assert jctl.last_frac == ctl.last_frac
    np.testing.assert_array_equal(res.wall_ticks.numpy(),
                                  np.asarray(theirs.wall_ticks))
    # the chunks change nothing but frac: at a fixed frac (dense tier 1),
    # the chunked run equals the plain one
    dense = HierarchicalTransport("xla", "xla", topology=topo)
    chunked, _ = _run(8, dense, tier1_controller=ctl, publish_every=8)
    whole, _ = _run(8, HierarchicalTransport("xla", "xla", topology=topo))
    assert torch.equal(chunked.distortion, whole.distortion)
    assert torch.equal(chunked.w_shared, whole.w_shared)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv + ["--device", "cpu"])
    return rc, out.getvalue()


def test_train_cli_dynamic_int8():
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--points", "200", "--scheme", "delta", "--merge",
                     "dynamic", "--divergence-thresh", "0.001",
                     "--wire-quant", "int8"])
    assert rc == 0
    assert "quant[int8:xla]" in out and "done:" in out
    assert "probe: wire 100 B over 20 windows" in out


def test_train_cli_tier1_auto():
    rc, out = _main(["--mode", "vq", "--executor", "mesh", "--workers", "8",
                     "--hosts", "2", "--points", "200", "--tier1-frac",
                     "auto", "--network", "fixed"])
    assert rc == 0 and "tier 1 (inter-host)" in out


def test_train_cli_rejects_bad_combos():
    for argv in (["--executor", "sim", "--merge", "dynamic"],
                 ["--executor", "mesh", "--merge", "dynamic", "--scheme",
                  "average"],
                 ["--executor", "mesh", "--merge", "dynamic", "--quorum"],
                 ["--executor", "mesh", "--hosts", "2", "--tier1-frac",
                  "bogus"],
                 ["--executor", "mesh", "--tier1-frac", "auto"],
                 ["--executor", "sim", "--tier1-frac", "auto"]):
        rc, out = _main(["--mode", "vq", "--workers", "8", "--points", "40"]
                        + argv)
        assert rc == 2 and out.startswith("error: "), argv
