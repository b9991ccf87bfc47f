"""The port's failure injection (``repro_torch.engine.chaos``) held against
``repro.engine.chaos``, mirroring ``tests/test_chaos.py``: the schedule's
draws and late matrices bit for bit (host numpy Philox in both packages),
the ``ChaosNetwork`` overlay on the same base round lengths, the quorum
mesh under injected stragglers and chaos kills as unscheduled elastic
resizes against the reference at ``rtol=1e-4, atol=1e-6`` with equal
events, the kill-index quirk included (after a kill a survivor inherits
the dead worker's index and its late row); then, within the port, the
``on_window`` chunks, periodic checkpoints and resume bit for bit,
``publisher(skip_stale=True)``, eq. 9 over a ``ChaosNetwork`` against
``scheme_async``, and the launcher's ``--chaos``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import ChaosEvent as JEvent
from repro.engine import ChaosNetwork as JChaosNetwork
from repro.engine import ChaosSchedule as JSchedule
from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMesh
from repro.engine.network import NetworkModel as JNetworkModel
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import async_vq
from repro_torch.engine import (ChaosEvent, ChaosNetwork, ChaosSchedule,
                                ElasticMeshExecutor, GeometricDelayNetwork,
                                InstantNetwork, NetworkModel, Topology)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train
from repro_torch.serve.codebook_store import CodebookStore

torch.set_num_threads(1)

TAU, D, KAPPA = 10, 8, 16
RTOL, ATOL = 1e-4, 1e-6


def _setup(m, n=400, seed=42, n_eval=200):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _port(w0, data, eval_data):
    return interop.from_reference(w0, data, eval_data, device="cpu")


def _held(got, ref):
    np.testing.assert_allclose(got.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.w_shared.numpy(), np.asarray(ref.w_shared),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.wall_ticks.numpy(),
                                  np.asarray(ref.wall_ticks))


def _events(ex):
    return [(e.window, e.old_m, e.new_m, e.late_points, e.cause)
            for e in ex.resize_events]


class _FixedLengths(NetworkModel):
    """Round lengths given up front (the base of an overlay test)."""

    def __init__(self, base):
        self.base = base

    def round_lengths(self, generator, m, max_rounds, tau):
        return torch.from_numpy(self.base[:m, :max_rounds].copy())

    def window_ticks(self, tau):
        return tau


class _JFixedLengths(JNetworkModel):
    def __init__(self, base):
        self.base = base

    def round_lengths(self, key, m, max_rounds, tau):
        return jnp.asarray(self.base[:m, :max_rounds])

    def window_ticks(self, tau):
        return tau


# ---------------------------------------------------------------------------
# ChaosEvent, ChaosSchedule
# ---------------------------------------------------------------------------

def test_chaos_event_validation():
    for args, kw, msg in (((5, "meteor", 0), {}, "unknown chaos kind"),
                          ((0, "kill", 0), {}, "window must be >= 1"),
                          ((5, "kill", -1), {}, "target must be >= 0"),
                          ((5, "slow", 0), {"duration": 0},
                           "duration must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            ChaosEvent(*args, **kw)
    e = ChaosEvent(3, "slow", 1, 2)
    assert e.as_dict() == JEvent(3, "slow", 1, 2).as_dict()


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 12345])
@pytest.mark.parametrize("hosts,m,windows,counts", [
    (2, 8, 40, (2, 1, 1)), (1, 4, 40, (1, 1, 1)), (4, 8, 100, (3, 2, 2)),
    (2, 8, 12_500, (2, 1, 1)), (3, 6, 9, (0, 2, 1))])
def test_generate_equals_reference(seed, hosts, m, windows, counts):
    kills, slows, parts = counts
    kw = dict(windows=windows, m=m, kills=kills, slows=slows,
              partitions=parts, hosts=hosts)
    got = ChaosSchedule.generate(seed, **kw)
    want = JSchedule.generate(seed, **kw)
    assert [e.as_dict() for e in got] == [e.as_dict() for e in want]
    assert got.describe() == want.describe()
    assert [e.as_dict() for e in got.kill_events] == [
        e.as_dict() for e in want.kill_events]
    assert got.events_between(0, windows // 2) == tuple(
        ChaosEvent(**e.as_dict()) for e in want.events_between(
            0, windows // 2))
    spec = f"{seed}:kill={kills},slow={slows},part={parts}"
    from_spec = ChaosSchedule.from_spec(spec, windows=windows, m=m,
                                        hosts=hosts)
    assert [e.as_dict() for e in from_spec] == [e.as_dict() for e in want]


def test_generate_pins_the_committed_seed_7_draw():
    a = ChaosSchedule.generate(7, windows=40, m=8, kills=2, slows=1,
                               partitions=1, hosts=2)
    assert a.describe() == ("seed=7: slow@10:1,partition@19:1,"
                            "kill@21:3,kill@27:5")


def test_schedule_validation():
    with pytest.raises(ValueError, match="at least one must survive"):
        ChaosSchedule.generate(0, windows=40, m=2, kills=2)
    with pytest.raises(ValueError, match=">= 8 windows"):
        ChaosSchedule.generate(0, windows=4, m=8, kills=1)
    with pytest.raises(ValueError, match="do not fit"):
        ChaosSchedule.generate(0, windows=8, m=8, kills=2, slows=2,
                               partitions=1)
    with pytest.raises(ValueError, match="only die once"):
        ChaosSchedule([(5, "kill", 1), (7, "kill", 1)])
    with pytest.raises(ValueError, match="hosts"):
        ChaosSchedule([], hosts=0)
    assert len(ChaosSchedule.generate(0, windows=40, m=8)) == 0
    assert ChaosSchedule([]).describe() == "seed=0: no faults"
    for bad in ("banana", ":kill=1", "7:boom=1", "7:kill=x", "x:kill=1"):
        with pytest.raises(ValueError, match="bad chaos"):
            ChaosSchedule.from_spec(bad, windows=40, m=8)


EVENTS = [(3, "kill", 0), (2, "slow", 1, 2), (4, "partition", 1, 2),
          (6, "slow", 5, 3), (1, "partition", 0, 1), (9, "kill", 7)]


@pytest.mark.parametrize("m,n_windows,window0,hosts", [
    (8, 8, 0, 2), (8, 5, 3, 2), (1, 8, 0, 2), (6, 12, 0, 3), (8, 4, 20, 2),
    (3, 10, 2, 1)])
def test_late_matrix_equals_reference_bitwise(m, n_windows, window0, hosts):
    got = ChaosSchedule(EVENTS, hosts=hosts).late_matrix(
        m, n_windows, window0=window0)
    want = JSchedule(EVENTS, hosts=hosts).late_matrix(m, n_windows,
                                                      window0=window0)
    assert got.dtype == np.float32 and got.shape == (m, n_windows)
    np.testing.assert_array_equal(got, want)


def test_late_matrix_semantics():
    s = ChaosSchedule(EVENTS[:3], hosts=2)
    late = s.late_matrix(8, 8)
    np.testing.assert_array_equal(late[0], [0, 0, 0, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(late[1], [0, 0, 1, 1, 0, 0, 0, 0])
    for w in range(4, 8):
        np.testing.assert_array_equal(late[w], [0, 0, 0, 0, 1, 1, 0, 0])
    np.testing.assert_array_equal(s.late_matrix(8, 5, window0=3), late[:, 3:])
    assert s.late_matrix(1, 8)[0].sum() == 5


def test_kill_index_quirk_survivor_inherits_the_late_row():
    """After a kill the elastic run drops the dead worker, and its index
    names a survivor: the reference marks that survivor late from the kill
    window on, and the port does the same."""
    s = ChaosSchedule([(10, "kill", 1), (15, "kill", 2)], hosts=2)
    j = JSchedule([(10, "kill", 1), (15, "kill", 2)], hosts=2)
    for m, window0 in ((3, 10), (2, 15)):
        got = s.late_matrix(m, 5, window0=window0)
        np.testing.assert_array_equal(got, j.late_matrix(m, 5,
                                                         window0=window0))
        np.testing.assert_array_equal(got[1], np.ones(5, np.float32))


# ---------------------------------------------------------------------------
# ChaosNetwork
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slow_factor", [1, 4])
def test_round_lengths_overlay_equals_reference(slow_factor):
    rng = np.random.default_rng(slow_factor)
    base = (TAU + rng.integers(0, 5, size=(8, 30))).astype(np.int32)
    events = [(5, "kill", 0), (3, "slow", 1, 2), (7, "partition", 1, 3),
              (28, "slow", 2, 5), (40, "kill", 3)]
    got = ChaosNetwork(_FixedLengths(base), ChaosSchedule(events, hosts=2),
                       slow_factor=slow_factor).round_lengths(
        torch.Generator(), 8, 30, TAU)
    want = JChaosNetwork(_JFixedLengths(base), JSchedule(events, hosts=2),
                         slow_factor=slow_factor).round_lengths(
        jax.random.PRNGKey(0), 8, 30, TAU)
    assert got.dtype == torch.int32 and got.shape == (8, 30)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0, 5:].numpy(),
                                  np.full(25, ChaosNetwork.DEAD_TICKS))


def test_round_lengths_overlay_semantics():
    sched = ChaosSchedule([(5, "kill", 0), (3, "slow", 1, 2)], hosts=2)
    lengths = ChaosNetwork(InstantNetwork(), sched).round_lengths(
        torch.Generator(), 4, 10, TAU).numpy()
    np.testing.assert_array_equal(lengths[0, :5], np.full(5, TAU))
    np.testing.assert_array_equal(lengths[1],
                                  [10, 10, 10, 40, 40, 10, 10, 10, 10, 10])
    np.testing.assert_array_equal(lengths[2], np.full(10, TAU))


def test_late_matrix_is_the_union_and_pricing_passes_through():
    sched = [(2, "slow", 0, 3), (4, "partition", 1, 2)]
    for p in (0.3, 0.6):
        got = ChaosNetwork(GeometricDelayNetwork(p), ChaosSchedule(
            sched, hosts=2)).late_matrix(8, 10, 2, window0=1)
        want = JChaosNetwork(JGeometric(p), JSchedule(
            sched, hosts=2)).late_matrix(8, 10, 2, window0=1)
        np.testing.assert_array_equal(got, want)
    cn = ChaosNetwork(GeometricDelayNetwork(0.3), ChaosSchedule(sched))
    assert cn.window_ticks(TAU) == GeometricDelayNetwork(0.3).window_ticks(
        TAU)
    assert cn.transfer_ticks(1000, tier=1) == 0
    assert cn.events_between(0, 3) == (ChaosEvent(2, "slow", 0, 3),)
    # a real topology's host groups override the schedule's grouping
    topo = ChaosNetwork(InstantNetwork(), ChaosSchedule(sched, hosts=2),
                        topology=Topology.from_spec(8, hosts=4))
    assert topo.schedule.hosts == 4
    with pytest.raises(ValueError, match="slow_factor"):
        ChaosNetwork(InstantNetwork(), ChaosSchedule([]), slow_factor=0)


# ---------------------------------------------------------------------------
# the quorum mesh and the elastic executor under chaos, against the reference
# ---------------------------------------------------------------------------

def test_quorum_mesh_under_injected_stragglers_matches_reference():
    kw = dict(windows=40, m=4, slows=1, partitions=1, hosts=2)
    w0, data, eval_data = _setup(4)
    ref = JMesh(network=JChaosNetwork(JInstant(), JSchedule.generate(11, **kw)),
                merge="quorum").run("delta", w0, data, eval_data, tau=TAU)
    sched = ChaosSchedule.generate(11, **kw)
    ex = MeshExecutor(ChaosNetwork(InstantNetwork(), sched), merge="quorum",
                      device="cpu")
    got = ex.run("delta", *_port(w0, data, eval_data), tau=TAU)
    _held(got, ref)
    assert ex.last_late_worker_windows == int(sched.late_matrix(4, 40).sum())
    assert float(got.distortion[-1]) < float(got.distortion[0])


@pytest.mark.parametrize("events,resizes", [
    ([(10, "kill", 1), (15, "kill", 2)], []),
    ([(20, "kill", 0)], [(10, 2)]),
    ([(12, "kill", 1), (14, "slow", 0, 3), (30, "partition", 0, 2)],
     [(20, 4)]),
])
def test_chaos_kills_are_unscheduled_resizes_matching_reference(events,
                                                                resizes):
    w0, data, eval_data = _setup(4)
    jsched = JSchedule(events, hosts=2)
    jex = JElastic(resizes, network=JChaosNetwork(JInstant(), jsched),
                   chaos=jsched, merge="quorum")
    ref = jex.run("delta", w0, data, eval_data, tau=TAU)
    sched = ChaosSchedule(events, hosts=2)
    ex = ElasticMeshExecutor(resizes, network=ChaosNetwork(InstantNetwork(),
                                                           sched),
                             chaos=sched, merge="quorum", device="cpu")
    got = ex.run("delta", *_port(w0, data, eval_data), tau=TAU)
    assert _events(ex) == _events(jex)
    kills = [e.window for e in sched.kill_events]
    assert [e.window for e in ex.resize_events
            if e.cause == "chaos_kill"] == kills
    _held(got, ref)
    assert ex.last_comm == jex.last_comm
    # the late worker-windows are the segments' late matrices summed (the
    # survivor that inherits a killed index counts, as in the reference)
    bounds = [0] + [e.window for e in ex.resize_events] + [None]
    ms = [4] + [e.new_m for e in ex.resize_events]
    n_total = len(got.distortion)
    want, w = 0, 0
    for m, lo, hi in zip(ms, bounds[:-1], bounds[1:]):
        n = (n_total if hi is None else hi) - lo
        want += int(sched.late_matrix(m, n, window0=lo).sum())
        w += n
    assert w == n_total and ex.last_late_worker_windows == want
    assert float(got.distortion[-1]) < float(got.distortion[0])


# ---------------------------------------------------------------------------
# on_window, periodic checkpoints, resume, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("publish_every", [1, 3, 40])
def test_on_window_chunks_keep_the_bits(publish_every):
    args = _port(*_setup(4))
    seen = []
    hooked = MeshExecutor(InstantNetwork(), device="cpu",
                          publish_every=publish_every,
                          on_window=lambda i, w: seen.append((i, w.clone())))
    got = hooked.run("delta", *args, tau=TAU)
    plain = MeshExecutor(InstantNetwork(), device="cpu").run("delta", *args,
                                                             tau=TAU)
    assert torch.equal(got.distortion, plain.distortion)
    assert torch.equal(got.w_shared, plain.w_shared)
    assert torch.equal(got.wall_ticks, plain.wall_ticks)
    assert [i for i, _ in seen] == list(range(publish_every, 40,
                                              publish_every)) + [40]
    assert torch.equal(seen[-1][1], got.w_shared)
    # eq. 9 has no window barrier: one call, after the run
    calls = []
    MeshExecutor(GeometricDelayNetwork(0.5), device="cpu",
                 on_window=lambda i, w: calls.append(i)).run(
        "async_delta", *args, tau=TAU)
    assert calls == [40]


def test_elastic_on_window_sees_global_windows():
    store = CodebookStore(device="cpu")
    ex = ElasticMeshExecutor([(10, 2)], network=InstantNetwork(),
                             on_window=store.publisher(), publish_every=5,
                             device="cpu")
    res = ex.run("delta", *_port(*_setup(4)), tau=TAU)
    n = len(res.distortion)
    assert store.latest().step == n and store.version == -(-10 // 5) + (
        -(-(n - 10) // 5))
    np.testing.assert_array_equal(store.latest().w, res.w_shared.numpy())


def test_periodic_checkpoint_and_resume_bitwise(tmp_path):
    args = _port(*_setup(4))
    ck = Checkpointer(str(tmp_path))
    r1 = ElasticMeshExecutor([], network=InstantNetwork(), checkpointer=ck,
                             checkpoint_every=5, device="cpu").run(
        "delta", *args, tau=TAU)
    assert ck.all_steps() == [30, 35, 40]
    r2 = ElasticMeshExecutor([], network=InstantNetwork(), checkpointer=ck,
                             checkpoint_every=5, resume=True,
                             device="cpu").run("delta", *args, tau=TAU)
    # the last periodic save is the end of the run: its state, reported
    assert torch.equal(r1.w_shared, r2.w_shared) and len(r2.distortion) == 1
    # resuming mid-run (step 35 kept as the latest): the suffix, bit for bit
    (tmp_path / "step_000000040").rename(tmp_path / "step_000000040.tmp")
    r3 = ElasticMeshExecutor([], network=InstantNetwork(), checkpointer=ck,
                             checkpoint_every=5, resume=True,
                             device="cpu").run("delta", *args, tau=TAU)
    assert len(r3.distortion) == 5
    assert torch.equal(r1.w_shared, r3.w_shared)
    assert torch.equal(r1.distortion[-5:], r3.distortion)
    assert torch.equal(r1.wall_ticks[-5:], r3.wall_ticks)


def test_periodic_checkpoints_across_a_resize_resume_bitwise(tmp_path):
    args = _port(*_setup(4))
    ck = Checkpointer(str(tmp_path), keep=10)
    r1 = ElasticMeshExecutor([(12, 2)], network=InstantNetwork(),
                             checkpointer=ck, checkpoint_every=8,
                             device="cpu").run("delta", *args, tau=TAU)
    steps = ck.all_steps()
    assert steps[:3] == [8, 12, 16] and steps[-1] % 8 == 0
    for step in steps[2:]:
        (tmp_path / f"step_{step:09d}").rename(
            tmp_path / f"step_{step:09d}.tmp")
    r2 = ElasticMeshExecutor([(12, 2)], network=InstantNetwork(),
                             checkpointer=ck, checkpoint_every=8,
                             resume=True, device="cpu").run(
        "delta", *args, tau=TAU)
    n2 = len(r2.distortion)
    assert n2 == len(r1.distortion) - 12
    assert torch.equal(r1.w_shared, r2.w_shared)
    assert torch.equal(r1.distortion[-n2:], r2.distortion)


def test_checkpoint_every_validation():
    with pytest.raises(ValueError, match="checkpoint_every"):
        ElasticMeshExecutor([], checkpoint_every=0, checkpointer=object(),
                            device="cpu")
    with pytest.raises(ValueError, match="checkpointer"):
        ElasticMeshExecutor([], checkpoint_every=5, device="cpu")
    with pytest.raises(ValueError, match="publish_every"):
        ElasticMeshExecutor([], publish_every=0, device="cpu")


def test_publisher_skip_stale_drops_replayed_windows():
    store = CodebookStore(device="cpu")
    w = np.zeros((4, 2), np.float32)
    pub = store.publisher(skip_stale=True)
    pub(5, w)
    assert (store.version, store.latest().step) == (1, 5)
    pub(3, w)
    pub(5, w)
    assert store.version == 1
    pub(6, torch.ones(4, 2))
    assert (store.version, store.latest().step) == (2, 6)
    assert float(store.latest().w.sum()) == 8.0
    store.publisher()(3, w)
    assert store.version == 3


# ---------------------------------------------------------------------------
# eq. 9 over a ChaosNetwork
# ---------------------------------------------------------------------------

def test_eq9_over_chaos_network_matches_scheme_async():
    w0, data, eval_data = _port(*_setup(4, n=600))
    m, n = 4, 600
    sched = ChaosSchedule([(20, "kill", 2), (10, "slow", 0, 4)], hosts=2)
    net = ChaosNetwork(GeometricDelayNetwork(0.5), sched)
    lengths = net.round_lengths(torch.Generator().manual_seed(5), m,
                                n // TAU + 2, TAU)
    dones = async_vq.done_mask(lengths, m, n, TAU, torch.device("cpu"))
    # round 19, the last before the kill, completes at tick `last`; the
    # dead worker's column is zero after it
    last = int(lengths[2, :20].to(torch.int64).sum())
    assert bool(dones[last, 2]) and not bool(dones[last + 1:, 2].any())
    got = MeshExecutor(net, device="cpu").run(
        "async_delta", w0, data, eval_data, tau=TAU,
        generator=torch.Generator().manual_seed(5))
    want = async_vq.scheme_async(w0, data, eval_data, tau=TAU,
                                 lengths=lengths)
    assert torch.equal(got.wall_ticks, want.wall_ticks)
    np.testing.assert_allclose(got.distortion.numpy(),
                               want.distortion.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.w_shared.numpy(), want.w_shared.numpy(),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_chaos_run(tmp_path, capsys):
    rc = train.main([
        "--mode", "vq", "--executor", "mesh", "--scheme", "delta",
        "--workers", "4", "--points", "300", "--chaos", "3:kill=1,slow=1",
        "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "chaos: seed=3: kill@13:2,slow@16:0" in out
    assert "executor=elastic" in out
    assert "resize @window 13: M 4 -> 3 (late points merged: 10," in out
    assert "ckpt@13" in out
    # without a kill there is nothing to resize: the quorum mesh
    rc = train.main(["--mode", "vq", "--executor", "mesh", "--workers", "4",
                     "--points", "300", "--chaos", "3:slow=1,part=1",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "executor=mesh" in out


@pytest.mark.parametrize("argv,msg", [
    (["--executor", "mesh", "--chaos", "banana"], "bad chaos spec"),
    (["--executor", "mesh", "--scheme", "average", "--chaos", "3:kill=1"],
     "delta"),
    (["--executor", "mesh", "--chaos", "7:kill=1", "--scheme", "average"],
     "needs --scheme delta"),
    (["--executor", "sim", "--chaos", "7:kill=1"], "injects faults"),
    (["--executor", "mesh", "--chaos", "7:kill=1", "--merge", "dynamic"],
     "conflicts with --chaos"),
    (["--executor", "mesh", "--chaos", "7:kill=1", "--wire-quant", "int8"],
     "--wire-quant does not compose"),
])
def test_train_cli_chaos_refusals(argv, msg, capsys):
    rc = train.main(["--mode", "vq", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert rc == 2 and any(line.startswith("error: ") and msg in line
                           for line in out.splitlines())
