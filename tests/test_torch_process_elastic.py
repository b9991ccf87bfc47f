"""``ElasticMeshExecutor`` with one worker a process, held against the
stacked elastic run and the reference's ``ElasticMeshExecutor``.

One 4-rank gloo world (``_torch_worlds.elastic_runs``) runs every elastic
configuration over processes once, on inputs made with numpy from a seed:
4 -> 2 -> 4 with its checkpoints (rank 0 writes them), a resume from each
(20 and 40 after the resizes, 30 inside the shrunk segment with ranks 2-3
idle), a resume from the reference's checkpoint, a chaos kill (4 -> 3)
and whole host groups leaving and returning (2 x 2 -> 1 x 2 -> 2 x 2).
Every rank returns the same result, the idle ranks' part of it from rank 0.

The process runs equal the stacked runs bit for bit, with equal resize
events, late points and ``CommLog``: the departing ranks' late windows are
gathered in rank order and summed as the stacked run sums them.  Against
the reference they agree at ``rtol=1e-4, atol=1e-6`` with equal events and
bytes, and the checkpoints cross packages both ways.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
from repro.engine import ChaosNetwork as JChaosNetwork
from repro.engine import ChaosSchedule as JSchedule
from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import InstantNetwork as JInstant
from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed import process_group
from repro_torch.engine import ElasticMeshExecutor

torch.set_num_threads(1)

TAU, D, KAPPA, M = 10, 8, 16, 4
RTOL, ATOL = 1e-4, 1e-6


def _setup(n=600, seed=42, n_eval=200):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(M, n))]
            + 0.05 * rng.standard_normal((M, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(M * n, KAPPA, replace=False)].copy()
    return {"w0": w0, "data": data, "eval": data[:, :n_eval].copy()}


def _args(ins):
    return [torch.from_numpy(ins[k]) for k in ("w0", "data", "eval")]


def _ref(ins, **kw):
    ex = JElastic(worlds.ELASTIC_SCHEDULE, network=JInstant(), **kw)
    return ex.run("delta", ins["w0"], ins["data"], ins["eval"], tau=TAU), ex


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ins = _setup()
    ckdir = tmp_path_factory.mktemp("elastic_ckpt")
    # the reference writes its resize checkpoints; the world resumes the
    # latest
    _ref(ins, checkpointer=JCheckpointer(str(ckdir / "ref")))
    outs = process_group.spawn(worlds.elastic_runs, M, ins, str(ckdir),
                               device="cpu")
    return ins, str(ckdir), outs


def _stacked(ins, name="flat", **kw):
    sched, cfg = worlds.elastic_config(name)
    ex = ElasticMeshExecutor(sched, device="cpu", **cfg, **kw)
    return worlds._result(ex, ex.run("delta", *_args(ins), tau=TAU))


def _events(jex):
    return [(e.window, e.old_m, e.new_m, e.late_points, e.cause)
            for e in jex.resize_events]


def _equal(got, want):
    """Codebook, curve and ticks bit for bit; ``CommLog``, events and late
    worker-windows equal."""
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("key", ["flat", "from_ref", "chaos", "hosts"])
def test_every_rank_returns_rank_0s_result(world, key):
    _, _, outs = world
    for r in range(1, M):
        _equal(outs[r][key], outs[0][key])


def test_4_2_4_equals_the_stacked_run_bitwise(world, tmp_path):
    ins, _, outs = world
    got = outs[0]["flat"]
    want = _stacked(ins, checkpointer=Checkpointer(str(tmp_path), keep=10),
                    checkpoint_every=worlds.ELASTIC_EVERY)
    _equal(got, want)
    assert got[4] == [(20, 4, 2, 20, "schedule", 20),
                      (40, 2, 4, 0, "schedule", 40)]
    assert got[3]["by_tag"]["late_delta"]["wire_bytes"] == 4 * KAPPA * D


def test_4_2_4_matches_the_reference(world):
    ins, _, outs = world
    w, curve, ticks, last, events, _ = outs[0]["flat"]
    ref, jex = _ref(ins)
    np.testing.assert_allclose(curve, np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(w, np.asarray(ref.w_shared), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ticks, np.asarray(ref.wall_ticks))
    assert [e[:5] for e in events] == _events(jex)
    assert last == jex.last_comm


def test_rank_0_wrote_every_checkpoint(world):
    _, ckdir, _ = world
    steps = Checkpointer(os.path.join(ckdir, "flat")).all_steps()
    # the periodic saves and the two resizes' post-event states
    assert steps == [10, 20, 30, 40, 50, 60]


@pytest.mark.parametrize("step", worlds.ELASTIC_RESUMES)
def test_resume_from_each_checkpoint_equals_straight_bitwise(world, step):
    _, _, outs = world
    w, curve, ticks, _, events, _ = outs[0][f"resume_{step}"]
    sw, scurve, sticks, _, sevents, _ = outs[0]["flat"]
    n = len(curve)
    assert 0 < n < len(scurve)
    np.testing.assert_array_equal(w, sw)
    np.testing.assert_array_equal(curve, scurve[-n:])
    np.testing.assert_array_equal(ticks, sticks[-n:])
    assert [e[:5] for e in events] == [e[:5] for e in sevents
                                       if e[0] > step]
    for r in range(1, M):
        _equal(outs[r][f"resume_{step}"], outs[0][f"resume_{step}"])


def test_the_reference_restores_a_process_runs_checkpoint(world, tmp_path):
    ins, ckdir, outs = world
    # the process run's step-30 checkpoint, inside the shrunk segment
    name = "step_000000030"
    shutil.copytree(os.path.join(ckdir, "flat", name), tmp_path / name)
    ref, _ = _ref(ins)
    res, jex = _ref(ins, checkpointer=JCheckpointer(str(tmp_path)),
                    resume=True)
    n = len(res.distortion)
    np.testing.assert_allclose(np.asarray(res.distortion),
                               np.asarray(ref.distortion)[-n:], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np.asarray(res.w_shared), outs[0]["flat"][0],
                               rtol=RTOL, atol=ATOL)
    assert _events(jex) == [(40, 2, 4, 0, "schedule")]


def test_a_process_run_restores_the_references_checkpoint(world):
    ins, ckdir, outs = world
    w, curve, ticks, _, events, _ = outs[0]["from_ref"]
    # the port's stacked resume from the same files, bit for bit
    want = _stacked(ins, checkpointer=Checkpointer(os.path.join(ckdir,
                                                                "ref")),
                    resume=True)
    _equal(outs[0]["from_ref"], want)
    ref, _ = _ref(ins)
    n = len(curve)
    np.testing.assert_allclose(curve, np.asarray(ref.distortion)[-n:],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w, np.asarray(ref.w_shared), rtol=RTOL,
                               atol=ATOL)
    assert events == []               # the latest step is after the grow


def test_chaos_kill_shrinks_4_to_3_as_the_stacked_run(world):
    ins, _, outs = world
    got = outs[0]["chaos"]
    _equal(got, _stacked(ins, "chaos"))
    assert [e[:5] for e in got[4]] == [(10, 4, 3, 10, "chaos_kill")]
    # the quirk: worker 1 was killed, rank 3 left, and the survivor at
    # index 1 is late in every window after the kill
    sched = JSchedule(worlds.ELASTIC_CHAOS, hosts=2)
    late = sched.late_matrix(3, 5, window0=11)
    assert late[1].all()
    jex = JElastic((), network=JChaosNetwork(JInstant(), sched), chaos=sched,
                   merge="quorum")
    ref = jex.run("delta", ins["w0"], ins["data"], ins["eval"], tau=TAU)
    assert [e[:5] for e in got[4]] == _events(jex)
    assert got[5] > 0
    np.testing.assert_allclose(got[1], np.asarray(ref.distortion),
                               rtol=RTOL, atol=ATOL)


def test_host_groups_leave_and_return_as_the_stacked_run(world):
    ins, _, outs = world
    got = outs[0]["hosts"]
    _equal(got, _stacked(ins, "hosts"))
    assert [e[:3] for e in got[4]] == [(20, 4, 2), (40, 2, 4)]
    late = got[3]["by_tag"]["late_delta"]
    assert late["by_tier"] == {1: {"calls": 1, "logical_bytes": 4 * KAPPA * D,
                                   "wire_bytes": 4 * KAPPA * D}}
