"""``QuantizeService`` over a process group, held against the direct plan
and the reference's ``ShardedLookup``.

One 4-rank gloo world (``_torch_worlds.serve_runs``) serves the same
queries under ``auto`` routing and both sharded plans: rank 0 runs the
service, the store and the load, ranks 1-3 run ``follow``, and a second
codebook is published mid-load, so the followers take a header, the batch
and, on the version change, the codebook.  The responses equal the
one-process ``direct`` plan bit for bit and match the reference's
``ShardedLookup(n_devices=4)`` (equal assignments but near-ties, min
distances at ``rtol=1e-4``); warm-ups, flushes and the stop are counted on
every rank.  A kernel that raises on rank 2 fails that flush on every rank
and the world goes on to its end (the spawn is joined with a timeout).
Then ``launch.serve --mode vq`` runs in the world, with and without
``--train-publish``, and exits 0 with rank 0's report.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.serve.lookup import ShardedLookup as JLookup
from repro_torch.distributed import process_group
from repro_torch.serve import QuantizeResponse, ServiceStats
from repro_torch.serve.lookup import ShardedLookup

torch.set_num_threads(1)

P, D, KAPPA = 4, 16, 64
N_REQUESTS = 60
#: seconds the world may take before the test calls it hung
WORLD_TIMEOUT_S = 300
MODES = ("auto", "shard_batch", "shard_kappa")
ARGVS = [["--mode", "vq", "--requests", "200", "--kappa", str(KAPPA),
          "--dim", str(D), "--device", "cpu"],
         ["--mode", "vq", "--smoke", "--requests", "30", "--dim", "8",
          "--kappa", "8", "--train-publish", "--points", "100", "--tick-ms",
          "0.2", "--device", "cpu"]]


def _inputs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    w = rng.standard_normal((KAPPA, D)).astype(f32)
    w2 = (w + 0.1 * rng.standard_normal((KAPPA, D))).astype(f32)
    queries = [rng.standard_normal((int(rng.integers(1, 4)), D)).astype(f32)
               for _ in range(N_REQUESTS)]
    return {"w": w, "w2": w2, "queries": queries}


@pytest.fixture(scope="module")
def world():
    ins = _inputs()
    box = []
    t = threading.Thread(target=lambda: box.append(process_group.spawn(
        worlds.serve_runs, P, ins, ARGVS, device="cpu")), daemon=True)
    t.start()
    t.join(WORLD_TIMEOUT_S)
    assert box, f"the world did not end within {WORLD_TIMEOUT_S} s"
    return ins, box[0]


def _codebook(ins, version):
    return ins["w"] if version == 1 else ins["w2"]


@pytest.mark.parametrize("mode", MODES)
def test_service_over_the_group_equals_direct_bitwise(world, mode):
    ins, outs = world
    got, stats, _, _, calls = outs[0][mode]
    direct = ShardedLookup(device="cpu")
    # every lookup call, the warm-ups' included, on its padded batch
    assert len(calls) == stats.flushes + stats.warmups
    for z, w, a, m in calls:
        want_a, want_m = direct.assign(z, w)
        np.testing.assert_array_equal(a, want_a.numpy())
        np.testing.assert_array_equal(m.view(np.uint32),
                                      want_m.numpy().view(np.uint32))
    # each response is its rows of a flush, served by the version it names
    half = N_REQUESTS // 2
    for i, (q, r) in enumerate(zip(ins["queries"], got)):
        assert isinstance(r, QuantizeResponse)
        assert r.version == (1 if i < half else 2)
        a, m = direct.assign(q, _codebook(ins, r.version))
        np.testing.assert_array_equal(r.assign, a.numpy())
        np.testing.assert_allclose(r.mindist, m.numpy(), rtol=1e-6)
    assert stats.failed == 0 and stats.requests == N_REQUESTS


@pytest.mark.devices(4)
@pytest.mark.parametrize("mode", ["shard_batch", "shard_kappa"])
def test_service_over_the_group_matches_the_reference(world, mode):
    ins, outs = world
    got = outs[0][mode][0]
    half = N_REQUESTS // 2
    for version, sl in ((1, slice(0, half)), (2, slice(half, None))):
        z = np.concatenate(ins["queries"][sl])
        w = _codebook(ins, version)
        # the reference's sharded plans take whole shards: pad with zeros
        pad = np.zeros(((-len(z)) % P, D), np.float32)
        ja, jm = JLookup(n_devices=P, mode=mode).assign(
            jnp.asarray(np.concatenate([z, pad])), jnp.asarray(w))
        ja, jm = np.asarray(ja)[:len(z)], np.asarray(jm)[:len(z)]
        a = np.concatenate([r.assign for r in got[sl]])
        m = np.concatenate([r.mindist for r in got[sl]])
        np.testing.assert_allclose(m, jm, rtol=1e-4, atol=1e-6)
        # the flip rule: an assignment may differ only where the two
        # prototypes' distances tie within the rounding
        d = ((z[:, None, :] - w[None]) ** 2).sum(-1).astype(np.float64)
        flips = np.nonzero(a != ja)[0]
        rows = np.arange(len(z))
        gap = np.abs(d[rows, a] - d[rows, ja])[flips]
        assert np.all(gap <= 1e-5 * np.maximum(d[rows, a][flips], 1.0))


@pytest.mark.parametrize("mode", MODES)
def test_warmups_flushes_and_stop_counted_on_every_rank(world, mode):
    _, outs = world
    lead = outs[0][mode][1]
    assert lead.warmups == 2              # 128 and max_batch's 512 rows
    for r in range(1, P):
        st = outs[r][mode]                 # follow() returned: the stop
        assert isinstance(st, ServiceStats)
        assert (st.warmups, st.flushes, st.rows, st.padded_rows,
                st.failed) == (lead.warmups, lead.flushes, lead.rows,
                               lead.padded_rows, 0)


def test_batch_align_and_max_batch_follow_the_shards(world):
    _, outs = world
    for mode in MODES:
        align, max_batch = outs[0][mode][2:4]
        assert (align, max_batch) == (128, 128 * P)


def test_a_failing_follower_fails_every_rank_without_hanging(world):
    ins, outs = world
    got, lead = outs[0]["failing"][:2]
    failed = [r for r in got if isinstance(r, Exception)]
    served = [(q, r) for q, r in zip(ins["queries"], got)
              if not isinstance(r, Exception)]
    assert failed and served
    assert all("failed on another rank" in str(e) for e in failed)
    assert lead.failed == len(failed)
    direct = ShardedLookup(device="cpu")
    for q, r in served:
        np.testing.assert_array_equal(r.assign,
                                      direct.assign(q, ins["w"])[0].numpy())
    for r in range(1, P):
        st = outs[r]["failing"]
        assert st.failed == 1 and st.flushes == lead.flushes


def test_launcher_serves_across_the_world(world):
    _, outs = world
    code, out = outs[0]["launcher"][0]
    assert code == 0
    assert f"serve: devices={P} plan=shard_batch max_batch={128 * P}" in out
    assert "200 req (200 rows, 0 failed)" in out
    assert "monotonic=True" in out and "warmups=2" in out
    assert "per rank: flushes [" in out
    for r in range(1, P):
        assert outs[r]["launcher"][0] == (0, "")    # rank 0 prints


def test_train_publish_across_the_world(world):
    _, outs = world
    code, out = outs[0]["launcher"][1]
    assert code == 0
    assert "train-publish" in out and "0 failed" in out
    assert "monotonic=True" in out
    assert "trainer published" in out
    for r in range(1, P):
        assert outs[r]["launcher"][1] == (0, "")
