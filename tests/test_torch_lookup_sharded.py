"""``ShardedLookup``'s ``shard_batch`` and ``shard_kappa`` plans over a
process group, held against the direct plan and the reference's lookup.

One 4-rank gloo world (``_torch_worlds.lookups``) runs both plans on a
query batch and codebooks made with numpy from a seed: kappa 64, the
ragged kappa 67 (the last rank's rows padded with ``_PAD_FILL``) and a
tie-heavy codebook whose duplicate rows sit on different ranks.  Both plans
must equal the direct plan bit for bit, ties going to the lowest index
(the reference's first-occurrence rule), and the reference's lookup on the
same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.serve.lookup import ShardedLookup as JLookup
from repro_torch.distributed import process_group
from repro_torch.serve import lookup
from repro_torch.serve.lookup import ShardedLookup

torch.set_num_threads(1)

D = 8


def _inputs():
    rng = np.random.default_rng(31)
    f32 = np.float32
    w64 = rng.standard_normal((64, D)).astype(f32)
    w67 = rng.standard_normal((67, D)).astype(f32)
    # 16 distinct rows, each repeated on every rank's 16-row slice: every
    # query ties across the four shards
    ties = np.tile(np.round(rng.standard_normal((16, D)), 1), (4, 1))
    z = rng.standard_normal((32, D)).astype(f32)
    z[:8] = ties[:8] + 0.0          # exact hits: zero distance, four ties
    return {"z": z, "w64": w64, "w67": w67, "ties": ties.astype(f32)}


@pytest.fixture(scope="module")
def world():
    ins = _inputs()
    return ins, process_group.spawn(worlds.lookups, 4, ins, device="cpu")


@pytest.mark.parametrize("name", ["w64", "w67", "ties"])
@pytest.mark.parametrize("mode", ["shard_batch", "shard_kappa"])
def test_sharded_plan_equals_direct_bitwise(world, name, mode):
    ins, outs = world
    a, m = ShardedLookup(device="cpu").assign(ins["z"], ins[name])
    for r in range(4):
        got_a, got_m = outs[r][f"{name}_{mode}"]
        np.testing.assert_array_equal(got_a, a.numpy())
        np.testing.assert_array_equal(got_m.view(np.uint32),
                                      m.numpy().view(np.uint32))
        assert got_a.dtype == np.int32


@pytest.mark.devices(4)
@pytest.mark.parametrize("name", ["w64", "w67", "ties"])
def test_sharded_plans_match_the_reference_lookup(world, name):
    ins, outs = world
    for mode in ("shard_batch", "shard_kappa"):
        ja, jm = JLookup(n_devices=4, mode=mode).assign(
            jnp.asarray(ins["z"]), jnp.asarray(ins[name]))
        got_a, got_m = outs[0][f"{name}_{mode}"]
        np.testing.assert_array_equal(got_a, np.asarray(ja))
        # the exact hits' distances cancel to ~0 in the expansion
        # ||z||^2 - 2 z.w + ||w||^2, where each package's f32 rounding of
        # terms near 10 leaves a few 1e-6
        np.testing.assert_allclose(got_m, np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)


def test_ties_go_to_the_lowest_index(world):
    _, outs = world
    # the exact hits: the same distance on all four shards, the first copy
    # (rank 0's rows) wins
    for mode in ("shard_batch", "shard_kappa"):
        np.testing.assert_array_equal(outs[0][f"ties_{mode}"][0][:8],
                                      np.arange(8))


def test_auto_routing_and_validation(world):
    ins, outs = world
    for o in outs:
        assert o["n_shards"] == 4
        # fits the budget: shard_batch; a 1,024 B budget: shard_kappa; one
        # shard: direct (the reference's plan())
        assert o["plans"] == ("shard_batch", "shard_kappa", "direct")
        np.testing.assert_array_equal(o["auto"][0],
                                      o["w64_shard_batch"][0])
        assert "must be a multiple of 4 shards" in o["errors"]["batch"]
        assert "n_devices" in o["errors"]["n_devices"]
        assert "unknown lookup mode" in o["errors"]["mode"]


def test_routing_matches_reference_plan(monkeypatch):
    """The budget rule of the reference's ``plan()`` (4 * kappa * d against
    the budget), with the shared-memory budget for VMEM's."""
    monkeypatch.setattr(lookup, "group_size", lambda group: 4)
    for budget, kappa in ((2048, 64), (2047, 64), (None, 4096),
                          (None, 16384)):
        ours = ShardedLookup(group=object(), budget_bytes=budget,
                             device="cpu").plan(kappa, D)
        theirs = JLookup(n_devices=4, budget_bytes=budget or 232_448).plan(
            kappa, D)
        assert ours == theirs
