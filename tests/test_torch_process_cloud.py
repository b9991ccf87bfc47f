"""The paper's cloud setting with one worker a process: the sparse
transport over a group (flat and as a hierarchical tier 1), the quorum's
count, the dynamic merge's triggers, the tier-1 controller and eq. 9 over
the sparse transport, in one 4-rank gloo world
(``_torch_worlds.cloud_checks``; d = 8, kappa = 16, 200 points a worker).

A group run is held against the stacked port on the same numpy inputs: the
sparse sums bit for bit (each rank's top k gathered and summed in rank
order, the stacked run's own op), the residuals row for row, the records
field for field; every rank must read the same ``w_shared``, trigger bits
and controller ``frac``s.  Eq. 9 over the lossless sparse transport is held
against the reference's ``scheme_async``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.core import async_vq as jasync
from repro.engine import GeometricDelayNetwork as JGeometric
from repro_torch import comm
from repro_torch.comm import ring
from repro_torch.distributed import process_group
from repro_torch.engine import merge as merge_lib
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.engine.network import (FixedLatencyNetwork,
                                        GeometricDelayNetwork,
                                        InstantNetwork,
                                        Tier1BudgetController)
from repro_torch.topology import Topology

torch.set_num_threads(1)

M, TAU, N, D, KAPPA = 4, 10, 200, 8, 16
RTOL, ATOL = 1e-4, 1e-6
FRAC = 0.05                # k = 6 of the 128-entry displacement
EQ9_FRAC = 1.0             # eq. 9's in-flight rounds outgrow any k < N
THRESH = 1e-4              # some windows trigger on drift, some do not


def _inputs():
    rng = np.random.default_rng(7)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(M, N))]
            + 0.05 * rng.standard_normal((M, N, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(M * N, KAPPA,
                                        replace=False)].copy()
    xs = [rng.standard_normal((M, KAPPA, D)).astype(np.float32)
          for _ in range(3)]
    xs[2][:, 3:] = 0.0                      # a sparse payload: ties at 0
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    lengths = JGeometric(0.5).round_lengths(key, M, N // TAU + 2, TAU)
    return {"w0": w0, "data": data, "eval": data[:, :100].copy(), "xs": xs,
            "mask": np.array([1.0, 0.0, 1.0, 0.0], np.float32),
            "w_local": (w0[None] + 0.1 * rng.standard_normal(
                (M, KAPPA, D))).astype(np.float32),
            "frac": FRAC, "eq9_frac": EQ9_FRAC, "thresh": THRESH,
            "lengths": np.array(lengths, np.int32), "key": key}


@pytest.fixture(scope="module")
def world():
    ins = _inputs()
    key = ins.pop("key")
    return ins, key, process_group.spawn(worlds.cloud_checks, M, ins,
                                         device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stacked_calls(tr, ins):
    xs = [_t(x) for x in ins["xs"]]
    state = tr.init_state(xs[0])
    sums = []
    for i, x in enumerate(xs):
        if i == 1:
            y, state = tr.masked_all_reduce(x, _t(ins["mask"]), state=state)
        else:
            y, state = tr.all_reduce(x, state=state)
        sums.append(y.numpy())
    return sums, state


@pytest.mark.parametrize("name,frac", [("sparse", FRAC), ("lossless", 1.0)])
def test_sparse_group_sums_equal_stacked_bitwise(world, name, frac):
    ins, _, outs = world
    tr = comm.SparseTransport(frac)
    sums, state = _stacked_calls(tr, ins)
    for r, o in enumerate(outs):
        got, res, _, records = o[name]
        for a, b in zip(got, sums):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(res, state[r:r + 1].numpy())
        assert records[:-1] == tr.log.records   # the tuple call's last


@pytest.mark.parametrize("name,frac", [("sparse", FRAC), ("lossless", 1.0)])
def test_sparse_group_tuple_payload_equals_stacked_bitwise(world, name,
                                                           frac):
    ins, _, outs = world
    tr = comm.SparseTransport(frac)
    x0, x1 = _t(ins["xs"][0]), _t(ins["xs"][1])
    pair, _ = tr.all_reduce((x0, x1[:, :5] * 2.0))
    for o in outs:
        got = o[name][2]
        for a, b in zip(got, pair):
            np.testing.assert_array_equal(a, b.numpy())
        assert o[name][3][-1] == tr.log.records[0]
        # one record, each leaf charged (M-1) k 8 bytes
        assert tr.log.records[0].wire_bytes == sum(
            (M - 1) * comm.topk_count(n, frac) * 8 for n in (128, 40))


def test_lossless_sparse_group_equals_stacked_dense_bitwise(world):
    ins, _, outs = world
    dense = [torch.sum(_t(x), dim=0).numpy() for x in
             (ins["xs"][0], ins["xs"][2])]
    for o in outs:
        np.testing.assert_array_equal(o["lossless"][0][0], dense[0])
        np.testing.assert_array_equal(o["lossless"][0][2], dense[1])


def test_sparse_tier1_group_equals_stacked_ring_tiers_bitwise(world):
    """A ring tier 0 keeps the stacked fold, and the sparse tier 1 gathers
    the same pairs: sums, the per-host residual on each of its ranks and
    the per-tier records equal the stacked run's."""
    ins, _, outs = world
    topo = Topology.simulate(2, 2)
    hier = comm.HierarchicalTransport(
        "ring", comm.SparseTransport(FRAC), topology=topo)
    sums, state = _stacked_calls(hier, ins)
    for r, o in enumerate(outs):
        got, res, records = o["hier"]
        for a, b in zip(got, sums):
            np.testing.assert_array_equal(a, b)
        host = r // 2
        np.testing.assert_array_equal(res,
                                      state["t1"][host:host + 1].numpy())
        assert records == hier.log.records


def test_sparse_tier1_bytes_per_tier(world):
    """2 x 2 over KAPPA x D: tier 0 the dense ring inside a host, tier 1
    (hosts - 1) k 8 bytes a merge."""
    _, _, outs = world
    records = outs[0]["hier"][2]
    k = comm.topk_count(KAPPA * D, FRAC)
    by = {(r.tier, r.op): r for r in records}
    assert by[(0, "sum")].wire_bytes == comm.ring_wire_bytes(
        4 * KAPPA * D, 2)
    assert by[(1, "sum")].wire_bytes == (2 - 1) * k * 8
    assert by[(0, "masked_sum")].participants == 2
    assert by[(1, "sum")].calls == 3           # tier 1 sums every call


def test_quorum_is_counted_on_the_group_size(world):
    """Two of four ranks arrive and 0.75 of 4 is a quorum of 3: nobody
    merges.  Counted on a rank's one row, the quorum would be 1 and the
    window would merge."""
    ins, _, outs = world
    for o in outs:
        k, merged = o["quorum"]
        assert k == 3
        np.testing.assert_array_equal(merged, ins["w0"])
    # the stacked merge agrees
    q = merge_lib.QuorumMerge(comm.XlaTransport(), quorum_frac=0.75)
    w_local = _t(ins["w_local"])
    merged, _ = q(_t(ins["w0"]), w_local, state=q.init_state(w_local),
                  late=torch.tensor([0.0, 1.0, 0.0, 1.0]))
    np.testing.assert_array_equal(merged.numpy(), ins["w0"])


def test_dynamic_triggers_agree_on_every_rank(world):
    ins, _, outs = world
    bits = outs[0]["triggers"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["triggers"], bits)
    assert 0 < bits.sum() < len(bits)
    ex = MeshExecutor(InstantNetwork(), merge="dynamic",
                      divergence_thresh=THRESH, device="cpu")
    ex.run("delta", *[_t(ins[k]) for k in ("w0", "data", "eval")], tau=TAU)
    np.testing.assert_array_equal(bits, ex.last_triggers.numpy())


def test_controller_fracs_agree_and_equal_stacked(world):
    ins, _, outs = world
    topo = Topology.simulate(2, 2)
    net = FixedLatencyNetwork(latency_ticks=1, dcn_bytes_per_tick=64)
    ex = MeshExecutor(net, transport=comm.HierarchicalTransport(
        "xla", comm.SparseTransport(0.5), topology=topo),
        tier1_controller=Tier1BudgetController(net), publish_every=5,
        topology=topo, device="cpu")
    res = ex.run("delta", *[_t(ins[k]) for k in ("w0", "data", "eval")],
                 tau=TAU)
    assert len(ex.last_tier1_fracs) == 4 and ex.last_tier1_fracs[0] == 0.25
    for o in outs:
        fracs, w, last = o["controller"]
        assert fracs == ex.last_tier1_fracs
        assert last == ex.last_comm
        np.testing.assert_array_equal(w, outs[0]["controller"][1])
        np.testing.assert_allclose(w, res.w_shared.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_eq9_over_sparse_matches_scheme_async(world):
    ins, key, outs = world
    w, curve, ticks, last = outs[0]["eq9"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["eq9"][0], w)
    ex = MeshExecutor(GeometricDelayNetwork(0.5),
                      transport=comm.SparseTransport(EQ9_FRAC), device="cpu")
    res = ex.run("async_delta", *[_t(ins[k]) for k in ("w0", "data",
                                                       "eval")],
                 tau=TAU, lengths=_t(ins["lengths"]))
    np.testing.assert_array_equal(w, res.w_shared.numpy())
    assert last == ex.last_comm
    # lossless sparse == dense, bit for bit
    dense = MeshExecutor(GeometricDelayNetwork(0.5), device="cpu").run(
        "async_delta", *[_t(ins[k]) for k in ("w0", "data", "eval")],
        tau=TAU, lengths=_t(ins["lengths"]))
    np.testing.assert_array_equal(res.w_shared.numpy(),
                                  dense.w_shared.numpy())
    lengths = jnp.asarray(ins["lengths"])
    want = jasync.scheme_async(jnp.asarray(ins["w0"]),
                               jnp.asarray(ins["data"]),
                               jnp.asarray(ins["eval"]), key, tau=TAU,
                               lengths=lengths)
    np.testing.assert_array_equal(ticks, np.asarray(want.wall_ticks))
    np.testing.assert_allclose(curve, np.asarray(want.distortion),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w, np.asarray(want.w_shared), rtol=1e-5,
                               atol=ATOL)


def test_ranks_sharing_the_cpu(world):
    _, _, outs = world
    assert [o["ranks_per_device"] for o in outs] == [M] * M
    assert ring.launches_ring_hop == 0
