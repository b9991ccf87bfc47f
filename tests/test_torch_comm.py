"""The port's sparse transport held against ``repro.comm.sparse``.

Inputs are made with numpy from a seed and handed to both packages.  The
reference's ``sparse_allsum`` runs under ``jax.vmap`` with a named axis (its
all-gather is then the stacked workers), its mesh executor on the forced
8-device CPU mesh.  Tolerances: the selection is exact, so ``sparse_allsum``
is compared bit for bit; whole runs at the bar the earlier port tests hold
runs to (``rtol=1e-4, atol=1e-6``); wire bytes exactly.
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
from repro.comm import sparse as jsparse
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro_torch import comm, interop
from repro_torch.comm import sparse
from repro_torch.comm.sparse import SparseTransport
from repro_torch.comm.xla import XlaTransport
from repro_torch.engine import GeometricDelayNetwork, InstantNetwork
from repro_torch.engine import merge as merge_lib
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.kernels import vq_fused
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
RTOL, ATOL = 1e-4, 1e-6
# final codebooks: the bar tests/test_torch_async.py holds them to
W_RTOL, W_ATOL = 1e-5, 1e-6
REPO = Path(__file__).resolve().parents[1]
# the BENCH_comm.json cell: m=8, n=200, d=8, kappa=16, frac 0.03125
# (k = 4 = kappa/4 of kappa*d = 128 entries)
BENCH_FRAC = 0.03125


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _payload(rng, m, shape, tie_heavy):
    if not tie_heavy:
        return rng.standard_normal((m, *shape)).astype(np.float32)
    x = np.zeros((m, *shape), np.float32)
    x[rng.random(x.shape) < 0.3] = -0.0
    hit = rng.random(x.shape) < 0.2
    x[hit] = 0.5 * rng.choice(np.array([1.0, -1.0], np.float32),
                              int(hit.sum()))
    return x


def _ref_allsum(x, residual, frac, mask=None):
    """The reference's sparse_allsum over the stacked workers."""
    def one(xi, ri, mi=None):
        return jsparse.sparse_allsum(xi, ri, frac, "w", mi)
    args = [jnp.asarray(x), jnp.asarray(residual)]
    if mask is not None:
        args.append(jnp.asarray(mask))
    summed, new_res = jax.vmap(one, axis_name="w")(*args)
    return np.asarray(summed[0]), np.asarray(new_res)


# (M, shape, frac): k = 1, k = N, N = 1155 with no power-of-two factor,
# M = 1 and M = 3
ALLSUM_CASES = [(1, (16, 8), 1e-9), (3, (16, 8), 1.0), (3, (33, 35), 0.03),
                (1, (33, 35), 0.5), (3, (24, 6), 0.1)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("m,shape,frac", ALLSUM_CASES)
def test_sparse_allsum_matches_reference_bitwise(m, shape, frac, tie_heavy,
                                                 masked):
    rng = np.random.default_rng(m * 100 + shape[0])
    x = _payload(rng, m, shape, tie_heavy)
    residual = _payload(rng, m, shape, tie_heavy) * np.float32(0.1)
    mask = ((np.arange(m) % 2 == 0).astype(np.float32) if masked else None)
    want_sum, want_res = _ref_allsum(x, residual, frac, mask)
    got_sum, got_res = sparse.sparse_allsum(
        torch.from_numpy(x), torch.from_numpy(residual), frac,
        None if mask is None else torch.from_numpy(mask))
    assert got_sum.shape == shape and got_res.shape == (m, *shape)
    np.testing.assert_array_equal(_bits(got_res.numpy()), _bits(want_res))
    # signed zeros of the sum may differ (a scatter-add onto +0.0 against a
    # sum over workers); every value is equal
    np.testing.assert_array_equal(got_sum.numpy(), want_sum)
    if masked:
        # a worker whose bit is 0 keeps its residual and contributes nothing
        np.testing.assert_array_equal(_bits(got_res[1::2].numpy()),
                                      _bits(residual[1::2]))


def test_topk_count_is_the_reference_convention():
    for size, frac in ((128, 0.03125), (524_288, 0.01), (524_288, 0.001),
                       (10, 1e-9), (7, 1.0), (1155, 0.03)):
        assert sparse.topk_count(size, frac) == jsparse.topk_count(size, frac)
    assert sparse.topk_count(524_288, 0.01) == 5_242
    assert sparse.topk_count(524_288, 0.001) == 524


def test_sparse_transport_factory_state_and_validation():
    sp = comm.get_transport("sparse", frac=0.5)
    assert isinstance(sp, SparseTransport) and sp.name == "sparse"
    assert sp.stateful and not comm.get_transport("xla").stateful
    assert comm.get_transport(sp) is sp
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="frac"):
            comm.get_transport("sparse", frac=bad)
    x = torch.ones((3, 4, 2))
    state = sp.init_state(x)
    assert state.shape == (3, 4, 2) and state.dtype == torch.float32
    assert not state.any()
    assert comm.get_transport("xla").init_state(x) is None
    with pytest.raises(ValueError, match="unknown reduce op"):
        sp.all_reduce(x, op="max")
    with pytest.raises(ValueError, match="mask"):
        sp.masked_all_reduce(x, torch.ones(2))
    # state=None: a residual-free call that returns no state
    out, st = sp.all_reduce(x, op="sum")
    assert st is None and out.shape == (4, 2)
    # plain(): the plain selection, the same log
    pl = sp.plain()
    assert pl.select is vq_fused.vq_topk_plain and pl.log is sp.log
    assert sp.select is not vq_fused.vq_topk_plain
    assert comm.get_transport("xla").plain().name == "xla"


def test_sparse_masked_semantics_and_wire():
    """A zero-mask worker contributes nothing and keeps its residual; the
    wire is (m-1) * k * 8 per participant whatever the mask."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(np.float32))
    res0 = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(np.float32))
    sp = SparseTransport(frac=0.2)            # k = 6 of 30
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    got, res = sp.masked_all_reduce(x, mask, state=res0)
    assert torch.equal(res[1], res0[1]) and torch.equal(res[3], res0[3])
    alone, res_alone = sp.all_reduce(x[[0, 2]], state=res0[[0, 2]])
    assert torch.equal(got, alone)
    assert torch.equal(res[[0, 2]], res_alone)
    # a sending worker's residual is its payload plus old residual with the
    # 6 shipped entries zeroed
    full = x + res0
    for j in (0, 2):
        assert int((res[j] != full[j]).sum()) == 6
    recs = sp.log.records
    assert [(r.op, r.transport, r.wire_bytes, r.logical_bytes)
            for r in recs] == [("masked_sum", "sparse", 3 * 6 * 8, 120),
                               ("sum", "sparse", 6 * 8, 120)]
    # one participant puts nothing on the wire
    solo = SparseTransport(frac=0.2)
    solo.all_reduce(x[:1])
    assert solo.log.records[0].wire_bytes == 0


def test_sparse_mean_rides_dense_in_the_sparse_log():
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((8, 3)).astype(np.float32))
    sp = SparseTransport(frac=0.1)
    state = sp.init_state(x)
    out, st = sp.all_reduce(x, op="mean", state=state, tag="eval")
    dense, _ = XlaTransport().all_reduce(x, op="mean")
    assert torch.equal(out, dense) and st is state
    (rec,) = sp.log.records
    assert rec.transport == "xla" and rec.op == "mean" and rec.tag == "eval"
    assert rec.wire_bytes == comm.ring_wire_bytes(12, 8)


@pytest.mark.parametrize("tie_heavy", [False, True])
def test_sparse_full_density_equals_dense_bitwise(tie_heavy):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_payload(rng, 8, (16, 8), tie_heavy))
    mask = torch.tensor([1.0, 0, 1, 1, 0, 0, 1, 0])
    sp, xla = SparseTransport(frac=1.0), XlaTransport()
    for args, fn in (((x,), "all_reduce"), ((x, mask), "masked_all_reduce")):
        got, res = getattr(sp, fn)(*args, state=sp.init_state(x))
        want, _ = getattr(xla, fn)(*args)
        assert torch.equal(got, want)
        assert not res.any()


def test_sparse_delta_merge_factory_and_frac_conflict():
    merge = merge_lib.get_merge("delta_sparse")
    assert merge.name == "delta_sparse" and merge.stateful
    assert isinstance(merge.transport, SparseTransport)
    assert merge.transport.frac == 0.01
    quarter = merge_lib.get_merge("delta_sparse", frac=0.25)
    assert quarter.transport.frac == 0.25
    t = SparseTransport(frac=0.5)
    assert merge_lib.get_merge("delta_sparse", transport=t,
                               frac=0.5).transport is t
    with pytest.raises(ValueError, match="conflicts"):
        merge_lib.get_merge("delta_sparse", transport=t, frac=0.25)
    assert not merge_lib.get_merge("delta").stateful
    w0 = torch.zeros((4, 2))
    w_local = torch.ones((3, 4, 2))
    state = merge.init_state(w_local)
    merged, new_state = merge(w0, w_local, state=state)
    assert merged.shape == (4, 2) and new_state.shape == (3, 4, 2)
    # average rides dense: the state passes through untouched
    avg = merge_lib.get_merge("average", transport=SparseTransport(0.1))
    assert avg(w0, w_local, state=state)[1] is state


def _setup(m, n=200, d=8, kappa=16, seed=42, n_eval=100):
    """Reference-shaped inputs, numpy (as tests/test_torch_engine.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, d))).astype(np.float32)
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _ref_key():
    return jax.random.fold_in(jax.random.PRNGKey(42), 9)


def _port_run(scheme, frac, *, m=8, use_kernels=True, **setup_kw):
    w0, data, eval_data = _setup(m, **setup_kw)
    transport = ("xla" if frac is None
                 else comm.get_transport("sparse", frac=frac))
    if scheme == "async_delta":
        net = GeometricDelayNetwork(0.5)
        lengths = interop.lengths_from_reference(JGeometric(0.5).round_lengths(
            _ref_key(), m, data.shape[1] // TAU + 2, TAU))
    else:
        net, lengths = InstantNetwork(), None
    ex = MeshExecutor(net, transport=transport, use_kernels=use_kernels,
                      device="cpu")
    res = ex.run(scheme, *interop.from_reference(w0, data, eval_data,
                                                 device="cpu"),
                 tau=TAU, lengths=lengths)
    return res, ex


@pytest.mark.parametrize("scheme,wire", [("delta", 4_480),
                                         ("async_delta", 44_800),
                                         ("average", 17_920)])
def test_mesh_sparse_merge_wire_matches_bench_comm(scheme, wire):
    _, ex = _port_run(scheme, BENCH_FRAC)
    merge = ex.last_comm["by_tag"]["merge"]
    assert merge["wire_bytes"] == wire
    bench = json.loads((REPO / "BENCH_comm.json").read_text())
    rows = [r for r in bench["results"] if r.get("kind") == "cell"
            and r.get("transport") == "sparse" and r.get("scheme") == scheme]
    assert rows and {r["merge_wire_bytes"] for r in rows} == {wire}
    assert {r["sparse_frac"] for r in rows} == {BENCH_FRAC}


@pytest.mark.devices(8)
@pytest.mark.parametrize("scheme", ["delta", "async_delta", "average"])
def test_mesh_sparse_matches_reference_mesh(scheme):
    """The BENCH_comm.json cell on both packages, the async scheme on the
    reference's round lengths: equal ticks, equal wire, curves within
    RTOL/ATOL and codebooks within W_RTOL/W_ATOL (last-bit differences of
    the two frameworks' f32 arithmetic; no selection flip at this cell)."""
    w0, data, eval_data = _setup(8)
    ours, ex = _port_run(scheme, BENCH_FRAC)
    net = JGeometric(0.5) if scheme == "async_delta" else JInstant()
    theirs = JMeshExecutor(network=net,
                           transport=jget_transport("sparse", frac=BENCH_FRAC))
    ref = theirs.run(scheme, jnp.asarray(w0), jnp.asarray(data),
                     jnp.asarray(eval_data), tau=TAU, key=_ref_key())
    np.testing.assert_array_equal(ours.wall_ticks.numpy(),
                                  np.asarray(ref.wall_ticks))
    np.testing.assert_allclose(ours.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ours.w_shared.numpy(),
                               np.asarray(ref.w_shared), rtol=W_RTOL,
                               atol=W_ATOL)
    for k in ("wire_bytes", "logical_bytes", "calls"):
        assert (ex.last_comm["by_tag"]["merge"][k]
                == theirs.last_comm["by_tag"]["merge"][k])


@pytest.mark.parametrize("scheme", ["delta", "async_delta", "average"])
def test_mesh_sparse_full_density_matches_dense(scheme):
    """tests/test_comm.py's criteria on the port: frac 1.0 keeps
    everything and gives the dense run (bit for bit here: the same sum over
    workers), and the plain-selection route gives the same run."""
    dense, _ = _port_run(scheme, None)
    full, _ = _port_run(scheme, 1.0)
    plain, _ = _port_run(scheme, 1.0, use_kernels=False)
    for r in (full, plain):
        assert torch.equal(r.distortion, dense.distortion)
        assert torch.equal(r.w_shared, dense.w_shared)


@pytest.mark.parametrize("scheme", ["delta", "async_delta", "average"])
def test_mesh_sparse_low_density_distortion_bound(scheme):
    """At k/kappa = 0.25 the compressed merges converge and stay within 25%
    of the dense final distortion (the reference's bar)."""
    dense, _ = _port_run(scheme, None, n=400, n_eval=200)
    res, _ = _port_run(scheme, BENCH_FRAC, n=400, n_eval=200)
    curve = res.distortion.numpy()
    assert np.all(np.isfinite(curve)) and curve[-1] < curve[0]
    gap = curve[-1] / float(dense.distortion[-1]) - 1.0
    assert abs(gap) < 0.25, f"sparse final C off dense by {gap:+.3f}"


def test_mesh_lossless_sparse_equals_dense_bitwise():
    """k at least every entry a window can touch (tau rows of d): the
    sparse run is the dense one bit for bit, the chip's full-width check at
    a CPU size (kappa=64, d=8, tau=10: frac 80/512)."""
    kw = dict(kappa=64, n=300)
    dense, _ = _port_run("delta", None, **kw)
    sparse_run, ex = _port_run("delta", 80 / 512, **kw)
    assert torch.equal(sparse_run.distortion, dense.distortion)
    assert torch.equal(sparse_run.w_shared, dense.w_shared)
    assert ex.last_comm["by_tag"]["merge"]["wire_bytes"] == 30 * 7 * 80 * 8


def test_launch_train_sparse_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--mode", "vq", "--executor", "mesh",
                         "--scheme", "delta", "--workers", "8",
                         "--points", "200", "--transport", "sparse",
                         "--compress-frac", "0.25", "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0
    assert "transport=sparse" in text
    # k = 32 of 128: 7 * 32 * 8 B a window, 20 windows
    assert "comm[sparse]: merge wire 35,840 B / logical 10,240 B" in text
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--executor", "sim", "--transport", "sparse",
                         "--device", "cpu"])
    assert rc == 2
    assert out.getvalue().startswith("error: --transport sparse")
