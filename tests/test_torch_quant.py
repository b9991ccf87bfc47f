"""The port's quantized wire (``QuantizedTransport``, ``quantize_leaf``)
held against ``repro.comm.quant``.

A reference "leaf" is one device's local payload, so the port's int8 scale
is each worker's own ``max|x|``: ``quantize_leaf`` on the stacked payload
must equal the reference's applied worker by worker, bit for bit.  Whole
runs over the ring are held against the reference's ``quant[mode:ring]``
mesh (its ring takes the dense fallback on the CPU) at the ring's tolerance
(``rtol=1e-4, atol=1e-6``): both runs quantize payloads that differ only by
the ring's rounding, and an int8 code moves only where a payload lies
within that rounding of a half step; such a move changes one entry by one
int8 step (``max|x| / 127`` of its worker's payload) for one window before
the residual feeds it back, and no entry of these cells does.  Wire bytes
are exact and read from ``BENCH_adapt.json``.  Inputs are made with numpy
from a seed.
"""

import contextlib
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import get_transport as jget_transport
from repro.comm import quant as jquant
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro_torch import comm, interop
from repro_torch.comm import quant
from repro_torch.comm.quant import QUANT_WIDTH, QuantizedTransport
from repro_torch.comm.ring import RingTransport
from repro_torch.comm.sparse import SparseTransport
from repro_torch.engine import GeometricDelayNetwork, InstantNetwork
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
RTOL, ATOL = 1e-4, 1e-6
REPO = Path(__file__).resolve().parents[1]
# the BENCH_adapt.json fixed-tau cell: m=8, n=240 (24 windows), d=8,
# kappa=16
ADAPT_N = 240


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _leaves(rng):
    """(5, 40) f32: worker 0 N(0, 1e-3), worker 1 all zeros, worker 2 with
    max|x| = 127 (scale 1.0: .5 ties at 0.5, 2.5, -3.5, 126.5), worker 3
    with max|x| = 15.875 (scale 0.125: ties at odd multiples of 0.0625),
    worker 4 N(0, 1e4); every leaf holds its +-max|x| (codes +-127)."""
    x = rng.standard_normal((5, 40)).astype(np.float32)
    x[0] *= 1e-3
    x[1] = 0.0
    x[2] = np.clip(x[2] * 30, -120, 120)
    x[2, :6] = [0.5, 2.5, -3.5, 126.5, 127.0, -127.0]
    x[3] = np.clip(x[3] * 4, -15, 15)
    x[3, :5] = [0.0625, -0.1875, 15.8125, 15.875, -15.875]
    x[4] *= 1e4
    return x


@pytest.mark.parametrize("mode", ["identity", "bf16", "int8"])
def test_quantize_leaf_matches_reference_per_worker_bitwise(mode):
    x = _leaves(np.random.default_rng(0))
    for shape in ((5, 40), (5, 8, 5)):
        got = quant.quantize_leaf(torch.from_numpy(x.reshape(shape)),
                                  mode).numpy().reshape(5, 40)
        want = np.stack([np.asarray(jquant.quantize_leaf(jnp.asarray(row),
                                                         mode))
                         for row in x])
        np.testing.assert_array_equal(_bits(got), _bits(want))
    if mode == "int8":
        got = quant.quantize_leaf(torch.from_numpy(x), mode).numpy()
        assert not got[1].any()                        # all-zero leaf
        np.testing.assert_array_equal(got[2, :6],      # half to even
                                      [0.0, 2.0, -4.0, 126.0, 127.0, -127.0])
        # one scale for the whole stack would lose worker 0 entirely
        whole = np.asarray(jquant.quantize_leaf(jnp.asarray(x), mode))
        assert not whole[0].any() and got[0].any()
    # a leaf of one entry per worker (the eval payload's shape)
    got = quant.quantize_leaf(torch.from_numpy(x[:, 4]), mode).numpy()
    want = np.array([np.asarray(jquant.quantize_leaf(jnp.asarray(v), mode))
                     for v in x[:, 4]], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_quant_refusals_and_factory():
    assert quant.QUANT_WIDTH == jquant.QUANT_WIDTH
    t = comm.get_transport("quant", inner="ring", mode="int8")
    assert isinstance(t, QuantizedTransport)
    assert isinstance(t.inner, RingTransport) and t.name == "quant[int8:ring]"
    sp = comm.get_transport("quant", inner="sparse", mode="bf16", frac=0.5)
    assert sp.inner.frac == 0.5 and sp.name == "quant[bf16:sparse]"
    with pytest.raises(ValueError, match="double"):
        QuantizedTransport(inner=QuantizedTransport())
    with pytest.raises(ValueError, match="string inner spec"):
        QuantizedTransport(inner=SparseTransport(frac=0.1), frac=0.2)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        comm.get_transport("quant", mode="fp4")
    with pytest.raises(ValueError, match="unknown quantization mode"):
        quant.quantize_leaf(torch.zeros((2, 3)), "fp4")
    with pytest.raises(ValueError, match="unknown reduce op"):
        t.all_reduce(torch.ones((2, 3)), op="max")
    with pytest.raises(ValueError, match="mask"):
        t.masked_all_reduce(torch.ones((2, 3)), torch.ones(3))


def _inner(name):
    return SparseTransport(frac=0.25) if name == "sparse" else name


@pytest.mark.parametrize("mode", ["identity", "bf16", "int8"])
@pytest.mark.parametrize("inner", ["xla", "ring", "sparse"])
def test_quant_wire_repricing_and_state(inner, mode):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 16, 8)).astype(np.float32))
    t = QuantizedTransport(_inner(inner), mode=mode)
    ref = QuantizedTransport(_inner(inner), mode="identity")
    state = t.init_state(x)
    feedback = mode != "identity"
    assert t.stateful == (feedback or inner == "sparse")
    if feedback and inner == "sparse":
        assert set(state) == {"q", "inner"}
        assert state["q"].shape == state["inner"].shape == x.shape
    elif feedback:
        assert state.shape == x.shape and not state.any()
    elif inner == "sparse":
        assert state.shape == x.shape            # the inner residual
    else:
        assert state is None
    total, new_state = t.all_reduce(x, state=state)
    assert total.shape == (16, 8)
    if feedback:
        res = new_state["q"] if inner == "sparse" else new_state
        deq = quant.quantize_leaf(x, mode)
        assert torch.equal(res, x - deq)
    # a state=None call runs residual-free and returns no state
    assert t.all_reduce(x)[1] is None
    t.all_reduce(x, op="mean", tag="eval")
    ref.all_reduce(x)
    (plain,) = ref.inner.log.since(0)[:1]
    dense_wire = plain.wire_bytes
    width = QUANT_WIDTH[mode]
    if inner == "sparse":
        want = dense_wire * (width + 4) // 8
    else:
        want = dense_wire * width // 4
    if mode == "int8":
        want += 4
    recs = t.log.records
    assert recs[0].transport == f"{plain.transport}+{mode}"
    assert recs[0].wire_bytes == want and recs[0].calls == 2
    assert recs[0].logical_bytes == plain.logical_bytes
    # means ride the inner transport unquantized, under its own name
    assert recs[1].op == "mean" and recs[1].tag == "eval"
    assert recs[1].transport == ("xla" if inner == "sparse" else inner)
    assert recs[1].wire_bytes == comm.ring_wire_bytes(4 * 128, 8)
    # one worker moves nothing, so no scale is charged either
    solo = QuantizedTransport(_inner(inner), mode=mode)
    solo.all_reduce(x[:1])
    assert solo.log.records[0].wire_bytes == 0


@pytest.mark.parametrize("inner", ["ring", "sparse"])
def test_masked_out_worker_keeps_its_residual(inner):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(np.float32))
    t = QuantizedTransport(_inner(inner), mode="int8")
    state = t.init_state(x)
    _, state = t.all_reduce(x, state=state)
    res0 = state["q"] if inner == "sparse" else state
    assert res0.abs().max() > 0
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    got, state = t.masked_all_reduce(2 * x, mask, state=state)
    res1 = state["q"] if inner == "sparse" else state
    assert torch.equal(res1[1], res0[1]) and torch.equal(res1[3], res0[3])
    payload = 2 * x + res0
    deq = quant.quantize_leaf(payload, "int8")
    assert torch.equal(res1[[0, 2]], (payload - deq)[[0, 2]])
    if inner == "ring":
        assert torch.equal(got, t.inner.reduce(deq, mask))


def test_error_feedback_residual_telescopes():
    """Across calls the shipped values plus the last residual give the sum
    of the raw payloads: nothing is lost, only delayed."""
    rng = np.random.default_rng(3)
    t = QuantizedTransport("ring", mode="int8")
    payloads = [torch.from_numpy(rng.standard_normal((3, 16, 8))
                                 .astype(np.float32)) for _ in range(4)]
    state = t.init_state(payloads[0])
    shipped = torch.zeros((16, 8))
    for p in payloads:
        total, state = t.all_reduce(p, state=state)
        shipped = shipped + total
    raw = sum(p.sum(0) for p in payloads)
    np.testing.assert_allclose((shipped + state.sum(0)).numpy(), raw.numpy(),
                               rtol=0, atol=1e-5)


def _setup(m, n=ADAPT_N, d=8, kappa=16, seed=42, n_eval=100):
    """Reference-shaped inputs, numpy (as tests/test_torch_comm.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, d))).astype(np.float32)
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _ref_key():
    import jax
    return jax.random.fold_in(jax.random.PRNGKey(42), 9)


def _port_run(scheme, transport, *, use_kernels=True):
    w0, data, eval_data = _setup(8)
    if scheme == "async_delta":
        net = GeometricDelayNetwork(0.5)
        lengths = interop.lengths_from_reference(JGeometric(0.5).round_lengths(
            _ref_key(), 8, ADAPT_N // TAU + 2, TAU))
    else:
        net, lengths = InstantNetwork(), None
    ex = MeshExecutor(net, transport=transport, use_kernels=use_kernels,
                      device="cpu")
    res = ex.run(scheme, *interop.from_reference(w0, data, eval_data,
                                                 device="cpu"),
                 tau=TAU, lengths=lengths)
    return res, ex


@pytest.mark.parametrize("scheme", ["delta", "async_delta"])
def test_identity_quant_over_ring_is_transparent(scheme):
    ringed, ex_r = _port_run(scheme, "ring")
    ident, ex_i = _port_run(scheme, comm.get_transport(
        "quant", inner="ring", mode="identity"))
    plain, _ = _port_run(scheme, comm.get_transport(
        "quant", inner="ring", mode="identity"), use_kernels=False)
    for r in (ident, plain):
        assert torch.equal(r.distortion, ringed.distortion)
        assert torch.equal(r.w_shared, ringed.w_shared)
    assert ex_i.last_comm == ex_r.last_comm


@pytest.mark.parametrize("mode", ["off", "bf16", "int8"])
def test_mesh_quant_wire_matches_bench_adapt(mode):
    transport = ("ring" if mode == "off" else
                 comm.get_transport("quant", inner="ring", mode=mode))
    res, ex = _port_run("delta", transport)
    bench = json.loads((REPO / "BENCH_adapt.json").read_text())
    quant_name = "dense" if mode == "off" else mode
    rows = [r for r in bench["results"] if r.get("kind") == "cell"
            and r.get("merge") == "fixed" and r.get("quant") == quant_name]
    assert len(rows) == 1 and rows[0]["m"] == 8 and rows[0]["n"] == ADAPT_N
    assert ex.last_comm["by_tag"]["merge"]["wire_bytes"] == (
        rows[0]["merge_wire_bytes"])
    curve = res.distortion.numpy()
    assert np.all(np.isfinite(curve)) and curve[-1] < curve[0]


@pytest.mark.devices(8)
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("scheme", ["delta", "async_delta"])
def test_mesh_quant_over_ring_matches_reference(scheme, mode):
    w0, data, eval_data = _setup(8)
    ours, ex = _port_run(scheme, comm.get_transport(
        "quant", inner="ring", mode=mode))
    net = JGeometric(0.5) if scheme == "async_delta" else JInstant()
    theirs = JMeshExecutor(network=net, transport=jget_transport(
        "quant", inner="ring", mode=mode))
    ref = theirs.run(scheme, jnp.asarray(w0), jnp.asarray(data),
                     jnp.asarray(eval_data), tau=TAU, key=_ref_key())
    np.testing.assert_array_equal(ours.wall_ticks.numpy(),
                                  np.asarray(ref.wall_ticks))
    np.testing.assert_allclose(ours.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ours.w_shared.numpy(),
                               np.asarray(ref.w_shared), rtol=RTOL,
                               atol=ATOL)
    for k in ("wire_bytes", "logical_bytes", "calls"):
        assert (ex.last_comm["by_tag"]["merge"][k]
                == theirs.last_comm["by_tag"]["merge"][k])


def test_launch_train_wire_quant_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--mode", "vq", "--executor", "mesh", "--workers",
                         "8", "--points", str(ADAPT_N), "--kappa", "16",
                         "--dim", "8", "--transport", "ring",
                         "--wire-quant", "int8", "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0 and "transport=quant[int8:ring]" in text
    assert "comm[quant[int8:ring]]: merge wire 5,472 B" in text
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--mode", "vq", "--executor", "sim",
                         "--wire-quant", "int8",
                         "--device", "cpu"])
    assert rc == 2
    assert out.getvalue().startswith(
        "error: --wire-quant quantizes the mesh transport's collectives; "
        "got --executor sim")
