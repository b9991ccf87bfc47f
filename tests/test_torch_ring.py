"""The port's ring all-reduce and ``RingTransport`` held against
``repro.comm.ring``.

The reference's Pallas ring runs only between TPU devices; on the CPU its
``RingTransport`` takes its dense fallback (``ring.py:149-157``), so the
port holds itself to the ring's algorithm: ``ring_all_reduce_plain`` must
equal, bit for bit, a numpy simulation of the hops of ``ring.py:80-94``
(each device folds the partial received from its left neighbour, as the
left operand, into its own).  Whole runs are held against the reference's
``get_transport("ring")`` mesh at the bar the earlier port tests hold runs
to (``rtol=1e-4, atol=1e-6``: the fold adds in another order than the
reference's psum), and wire bytes exactly.  Inputs are made with numpy from
a seed.
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
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro_torch import comm, interop
from repro_torch.comm import ring
from repro_torch.comm.ring import RingTransport
from repro_torch.comm.xla import XlaTransport
from repro_torch.engine import GeometricDelayNetwork, InstantNetwork
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
RTOL, ATOL = 1e-4, 1e-6
REPO = Path(__file__).resolve().parents[1]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _numpy_ring(x):
    """The hops of ``repro/comm/ring.py:80-94`` on m simulated devices, both
    phases.

    x (m, n) f32 -> (m, n), each device's result: device ``my`` holds
    ``o[my]`` (m chunks of ceil(n / m), zero-padded); each hop reads every
    device's pre-hop values before any device writes."""
    m, n = x.shape
    chunk = -(-n // m)
    o = np.zeros((m, m, chunk), np.float32)
    o.reshape(m, -1)[:, :n] = x
    for s in range(m - 1):               # reduce-scatter
        before = o.copy()
        for my in range(m):
            left = (my + m - 1) % m
            recv = (my - s - 1) % m
            o[my, recv] = before[left, recv] + before[my, recv]
    for s in range(m - 1):               # all-gather
        before = o.copy()
        for my in range(m):
            left = (my + m - 1) % m
            o[my, (my - s) % m] = before[left, (my - s) % m]
    return o.reshape(m, -1)[:, :n]


def _mixed(rng, m, n):
    """Mixed-magnitude f32 entries; where a chunk past the first exists and
    m >= 3, one entry of chunk 1 is planted so that the fold (starting at
    worker 1) and a sum starting at worker 0 round differently."""
    x = (rng.standard_normal((m, n))
         * 10.0 ** rng.integers(-4, 9, size=(m, n))).astype(np.float32)
    chunk = -(-n // m)
    planted = m >= 3 and n > chunk
    if planted:
        x[:, chunk] = 0.0
        x[0, chunk], x[1, chunk], x[2, chunk] = 1.0, 1e8, -1e8
    return x, planted


@pytest.mark.parametrize("n", [1, 7, 1000, 8 * 128 + 5])
@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_plain_fold_matches_numpy_ring_bitwise(m, n):
    rng = np.random.default_rng(m * 10_000 + n)
    x, planted = _mixed(rng, m, n)
    want = _numpy_ring(x)
    got = ring.ring_all_reduce_plain(torch.from_numpy(x)).numpy()
    assert got.shape == (n,)
    # every simulated device ends with the port's one result
    np.testing.assert_array_equal(_bits(np.broadcast_to(got, want.shape)),
                                  _bits(want))
    # the fold of chunk c starts at worker c: (x1 + x2) + ... + x0 here
    c = -(-n // m)
    if planted:
        assert got[c] == 1.0
        assert np.sum(x, axis=0)[c] != got[c]
    # the wrapper on a CPU tensor is the plain version and counts nothing
    before = ring.launches_ring
    np.testing.assert_array_equal(
        _bits(ring.ring_all_reduce(torch.from_numpy(x)).numpy()), _bits(got))
    assert ring.launches_ring == before


@pytest.mark.parametrize("m", [3, 8])
def test_masked_ring_is_the_fold_of_mask_times_x(m):
    rng = np.random.default_rng(m)
    x, _ = _mixed(rng, m, 8 * 128 + 5)
    mask = (np.arange(m) % 3 != 1).astype(np.float32)
    want = _numpy_ring(mask[:, None] * x)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    for fn in (ring.ring_all_reduce, ring.ring_all_reduce_plain):
        got = fn(xt, mt).numpy()
        np.testing.assert_array_equal(
            _bits(np.broadcast_to(got, want.shape)), _bits(want))
    # stacked shapes pass through: (m, 4, 3) reduces like (m, 12)
    x3 = xt[:, :12].reshape(m, 4, 3).contiguous()
    np.testing.assert_array_equal(
        ring.ring_all_reduce(x3, mt).reshape(12).numpy(),
        ring.ring_all_reduce(xt[:, :12].contiguous(), mt).numpy())


def _rotated_fold(x, mask=None):
    """What ``csrc/vq_ring.cu`` computes, entry by entry: entry g of chunk
    c = g // chunk is m_c * x_c[g], then + m_{c+j} * x_{c+j}[g] for j = 1 ..
    m - 1 (worker indices mod m), in float32; no hop is run."""
    m, n = x.shape
    mx = x if mask is None else mask[:, None] * x
    assert mx.dtype == np.float32
    chunk = -(-n // m)
    out = np.full(n, np.nan, np.float32)
    for c in range(m):
        lo, hi = c * chunk, min(n, (c + 1) * chunk)
        if lo >= hi:
            continue
        acc = mx[c, lo:hi].copy()
        for j in range(1, m):
            acc = acc + mx[(c + j) % m, lo:hi]
        out[lo:hi] = acc
    return out


# (m, n): N and chunk multiples of 4 (the kernel's float4 route), a short
# last chunk on that route (5, 36), chunk a multiple of 4 while N is not
# (8, 4,093), ragged chunks, the (8, 1) eval payload, and (2, 7)
FOLD_SHAPES = [(8, 4096), (5, 36), (8, 4093), (3, 40_040), (5, 10_003),
               (8, 1), (2, 7)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m,n", FOLD_SHAPES)
def test_rotated_fold_equals_plain_ring_bitwise(m, n, masked):
    rng = np.random.default_rng(m * 100_003 + n)
    x, _ = _mixed(rng, m, n)
    x[:, rng.random(n) < 0.2] = -0.0       # -0.0 in every row
    x[0, : min(n, 3)] = 0.0                # and +0.0 against it
    mask = (np.arange(m) % 3 != 1).astype(np.float32) if masked else None
    want = _rotated_fold(x, mask)
    got = ring.ring_all_reduce_plain(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if masked:
        np.testing.assert_array_equal(
            _bits(want), _bits(_numpy_ring(mask[:, None] * x)[0]))


def test_ring_wrapper_validates():
    x = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="float32"):
        ring.ring_all_reduce(x.double())
    with pytest.raises(ValueError, match="float32"):
        ring.ring_all_reduce(torch.zeros(()))
    with pytest.raises(ValueError, match="mask"):
        ring.ring_all_reduce(x, torch.ones(2))
    with pytest.raises(ValueError, match="mask"):
        ring.ring_all_reduce(x, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ring.ring_all_reduce(x.to("meta"))


def test_ring_transport_records_mean_plain_and_one_worker():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_mixed(rng, 6, 30)[0].reshape(6, 5, 6))
    t = comm.get_transport("ring")
    assert isinstance(t, RingTransport) and isinstance(t, XlaTransport)
    assert t.name == "ring" and not t.stateful and t.init_state(x) is None
    total, st = t.all_reduce(x, state="kept")
    assert st == "kept"
    np.testing.assert_array_equal(
        _bits(total.numpy()), _bits(_numpy_ring(x.reshape(6, -1).numpy())[0]
                                     .reshape(5, 6)))
    # the mean divides the ring sum by a tensor M (not exact as a multiply
    # by 1/6) and casts back to x's dtype
    mean, _ = t.all_reduce(x, op="mean", tag="eval")
    assert torch.equal(mean, total / torch.tensor(6.0))
    half, _ = t.all_reduce(x.to(torch.bfloat16), op="mean")
    assert half.dtype == torch.bfloat16
    mask = torch.tensor([1.0, 0, 1, 1, 0, 1])
    masked, _ = t.masked_all_reduce(x, mask)
    assert torch.equal(masked, ring.ring_all_reduce_plain(x, mask))
    with pytest.raises(ValueError, match="mask"):
        t.masked_all_reduce(x, torch.ones(5))
    with pytest.raises(ValueError, match="unknown reduce op"):
        t.all_reduce(x, op="max")
    # a non-floating leaf passes a mean through, as in the reference (an
    # optimizer's step count): worker 0's, charged no bytes
    ints = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    kept, _ = t.all_reduce(ints, op="mean")
    assert torch.equal(kept, ints[0])
    logical = 4 * 30
    assert [(r.op, r.transport, r.tag, r.logical_bytes, r.wire_bytes)
            for r in t.log.records] == [
        ("sum", "ring", "merge", logical, comm.ring_wire_bytes(logical, 6)),
        ("mean", "ring", "eval", logical, comm.ring_wire_bytes(logical, 6)),
        ("mean", "ring", "merge", logical, comm.ring_wire_bytes(logical, 6)),
        ("masked_sum", "ring", "merge", logical,
         comm.ring_wire_bytes(logical, 6)),
        ("mean", "ring", "merge", 0, 0)]
    # plain(): the plain ring, the same log
    p = t.plain()
    assert p.reduce is ring.ring_all_reduce_plain and p.log is t.log
    assert t.reduce is ring.ring_all_reduce and p.name == "ring"
    assert torch.equal(p.all_reduce(x)[0], total)
    # one worker: its own payload, no wire
    solo = RingTransport()
    out, _ = solo.all_reduce(x[:1])
    assert torch.equal(out, x[0]) and solo.log.records[0].wire_bytes == 0


def _setup(m, n=200, d=8, kappa=16, seed=42, n_eval=100):
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


def _lengths(m, n):
    return interop.lengths_from_reference(JGeometric(0.5).round_lengths(
        _ref_key(), m, n // TAU + 2, TAU))


def _port_run(scheme, transport, *, m=8, use_kernels=True):
    w0, data, eval_data = _setup(m)
    if scheme == "async_delta":
        net, lengths = GeometricDelayNetwork(0.5), _lengths(m, data.shape[1])
    else:
        net, lengths = InstantNetwork(), None
    ex = MeshExecutor(net, transport=transport, use_kernels=use_kernels,
                      device="cpu")
    res = ex.run(scheme, *interop.from_reference(w0, data, eval_data,
                                                 device="cpu"),
                 tau=TAU, lengths=lengths)
    return res, ex


@pytest.mark.parametrize("scheme,wire", [("average", 17_920),
                                         ("delta", 17_920),
                                         ("async_delta", 179_200)])
def test_mesh_ring_wire_matches_bench_comm(scheme, wire):
    _, ex = _port_run(scheme, "ring")
    merge = ex.last_comm["by_tag"]["merge"]
    assert merge["wire_bytes"] == wire
    bench = json.loads((REPO / "BENCH_comm.json").read_text())
    rows = [r for r in bench["results"] if r.get("kind") == "cell"
            and r.get("transport") == "ring" and r.get("scheme") == scheme]
    assert rows and {r["merge_wire_bytes"] for r in rows} == {wire}
    assert {r["merge_logical_bytes"] for r in rows} == {
        merge["logical_bytes"]}


@pytest.mark.devices(8)
@pytest.mark.parametrize("scheme", ["average", "delta", "async_delta"])
def test_mesh_ring_matches_reference_ring_mesh(scheme):
    """The BENCH_comm.json cell on both packages' ring transports, the async
    scheme on the reference's round lengths: equal ticks and wire, curves
    and codebooks within RTOL/ATOL."""
    w0, data, eval_data = _setup(8)
    ours, ex = _port_run(scheme, "ring")
    net = JGeometric(0.5) if scheme == "async_delta" else JInstant()
    theirs = JMeshExecutor(network=net, transport=jget_transport("ring"))
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


@pytest.mark.parametrize("scheme", ["average", "delta", "async_delta"])
def test_mesh_ring_against_dense_and_plain(scheme):
    """The ring run agrees with the dense run to rounding, its plain route
    (``use_kernels=False``) gives its bits, and one worker is the dense run
    bit for bit (a one-term fold)."""
    dense, ex_d = _port_run(scheme, "xla")
    ringed, ex_r = _port_run(scheme, "ring")
    plain, _ = _port_run(scheme, "ring", use_kernels=False)
    np.testing.assert_allclose(ringed.distortion.numpy(),
                               dense.distortion.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ringed.w_shared.numpy(),
                               dense.w_shared.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(plain.distortion, ringed.distortion)
    assert torch.equal(plain.w_shared, ringed.w_shared)
    assert ex_r.last_comm == ex_d.last_comm        # the dense convention
    solo_d, _ = _port_run(scheme, "xla", m=1)
    solo_r, ex_1 = _port_run(scheme, "ring", m=1)
    assert torch.equal(solo_r.distortion, solo_d.distortion)
    assert torch.equal(solo_r.w_shared, solo_d.w_shared)
    assert ex_1.last_comm["by_tag"]["merge"]["wire_bytes"] == 0


def test_launch_train_ring_on_cpu():
    base = ["--mode", "vq", "--executor", "mesh", "--workers", "8",
            "--points", "200", "--transport", "ring", "--device", "cpu"]
    for extra, wire in ((["--scheme", "delta"], "17,920"),
                        (["--scheme", "async_delta", "--network",
                          "geometric"], "179,200")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train.main(base + extra)
        text = out.getvalue()
        assert rc == 0 and "transport=ring" in text
        assert f"comm[ring]: merge wire {wire} B" in text
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--mode", "vq", "--executor", "sim",
                         "--transport", "ring",
                         "--device", "cpu"])
    assert rc == 2
    assert out.getvalue().startswith("error: --transport ring needs "
                                     "--executor mesh")
