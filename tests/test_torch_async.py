"""The port's eq.-9 async scheme held against the reference.

The reference draws round lengths from a JAX key, which torch cannot
replay, so both packages get the reference's draw through
``interop.lengths_from_reference``.  Tolerances: curves at the reference's
own mesh-vs-oracle bar (``rtol=1e-4, atol=1e-6``, equal ticks).  The final
shared codebook at ``rtol=1e-5, atol=1e-6``: at M=4 and M=8 (n=600, d=8,
kappa=16) it differs from the reference in 2-3 of 128 elements by at most
6.0e-8 (2.0e-7 relative), last-bit differences of the two frameworks' f32
arithmetic, so the bar sits more than ten times above them.  Within the
port, the mesh executor equals the sim oracle to the bit on the CPU.
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

from repro.core import async_vq as jasync
from repro.engine import FixedLatencyNetwork as JFixed
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro_torch import interop
from repro_torch.core import async_vq, schemes
from repro_torch.engine import (FixedLatencyNetwork, GeometricDelayNetwork,
                                InstantNetwork)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.engine.sim import SimExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

TAU = 10
RTOL, ATOL = 1e-4, 1e-6
W_RTOL, W_ATOL = 1e-5, 1e-6
REPO = Path(__file__).resolve().parents[1]


def _setup(m, n=600, d=8, kappa=16, seed=42, n_eval=200):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, d))).astype(np.float32)
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _ref_lengths(m, n, p_delay=0.5, fold=9):
    key = jax.random.fold_in(jax.random.PRNGKey(42), fold)
    return key, JGeometric(p_delay).round_lengths(key, m, n // TAU + 2, TAU)


def test_round_lengths_match_reference():
    gen = torch.Generator().manual_seed(0)
    for ours, theirs in ((InstantNetwork(), JInstant()),
                         (FixedLatencyNetwork(latency_ticks=3),
                          JFixed(latency_ticks=3))):
        got = ours.round_lengths(gen, 4, 17, TAU)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(theirs.round_lengths(None, 4, 17, TAU)))
    drawn = GeometricDelayNetwork(0.5).round_lengths(gen, 4, 17, TAU)
    assert drawn.shape == (4, 17) and drawn.dtype == torch.int32
    assert int(drawn.min()) >= TAU and int(drawn.max()) > TAU


@pytest.mark.parametrize("p_delay", [0.05, 0.3, 0.5, 0.999, 1.0])
def test_geometric_formula_matches_reference_on_same_uniforms(p_delay):
    """The reference's sampler and the port's formula on the reference's
    own uniforms: every one of 65,536 draws equal."""
    key = jax.random.PRNGKey(int(p_delay * 1000))
    shape = (16, 4096)
    u = np.asarray(jax.random.uniform(key, shape, minval=1e-7, maxval=1.0))
    want = np.asarray(jasync._round_lengths(key, shape, tau=TAU,
                                            p_delay=p_delay))
    got = TAU + async_vq.geometric_extra(torch.tensor(u), p_delay)
    np.testing.assert_array_equal(got.numpy(), want)


def test_done_mask_marks_each_round_end_once():
    """Row t marks worker i exactly when t is a cumulative sum of its round
    lengths (the reference's ``done_at`` compare, ``nd == t``)."""
    lengths = GeometricDelayNetwork(0.3).round_lengths(
        torch.Generator().manual_seed(1), 5, 95 // TAU + 2, TAU)
    mask = async_vq.done_mask(lengths, 5, 95, TAU, torch.device("cpu"))
    done_at = np.cumsum(lengths.numpy().astype(np.int64), axis=1)
    want = np.zeros((95, 5), dtype=bool)
    for i in range(5):
        for t in done_at[i][done_at[i] < 95]:
            want[t, i] = True
    assert mask.shape == (95, 5) and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), want)
    assert int(mask.sum()) > 0


@pytest.mark.parametrize("m", [4, 8])
def test_scheme_async_matches_reference_on_its_lengths(m):
    w0, data, eval_data = _setup(m)
    key, lengths = _ref_lengths(m, data.shape[1])
    want = jasync.scheme_async(jnp.asarray(w0), jnp.asarray(data),
                               jnp.asarray(eval_data), key, tau=TAU,
                               lengths=lengths)
    ins = interop.from_reference(w0, data, eval_data, device="cpu")
    got = async_vq.scheme_async(
        *ins, tau=TAU, lengths=interop.lengths_from_reference(lengths))
    np.testing.assert_array_equal(got.wall_ticks.numpy(),
                                  np.asarray(want.wall_ticks))
    np.testing.assert_allclose(got.distortion.numpy(),
                               np.asarray(want.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.w_shared.numpy(),
                               np.asarray(want.w_shared), rtol=W_RTOL,
                               atol=W_ATOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mesh_async_equals_sim_async_bitwise(use_kernels):
    w0, data, eval_data = _setup(8)
    ins = interop.from_reference(w0, data, eval_data, device="cpu")
    net = GeometricDelayNetwork(0.5)
    sim = SimExecutor(net, device="cpu").run(
        "async_delta", *ins, tau=TAU,
        generator=torch.Generator().manual_seed(5))
    mesh = MeshExecutor(net, use_kernels=use_kernels, device="cpu").run(
        "async_delta", *ins, tau=TAU,
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(mesh.w_shared, sim.w_shared)
    assert torch.equal(mesh.distortion, sim.distortion)
    assert torch.equal(mesh.wall_ticks, sim.wall_ticks)
    assert mesh.wall_ticks.tolist() == list(range(10, 601, 10))


def test_sim_default_draw_equals_explicit_lengths():
    """A generator draw and the same draw passed as ``lengths`` give the
    same run (the network's sampler is the oracle's)."""
    w0, data, eval_data = _setup(4)
    ins = interop.from_reference(w0, data, eval_data, device="cpu")
    default = async_vq.scheme_async(
        *ins, tau=TAU, p_delay=0.5,
        generator=torch.Generator().manual_seed(3))
    lengths = GeometricDelayNetwork(0.5).round_lengths(
        torch.Generator().manual_seed(3), 4, 600 // TAU + 2, TAU)
    explicit = async_vq.scheme_async(*ins, tau=TAU, lengths=lengths)
    assert torch.equal(default.distortion, explicit.distortion)
    with pytest.raises(ValueError, match="n // tau"):
        async_vq.scheme_async(*ins, tau=TAU, lengths=lengths[:, :5])
    with pytest.raises(ValueError, match="at least tau"):
        async_vq.scheme_async(*ins, tau=TAU, lengths=lengths - 5)
    with pytest.raises(ValueError, match="n // tau"):
        async_vq.scheme_async(*ins, tau=TAU, lengths=lengths[:1])
    with pytest.raises(TypeError, match="kind"):
        interop.lengths_from_reference(np.ones((2, 3), np.float32))


def _value_final(res):
    return float(res.distortion[-1])


def test_async_close_to_delta():
    """Paper Section 4: "asynchronism only slightly impacts performances"
    (the reference's tests/test_schemes.py bound), and async still clearly
    beats the sequential run."""
    w0, data, eval_data = (torch.from_numpy(x) for x in
                           _setup(10, n=3000, n_eval=500))
    dlt = schemes.scheme_delta(w0, data, eval_data, tau=TAU)
    asy = async_vq.scheme_async(w0, data, eval_data, tau=TAU, p_delay=0.5,
                                generator=torch.Generator().manual_seed(9))
    seq = schemes.scheme_sequential(w0, data[0], eval_data, tau=TAU)
    assert _value_final(asy) < 2.0 * _value_final(dlt)
    assert _value_final(asy) < 0.7 * _value_final(seq)


def test_async_zero_delay_matches_delta_trend():
    """p_delay ~ 1 (rounds take exactly tau): a staled delta merge."""
    w0, data, eval_data = (torch.from_numpy(x) for x in
                           _setup(4, n=2000, n_eval=500))
    dlt = schemes.scheme_delta(w0, data, eval_data, tau=TAU)
    asy = async_vq.scheme_async(w0, data, eval_data, tau=TAU, p_delay=0.999,
                                generator=torch.Generator().manual_seed(10))
    assert _value_final(asy) < 2.5 * _value_final(dlt)


def test_async_merge_wire_matches_bench_comm():
    """m=8, n=200, d=8, kappa=16, tau=10: the masked merge runs every tick,
    512 B logical per worker, ring wire 896 B: BENCH_comm.json's async
    figures."""
    w0, data, eval_data = _setup(8, n=200, n_eval=100)
    ex = MeshExecutor(GeometricDelayNetwork(0.5), device="cpu")
    ex.run("async_delta", *interop.from_reference(w0, data, eval_data,
                                                  device="cpu"), tau=TAU)
    merge = ex.last_comm["by_tag"]["merge"]
    assert merge == {"calls": 200, "logical_bytes": 102_400,
                     "wire_bytes": 179_200}
    assert ex.last_comm["by_tag"]["eval"]["calls"] == 20
    bench = json.loads((REPO / "BENCH_comm.json").read_text())
    rows = [r for r in bench["results"] if r.get("scheme") == "async_delta"
            and r.get("transport") == "xla"]
    assert rows and {(r["merge_wire_bytes"], r["merge_logical_bytes"])
                     for r in rows} == {(179_200, 102_400)}


def test_launch_train_async_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--mode", "vq", "--executor", "mesh",
                         "--scheme", "async_delta", "--network", "geometric",
                         "--workers", "8", "--points", "200",
                         "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0
    assert "executor=mesh scheme=async_delta M=8" in text
    assert text.count("  ticks ") == 10
    assert "merge wire 179,200 B / logical 102,400 B" in text
