"""The port's engine held against the reference's oracles and accounting.

``MeshExecutor(device="cpu")`` and ``SimExecutor`` run the sync schemes on
numpy-made inputs and are held against ``repro.core.schemes`` at the
tolerance the reference holds its own mesh to (``rtol=1e-4, atol=1e-6``,
``tests/test_engine.py``); wire bytes and wall ticks must match exactly.
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schemes as jschemes
from repro.engine import FixedLatencyNetwork as JFixed
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro_torch import comm, device, interop
from repro_torch.core import schemes
from repro_torch.data import synthetic
from repro_torch.engine import (FixedLatencyNetwork, GeometricDelayNetwork,
                                InstantNetwork, get_executor, get_network,
                                validate_scheme)
from repro_torch.engine import merge as merge_lib
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.engine.sim import SimExecutor
from repro_torch.launch import train

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
TAU = 10
REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _setup(m, n=200, d=8, kappa=16, seed=42):
    """Reference-shaped inputs (replicate_stream + kmeanspp_init), numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    assign = rng.integers(0, 10, size=(m, n))
    data = (centers[assign]
            + 0.05 * rng.standard_normal((m, n, d))).astype(np.float32)
    eval_data = data[:, :100].copy()
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)].copy()
    return w0, data, eval_data


def _assert_matches(res, oracle):
    np.testing.assert_array_equal(res.wall_ticks.numpy(),
                                  np.asarray(oracle.wall_ticks))
    np.testing.assert_allclose(res.distortion.numpy(),
                               np.asarray(oracle.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(res.w_shared.numpy(),
                               np.asarray(oracle.w_shared), rtol=RTOL,
                               atol=ATOL)


def _oracle(scheme, w0, data, eval_data):
    fn = jschemes.scheme_delta if scheme == "delta" else jschemes.scheme_average
    return fn(jnp.asarray(w0), jnp.asarray(data), jnp.asarray(eval_data),
              tau=TAU)


@pytest.mark.parametrize("scheme", ["delta", "average"])
@pytest.mark.parametrize("m", [1, 8])
def test_mesh_matches_reference_oracle(scheme, m):
    w0, data, eval_data = _setup(m)
    ins = interop.from_reference(w0, data, eval_data, device=CPU)
    res = MeshExecutor(InstantNetwork(), device="cpu").run(
        scheme, *ins, tau=TAU)
    _assert_matches(res, _oracle(scheme, w0, data, eval_data))


@pytest.mark.parametrize("scheme", ["delta", "average"])
def test_sim_matches_reference_oracle(scheme):
    w0, data, eval_data = _setup(8)
    res = SimExecutor(InstantNetwork(), device="cpu").run(
        scheme, *interop.from_reference(w0, data, eval_data, device=CPU),
        tau=TAU)
    _assert_matches(res, _oracle(scheme, w0, data, eval_data))


@pytest.mark.parametrize("scheme", ["delta", "average"])
def test_routes_and_oracle_bitwise_on_cpu(scheme):
    """fused (window kernel) == fused=False (per-step delta kernel) ==
    use_kernels=False (core.vq.H) == the port's own oracle, to the bit."""
    ins = interop.from_reference(*_setup(8), device=CPU)
    runs = [MeshExecutor(InstantNetwork(), fused=f, use_kernels=u,
                         device="cpu").run(scheme, *ins, tau=TAU)
            for f, u in ((True, True), (False, True), (True, False))]
    fn = schemes.scheme_delta if scheme == "delta" else schemes.scheme_average
    runs.append(fn(*ins, tau=TAU))
    for r in runs[1:]:
        assert torch.equal(r.w_shared, runs[0].w_shared)
        assert torch.equal(r.distortion, runs[0].distortion)


@pytest.mark.parametrize("scheme", ["delta", "average"])
def test_merge_wire_bytes_match_bench_comm(scheme):
    """m=8, n=200, d=8, kappa=16, tau=10: the dense merge wire that
    BENCH_comm.json records for both sync schemes."""
    bench = json.loads((REPO / "BENCH_comm.json").read_text())
    ex = MeshExecutor(InstantNetwork(), device="cpu")
    ex.run(scheme, *interop.from_reference(*_setup(8), device=CPU), tau=TAU)
    merge = ex.last_comm["by_tag"]["merge"]
    assert merge["wire_bytes"] == 17_920
    assert merge["logical_bytes"] == 10_240
    assert merge["calls"] == 20
    assert ex.last_comm["by_tag"]["eval"]["calls"] == 20
    assert 17_920 in _bench_values(bench, "merge_wire_bytes")
    assert 10_240 in _bench_values(bench, "merge_logical_bytes")


def _bench_values(obj, key):
    if isinstance(obj, dict):
        out = [obj[key]] if key in obj else []
        for v in obj.values():
            out += _bench_values(v, key)
        return out
    if isinstance(obj, list):
        return [x for v in obj for x in _bench_values(v, key)]
    return []


def test_network_ticks_match_reference():
    pairs = [(InstantNetwork(), JInstant()),
             (FixedLatencyNetwork(latency_ticks=3), JFixed(latency_ticks=3)),
             (FixedLatencyNetwork(latency_ticks=1, bytes_per_tick=100,
                                  dcn_bytes_per_tick=7),
              JFixed(latency_ticks=1, bytes_per_tick=100,
                     dcn_bytes_per_tick=7)),
             (GeometricDelayNetwork(p_delay=0.3), JGeometric(p_delay=0.3))]
    for ours, theirs in pairs:
        for tau in (1, 10, 25):
            assert ours.window_ticks(tau) == theirs.window_ticks(tau)
        for wire in (0, 1, 99, 100, 896, 17_920):
            for tier in (None, 0, 1):
                assert (ours.transfer_ticks(wire, tier=tier)
                        == theirs.transfer_ticks(wire, tier=tier))
    with pytest.raises(ValueError):
        FixedLatencyNetwork(latency_ticks=-1)
    with pytest.raises(ValueError):
        get_network("nope")


@pytest.mark.devices(8)
def test_fixed_latency_mesh_ticks_match_reference_mesh():
    """Same network, same inputs: the port's wall ticks (window ticks plus
    the measured merge wire's transfer ticks) are the reference mesh's."""
    w0, data, eval_data = _setup(8)
    net = dict(latency_ticks=2, bytes_per_tick=100)
    ours = MeshExecutor(FixedLatencyNetwork(**net), device="cpu")
    res = ours.run("delta", *interop.from_reference(w0, data, eval_data,
                                                    device=CPU), tau=TAU)
    theirs = JMeshExecutor(network=JFixed(**net))
    ref = theirs.run("delta", jnp.asarray(w0), jnp.asarray(data),
                     jnp.asarray(eval_data), tau=TAU)
    np.testing.assert_array_equal(res.wall_ticks.numpy(),
                                  np.asarray(ref.wall_ticks))
    assert int(res.wall_ticks[0]) == TAU + 2 + 9   # ceil(896 / 100) = 9
    for tag in ("merge", "eval"):
        for k in ("wire_bytes", "logical_bytes", "calls"):
            assert (ours.last_comm["by_tag"][tag][k]
                    == theirs.last_comm["by_tag"][tag][k])
    np.testing.assert_allclose(res.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)


def test_interop_round_trips():
    w0, data, eval_data = _setup(8)
    tw0, tdata, teval = interop.from_reference(
        jnp.asarray(w0), jnp.asarray(data), jnp.asarray(eval_data),
        device=CPU)
    for t, a in ((tw0, w0), (tdata, data), (teval, eval_data)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)
    oracle = _oracle("delta", w0, data, eval_data)
    res = interop.result_from_reference(oracle, device=CPU)
    back = interop.to_numpy(res)
    assert back.wall_ticks.dtype == np.int32
    for a, b in zip(back, oracle):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="dims"):
        interop.from_reference(w0[None], data, eval_data,
                               device=CPU)
    with pytest.raises(ValueError, match="d disagrees"):
        interop.from_reference(w0[:, :4], data, eval_data,
                               device=CPU)
    with pytest.raises(ValueError, match="M disagrees"):
        interop.from_reference(w0, data, eval_data[:4],
                               device=CPU)
    with pytest.raises(TypeError, match="kind"):
        interop.from_reference(w0.astype(np.int32), data, eval_data,
                               device=CPU)


def test_launch_train_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--mode", "vq", "--executor", "mesh",
                         "--scheme", "delta", "--workers", "8",
                         "--points", "200", "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0
    assert "executor=mesh scheme=delta M=8" in text
    assert text.count("  ticks ") == 10
    assert "done: C(final)=" in text and "us/point" in text
    assert "merge wire 17,920 B / logical 10,240 B" in text
    with contextlib.redirect_stdout(io.StringIO()):
        assert train.main(["--mode", "vq", "--points", "5", "--device",
                           "cpu"]) == 2


def test_launchers_pin_tf32_off():
    """Both launchers run f32 products in full f32 whatever the process set
    before (TF32 would flip near-tie assignments against the reference)."""
    from repro_torch.launch import serve
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        for main, argv in (
                (train.main, ["--mode", "vq", "--workers", "2", "--points",
                              "20"]),
                (serve.main, ["--mode", "vq", "--smoke", "--requests", "4",
                              "--dim", "8", "--kappa", "8", "--tick-ms",
                              "0"])):
            torch.set_float32_matmul_precision("high")
            torch.backends.cudnn.allow_tf32 = True
            assert torch.backends.cuda.matmul.allow_tf32
            with contextlib.redirect_stdout(io.StringIO()):
                assert main(argv + ["--device", "cpu"]) == 0
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_synthetic_data_is_seeded_and_shaped():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        data = synthetic.replicate_stream(gen, 3, n=50, d=4)
        return data, synthetic.kmeanspp_init(gen, data.reshape(-1, 4), 16)

    data, w0 = draw(5)
    again, w0_again = draw(5)
    assert data.shape == (3, 50, 4) and data.dtype == torch.float32
    assert torch.equal(data, again) and torch.equal(w0, w0_again)
    assert not torch.equal(data, draw(6)[0])
    # w0 is 16 distinct points of the data
    flat = data.reshape(-1, 4)
    assert all(bool((flat == row).all(dim=1).any()) for row in w0)
    assert len({tuple(r.tolist()) for r in w0}) == 16
    gen = torch.Generator().manual_seed(0)
    assert synthetic.mixture_data(gen, n=20, d=4).shape == (20, 4)
    assert synthetic.split_workers(flat, 4).shape == (4, 37, 4)
    with pytest.raises(ValueError):
        synthetic.kmeanspp_init(gen, flat, 1000)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError):
        MeshExecutor()
    with pytest.raises(RuntimeError):
        SimExecutor()
    with pytest.raises(RuntimeError):
        get_executor("mesh")
    with pytest.raises(RuntimeError):
        interop.from_reference(*_setup(1))
    with pytest.raises(RuntimeError):
        train.main(["--mode", "vq", "--executor", "mesh", "--points", "20"])
    assert device.resolve("cpu").type == "cpu"
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_scheme_and_factory_validation():
    assert validate_scheme("delta") == "delta"
    assert validate_scheme("async_delta") == "async_delta"
    with pytest.raises(ValueError):
        validate_scheme("nope")
    with pytest.raises(ValueError):
        get_executor("pigeon")
    assert get_executor("thread", device="cpu").name == "thread"
    with pytest.raises(ValueError):
        comm.get_transport("pigeon")
    with pytest.raises(ValueError):
        merge_lib.get_merge("pigeon")
    assert merge_lib.get_merge("quorum").name == "quorum"
    t = comm.get_transport("xla")
    assert comm.get_transport(t) is t
    with pytest.raises(ValueError):
        t.all_reduce(torch.ones(2, 3), op="max")
    ex = MeshExecutor(device="cpu")
    w0, data, eval_data = interop.from_reference(*_setup(2), device=CPU)
    with pytest.raises(ValueError, match="window"):
        ex.run("delta", w0, data[:, :5], eval_data, tau=TAU)
    with pytest.raises(ValueError, match="lengths"):
        ex.run("async_delta", w0, data, eval_data, tau=TAU,
               lengths=torch.full((2, 3), TAU, dtype=torch.int32))


def test_comm_log_is_bounded_and_marks_survive_trims():
    log = comm.CommLog(max_records=3)
    rec = comm.CommRecord(op="sum", transport="xla", axis="workers",
                          participants=8, logical_bytes=512,
                          wire_bytes=comm.ring_wire_bytes(512, 8))
    assert rec.wire_bytes == 896 and comm.ring_wire_bytes(512, 1) == 0
    mark = log.mark()
    # five distinct collectives: the log keeps the newest three
    kinds = [dataclasses.replace(rec, participants=p) for p in range(1, 6)]
    log.extend(kinds)
    assert len(log.records) == 3 and log.mark() == mark + 5
    assert log.since(mark) == kinds[2:] and log.since(mark + 4) == kinds[4:]
    # repeats since the latest mark fold into one record per collective
    mark = log.mark()
    ev = dataclasses.replace(rec, tag="eval")
    for _ in range(20_000):
        log.append(rec)
        log.append(ev)
    assert len(log.since(mark)) == 2 and log.mark() == mark + 2
    summary = comm.CommLog.summarize(log.since(mark))
    assert summary["wire_bytes"] == 40_000 * 896
    assert summary["by_tag"]["merge"]["calls"] == 20_000
    # after a new mark a repeat starts its own record; the old mark sees both
    mark2 = log.mark()
    log.append(rec)
    assert log.since(mark2) == [rec]
    assert comm.CommLog.summarize(
        log.since(mark))["by_tag"]["merge"]["calls"] == 20_001
    assert comm.tree_f32_bytes(torch.ones(4, 4)) == 64
    assert comm.tree_f32_bytes(torch.ones(4, dtype=torch.int32),
                               floating_only=True) == 0
    with pytest.raises(ValueError):
        comm.CommLog(max_records=0)


def test_last_comm_exact_past_the_log_bound():
    """33,000 windows log 66,000 collectives, past the log's 65,536 records:
    last_comm and the wall ticks it prices still count every one."""
    n = 33_000
    rng = np.random.default_rng(3)
    data = rng.random((2, n, 1), dtype=np.float32)
    w0 = rng.random((2, 1), dtype=np.float32)
    ex = MeshExecutor(FixedLatencyNetwork(latency_ticks=0, bytes_per_tick=1),
                      device="cpu")
    assert 2 * n > ex.transport.log.max_records
    res = ex.run("delta", *interop.from_reference(w0, data, data[:, :4],
                                                  device=CPU), tau=1)
    # merge: 2 floats per worker, ring wire 2*(2-1)/2 * 8 B; eval: 1 float
    assert ex.last_comm["by_tag"] == {
        "merge": {"calls": n, "logical_bytes": 8 * n, "wire_bytes": 8 * n},
        "eval": {"calls": n, "logical_bytes": 4 * n, "wire_bytes": 4 * n}}
    assert len(ex.transport.log.records) == 2
    # tau=1 tick plus 8 merge-wire bytes at 1 B per tick, every window
    assert int(res.wall_ticks[-1]) == 9 * n
