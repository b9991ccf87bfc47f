"""The measured phases of a ``MeshExecutor`` run (``obs.trace.PhaseClock``):
``local``, ``merge`` and ``eval`` marked on the device's clock (on the CPU,
``time.perf_counter_ns``) when a ``torch.profiler`` is active, a tracer is
enabled or a profiler attached, and nothing at all otherwise.

Every case runs the three schemes of the executor's two loops (eq. 3 and
eq. 8 windows, eq. 9 ticks) at a small size: a bare run moves no counter
and builds no clock; under the profiler a run keeps its bits, counts its
steps and phases, names its phases in the profiler's trace and leaves
observation (the divergence kernel, the eval's tuple collective) off; with
a tracer the ``"device"`` spans follow one another inside the ``run`` span
and pass ``check_trace``; an attached ``Profiler`` gets ``measured_s``.
"""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.engine import (ElasticMeshExecutor, GeometricDelayNetwork,
                                InstantNetwork)
from repro_torch.engine import mesh
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.kernels import vq_fused
from repro_torch.obs import PHASES, Profiler, Tracer, check_trace

M, N, D, KAPPA, TAU, N_EVAL, EVAL_EVERY = 4, 100, 8, 16, 10, 30, 10
SCHEMES = ["delta", "average", "async_delta"]
# the anchor's tolerance on the CPU: the clock reads around the anchor mark
ANCHOR_US = 1e3


@pytest.fixture(autouse=True)
def _one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


def _inputs(m=M, n=N, seed=5):
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand(10, D, generator=g)
    pick = torch.randint(0, 10, (m, n), generator=g)
    data = centers[pick] + 0.05 * torch.randn(m, n, D, generator=g)
    w0 = data.reshape(-1, D)[torch.randperm(m * n, generator=g)[:KAPPA]]
    return w0.clone(), data, data[:, :N_EVAL].clone()


def _run(ex, scheme, ins=None):
    return ex.run(scheme, *(ins or _inputs()), tau=TAU,
                  generator=torch.Generator().manual_seed(11))


def _executor(**kw):
    return MeshExecutor(GeometricDelayNetwork(0.5), eval_every=EVAL_EVERY,
                        device="cpu", **kw)


def _steps(scheme, n=N):
    """(steps, evals) of a run: windows, or ticks and their evals."""
    if scheme == "async_delta":
        return n, n // EVAL_EVERY
    return n // TAU, n // TAU


def _counters():
    return {k: getattr(mesh, k) for k in
            ("phase_ns_local", "phase_ns_merge", "phase_ns_eval",
             "phase_steps")}


def _same_bits(a, b):
    return (torch.equal(a.w_shared.view(torch.int32),
                        b.w_shared.view(torch.int32))
            and torch.equal(a.distortion.view(torch.int32),
                            b.distortion.view(torch.int32)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_a_bare_run_is_not_timed_and_a_profiled_run_keeps_its_bits(
        scheme, monkeypatch):
    def no_clock(*args, **kwargs):
        raise AssertionError("an untimed run built a PhaseClock")

    before = _counters()
    with monkeypatch.context() as mp:
        mp.setattr(mesh, "PhaseClock", no_clock)
        bare = _run(_executor(), scheme)
    assert _counters() == before
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _run(_executor(), scheme)
    assert _same_bits(profiled, bare)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_a_profiled_run_counts_its_steps_and_names_its_phases(scheme,
                                                              tmp_path):
    steps, evals = _steps(scheme)
    ex = _executor()
    ins = _inputs()
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = time.perf_counter_ns()
        _run(ex, scheme, ins)
        wall_ns = time.perf_counter_ns() - t
    after = _counters()
    moved = {k: after[k] - before[k] for k in after}
    assert moved["phase_steps"] == steps
    for phase in PHASES:
        assert moved[f"phase_ns_{phase}"] > 0, phase
    assert sum(moved[f"phase_ns_{p}"] for p in PHASES) <= wall_ns
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    assert names.count("repro_torch.local") == steps
    assert names.count("repro_torch.merge") == steps
    assert names.count("repro_torch.eval") == evals


@pytest.mark.parametrize("scheme", SCHEMES)
def test_the_profiler_does_not_turn_observation_on(scheme, monkeypatch):
    """No divergence kernel and no tuple eval under the profiler; a tracer
    (observation) calls the divergence on every sync window."""
    calls = []
    divergence = mesh.ops.vq_divergence

    def counted(*args):
        calls.append(1)
        return divergence(*args)

    monkeypatch.setattr(mesh.ops, "vq_divergence", counted)
    launched = vq_fused.launches_divergence
    ex = _executor()
    with profile(activities=[ProfilerActivity.CPU]):
        _run(ex, scheme)
    assert not ex._observe
    assert calls == [] and vq_fused.launches_divergence == launched
    _run(_executor(tracer=Tracer()), scheme)
    assert len(calls) == (0 if scheme == "async_delta" else N // TAU)


def _device_spans(tr):
    return [s for s in tr.spans() if s.process == Tracer.DEVICE_PROCESS]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_traced_phases_follow_one_another_inside_the_run(scheme):
    steps, evals = _steps(scheme)
    tr = Tracer()
    _run(_executor(tracer=tr), scheme)
    _run(_executor(tracer=tr), scheme)
    spans = _device_spans(tr)
    runs = tr.spans("run")
    assert len(runs) == 2
    for r, run in enumerate(runs):
        mine = [s for s in spans if s.attrs["run"] == r]
        names = [s.name for s in mine]
        assert names.count("local_phase") == steps
        assert names.count("merge_phase") == steps
        assert names.count("eval_phase") == evals
        assert {s.track for s in mine} == {"phases"}
        assert [s.attrs["step"] for s in mine
                if s.name == "local_phase"] == list(range(steps))
        for a, b in zip(mine, mine[1:]):
            assert a.start_us + a.dur_us <= b.start_us + 1e-6
        lo, hi = run.start_us, run.start_us + run.dur_us
        assert mine[0].start_us >= lo - ANCHOR_US
        assert mine[-1].start_us + mine[-1].dur_us <= hi + ANCHOR_US
    # the modeled tick timeline and the host's wall spans are still there
    assert any(s.process == Tracer.TICK_PROCESS for s in tr.spans())
    assert check_trace(tr.chrome_events(), expect_spans=[
        "local_phase", "merge_phase", "eval_phase"]) == []


def test_a_segment_is_timed_from_its_global_window():
    tr = Tracer()
    before = _counters()["phase_steps"]
    w0, data, eval_data = _inputs()
    ex = MeshExecutor(InstantNetwork(), tracer=tr, device="cpu")
    ex.run_segment("delta", w0, data, eval_data, tau=TAU, t0=5 * TAU)
    # the marks wait for the caller's drain
    assert _device_spans(tr) == []
    assert _counters()["phase_steps"] == before
    ex.read_phases()
    spans = _device_spans(tr)
    assert [s.attrs["step"] for s in spans if s.name == "local_phase"] == \
        list(range(5, 5 + N // TAU))
    assert {s.attrs["run"] for s in spans} == {None}
    assert _counters()["phase_steps"] - before == N // TAU


def test_an_elastic_run_times_each_segment_under_its_run():
    tr = Tracer()
    before = _counters()["phase_steps"]
    w0, data, eval_data = _inputs(m=4, n=200)
    ElasticMeshExecutor([(5, 2)], InstantNetwork(), tracer=tr,
                        device="cpu").run("delta", w0, data, eval_data,
                                          tau=TAU)
    spans = _device_spans(tr)
    locals_ = [s.attrs["step"] for s in spans if s.name == "local_phase"]
    assert len(tr.spans("segment")) == 2
    assert locals_ == list(range(len(locals_))) and len(locals_) > 5
    assert {s.attrs["run"] for s in spans} == {0}
    assert _counters()["phase_steps"] - before == len(locals_)
    assert check_trace(tr.chrome_events()) == []


@pytest.mark.parametrize("scheme", SCHEMES)
def test_a_profiler_attribution_carries_the_measured_phases(scheme,
                                                            tmp_path):
    prof = Profiler()
    _run(_executor(profiler=prof), scheme)
    (rec,) = prof.attributions
    measured = rec["measured_s"]
    assert set(measured) == set(PHASES)
    assert all(v > 0.0 for v in measured.values())
    assert sum(measured.values()) * rec["n_windows"] <= rec["wall_s"]
    path = tmp_path / "prof.json"
    prof.export_json(str(path))
    assert json.loads(path.read_text())["attributions"][0]["measured_s"] \
        == measured
