"""The three phase metrics (``metrics/{local,merge,eval}_us_per_step.py``)
on the CPU: the counters they declare, a traced run that reports them and
an untraced one that does not, and a program without the counters."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

from vqbench import harness, phases, trace_reader  # noqa: E402

TINY = dict(kappa=16, d=8, points_per_worker=400, job_points=200, n_eval=40)
METRICS = ("local_us_per_step", "merge_us_per_step", "eval_us_per_step")
MESH = "repro_torch.engine.mesh"


@pytest.fixture(autouse=True)
def _one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


def test_the_metrics_declare_four_counters_with_one_path_each():
    spec = harness.metric_counters(METRICS)
    assert spec == {f"phase_ns_{p}": f"{MESH}.phase_ns_{p}"
                    for p in ("local", "merge", "eval")} | {
        "phase_steps": f"{MESH}.phase_steps"}
    values = harness.read_counters(spec)
    assert all(isinstance(v, int) and v >= 0 for v in values.values())


@pytest.mark.parametrize("cell", ["sift1m.sync_delta",
                                  "dbpedia3072.async_delta"])
def test_a_traced_run_reports_the_three_phases(cell):
    r = harness.run_cell(cell, seed=2**31 + 17, seconds=0.1, trace=True,
                         device="cpu", sizes=TINY)
    assert r["correct"]
    for m in METRICS:
        assert r["metrics"][m]["unit"] == "us/step"
        assert r["metrics"][m]["value"] > 0.0, m


def test_an_untraced_run_reports_none_of_them():
    r = harness.run_cell("sift1m.sync_delta", seed=2**31 + 17, seconds=0.1,
                         trace=False, device="cpu", sizes=TINY)
    assert not set(r["metrics"]) & set(METRICS)


def test_a_program_without_the_counters_declares_none(monkeypatch):
    """The metric files over a program from before the phase counters: no
    counter for the harness to read, and no value."""
    mesh = sys.modules.get(MESH) or __import__(MESH, fromlist=["_"])
    for name in ("phase_ns_local", "phase_ns_merge", "phase_ns_eval",
                 "phase_steps"):
        monkeypatch.delattr(mesh, name)
    assert harness.metric_counters(METRICS) == {}
    ctx = harness.TraceContext(
        plan=None, trace=trace_reader.Trace(0.0, 1.0, [], []), jobs=1,
        steps=1, counts={})
    for m in METRICS:
        assert harness.read_metric(m, ctx) is None


def test_a_phase_reads_its_nanoseconds_over_the_steps_timed():
    ctx = harness.TraceContext(
        plan=None, trace=trace_reader.Trace(0.0, 1.0, [], []), jobs=1,
        steps=4, counts={"phase_ns_local": 8_000, "phase_ns_merge": 2_000,
                         "phase_ns_eval": 0, "phase_steps": 4})
    assert [harness.read_metric(m, ctx) for m in METRICS] == [2.0, 0.5, 0.0]
    ctx.counts = {"phase_ns_local": 0, "phase_steps": 0}
    assert phases.us_per_step(ctx, "local") is None
