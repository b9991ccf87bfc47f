"""The port's roofline profiler (``repro_torch.obs.profile``,
``distributed.roofline``, ``distributed.comm_analysis``) and report
(``repro_torch.obs.report``) held against ``repro.obs.profile``,
``repro.distributed.roofline`` and ``repro.obs.report``, mirroring
``tests/test_profile.py`` at its shapes (M=4, N=400, D=8, KAPPA=16,
TAU=50) on the CPU.

* ``VqCell``'s hand counts equal the reference's exactly over a grid of
  shapes, and ``vq_roofline_terms`` too with the reference's constants.
* With one worker a device and the reference's constants patched in, the
  port's ``Profiler`` gives the reference's attribution records, gauges and
  counters bit for bit on the same segments and programs; with M stacked
  workers (the per-card rule) its terms are M times those.
* Profiled mesh runs: the terms sum to the measured window wall within the
  reference's 15% bar; ``collective_bytes_per_window * n_windows`` equals
  the reference's profiled program's HLO collective bytes (rel 1e-6) and
  the port's ``CommLog`` logical bytes; ``loops`` holds the window count
  and tau (eq. 9: the ticks) as the reference's HLO trip counts do; the
  dynamic merge's bytes are its records before re-pricing, as the
  reference's HLO counts the merge every window.
* The report renders the same HTML, byte for byte, as the reference's on
  the repo's ``BENCH_*.json`` plus a profile export.

The regression-gate tests of ``tests/test_profile.py:197-280`` test
``benchmarks/check_regression.py``, which is not ported.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.distributed import roofline as jroofline
from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMesh
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Profiler as JProfiler
from repro.obs import profile as jprofile
from repro.obs import report as jreport
from repro_torch.comm.api import CommRecord
from repro_torch.data import synthetic
from repro_torch.distributed import comm_analysis, roofline
from repro_torch.engine import ElasticMeshExecutor, InstantNetwork
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.obs import MetricsRegistry, Profiler
from repro_torch.obs import report

torch.set_num_threads(1)

M, N, D, KAPPA, TAU = 4, 400, 8, 16, 50
KAPPA_SIFT = 4096
REPO = pathlib.Path(__file__).resolve().parents[1]
TERMS = ("compute", "memory", "collective", "host")
REF_PEAKS = {"PEAK_FLOPS": jroofline.PEAK_FLOPS, "HBM_BW": jroofline.HBM_BW,
             "COLLECTIVE_BW": jroofline.ICI_BW}


def _inputs(m=M, n=N):
    """numpy-made (w0, data, eval_data) as the port's tensors and the
    reference's arrays."""
    w0, data = synthetic.numpy_mixture(0, m, n, D, KAPPA)
    eval_data = data[:, :100].contiguous()
    port = (w0, data, eval_data)
    ref = tuple(jnp.asarray(t.numpy()) for t in port)
    return port, ref


def _port_run(scheme, *, m=M, merge=None, runs=1):
    reg = MetricsRegistry()
    prof = Profiler(metrics=reg)
    kw = ({"merge": "dynamic", "divergence_thresh": 1e-3}
          if merge == "dynamic" else {})
    ex = MeshExecutor(InstantNetwork(), profiler=prof, metrics=reg,
                      device="cpu", **kw)
    port, _ = _inputs(m=m)
    for _ in range(runs):
        ex.run(scheme, *port, tau=TAU)
    return prof, reg, ex


_REF_RUNS = {}


def _ref_run(scheme, merge=None):
    """The reference's profiled run on the same inputs (cached: each
    compiles a program)."""
    key = (scheme, merge)
    if key not in _REF_RUNS:
        prof = JProfiler()
        kw = ({"merge": "dynamic", "divergence_thresh": 1e-3}
              if merge == "dynamic" else {})
        ex = JMesh(network=JInstant(), profiler=prof, **kw)
        _, ref = _inputs()
        ex.run(scheme, *ref, tau=TAU, eps0=0.5, key=jax.random.PRNGKey(0))
        _REF_RUNS[key] = (prof, ex)
    return _REF_RUNS[key]


def _ref_constants(monkeypatch):
    for name, value in REF_PEAKS.items():
        monkeypatch.setattr(roofline, name, value)


# ---------------------------------------------------------------------------
# VqCell and vq_roofline_terms
# ---------------------------------------------------------------------------

CELLS = [(8, 16, 50, 100, 1), (128, 4096, 10, 1000, 1),
         (3072, 4096, 10, 1000, 8), (128, 4096, 10, 0, 1000),
         (7, 1001, 3, 37, 129), (2048, 64, 1, 5, 300)]


@pytest.mark.parametrize("d,kappa,tau,n_eval,batch", CELLS)
def test_vqcell_counts_equal_the_reference(d, kappa, tau, n_eval, batch):
    got = roofline.VqCell(d=d, kappa=kappa, tau=tau, n_eval=n_eval)
    want = jroofline.VqCell(d=d, kappa=kappa, tau=tau, n_eval=n_eval)
    for name in ("step_flops", "eval_flops", "merge_flops", "window_flops",
                 "window_hbm_bytes", "merge_collective_bytes"):
        assert getattr(got, name)() == getattr(want, name)(), name
    for name in ("delta_grid", "delta_flops", "delta_hbm_bytes"):
        assert getattr(got, name)(batch) == getattr(want, name)(batch), name


@pytest.mark.parametrize("coll", [None, 520.0, 25620.0])
def test_roofline_terms_equal_the_reference_at_its_constants(monkeypatch,
                                                             coll):
    _ref_constants(monkeypatch)
    cell = (8, 16, 50, 100)
    got = roofline.vq_roofline_terms(roofline.VqCell(*cell),
                                     collective_bytes_per_window=coll)
    want = jroofline.vq_roofline_terms(jroofline.VqCell(*cell),
                                       collective_bytes_per_window=coll)
    assert got == want


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.COLLECTIVE_BW == roofline.HBM_BW


def test_sift1m_worked_check_per_card():
    """d=128, kappa=4096, tau=10, 1,000 eval points, M=8 stacked: ~131 us
    of compute, ~112 us of HBM and ~5 us of merge a window."""
    prof = Profiler()
    prof.record_program("p", [
        CommRecord("sum", "xla", "workers", 8, 4 * KAPPA_SIFT * 128,
                   2 * 7 * 4 * KAPPA_SIFT * 128 // 8, calls=10),
        CommRecord("mean", "xla", "workers", 8, 8, 14, calls=10,
                   tag="eval")], [("window", 10), ("step", 10)])
    prof.note_segment(program="p", scheme="delta", transport="xla",
                      topology="flat", m=8, n_windows=10, d=128,
                      kappa=KAPPA_SIFT, tau=10, n_eval=1000,
                      workers_per_device=8)
    a = prof.finish_run(10 * 742.7e-6)
    assert a["t_compute_s"] == pytest.approx(130.8e-6, rel=1e-3)
    assert a["t_memory_s"] == pytest.approx(111.8e-6, rel=1e-3)
    assert a["t_collective_s"] == pytest.approx(5.008e-6, rel=1e-3)
    assert a["collective_bytes_per_window"] == 2_097_160
    assert a["consistency"] <= 0.15


# ---------------------------------------------------------------------------
# Profiler arithmetic against the reference's
# ---------------------------------------------------------------------------

SEGMENTS = {
    "one sync program": [("p0", 8, 4, 100, 4160.0)],
    "two elastic segments": [("p0", 20, 8, 100, 10400.0),
                             ("p1", 19, 4, 100, 9880.0)],
    "no program: the dense merge": [(None, 8, 4, 100, None)],
    "eq. 9 nominal windows": [("p2", 8, 4, 500, 204960.0)],
}


@pytest.mark.parametrize("wall", [0.123, 1e-9])
@pytest.mark.parametrize("case", list(SEGMENTS))
def test_profiler_equals_reference_bitwise_at_one_worker_a_device(
        monkeypatch, case, wall):
    _ref_constants(monkeypatch)
    reg, jreg = MetricsRegistry(), JRegistry()
    got, want = Profiler(metrics=reg), JProfiler(metrics=jreg)
    for key, n_windows, m, n_eval, coll in SEGMENTS[case]:
        if key is not None:
            got.record_program(key, [CommRecord(
                "sum", "xla", "workers", m, int(coll) // n_windows, 0,
                calls=n_windows)], [("window", n_windows), ("step", TAU)])
            want.programs[key] = jprofile.ProgramCost(
                key=key, collective_bytes=coll,
                bytes_by_kind={"all-reduce": coll},
                loops=[("while", n_windows), ("while", TAU)],
                cost_flops=None, cost_bytes=None)
            assert got.programs[key].collective_bytes == coll
        shapes = dict(program=str(key), scheme="delta", transport="xla",
                      topology="flat", m=m, n_windows=n_windows, d=D,
                      kappa=KAPPA, tau=TAU, n_eval=n_eval, compiled=True)
        got.note_segment(**shapes, workers_per_device=1)
        want.note_segment(**shapes)
    a, b = got.finish_run(wall), want.finish_run(wall)
    assert a.pop("workers_per_device") == 1
    assert list(a.pop("peaks").values()) == list(b.pop("peaks").values())
    assert a == b
    for term in TERMS:
        labels = {"scheme": "delta", "transport": "xla"}
        assert (reg.gauge("roofline_efficiency", term=term, **labels).value
                == jreg.gauge("roofline_efficiency", term=term,
                              **labels).value)
        assert (reg.counter(f"attributed_{term}_ns", **labels).value
                == jreg.counter(f"attributed_{term}_ns", **labels).value)
    assert got.summary_table() == want.summary_table()


def test_per_card_rule_multiplies_the_terms_by_the_stacked_workers():
    def attribute(per_device):
        prof = Profiler()
        prof.record_program("p", [CommRecord(
            "sum", "xla", "workers", M, 520, 780, calls=8)],
            [("window", 8), ("step", TAU)])
        prof.note_segment(program="p", scheme="delta", transport="xla",
                          topology="flat", m=M, n_windows=8, d=D,
                          kappa=KAPPA, tau=TAU, n_eval=100,
                          workers_per_device=per_device)
        return prof.finish_run(1.0)

    one, stacked = attribute(1), attribute(M)
    for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                "window_flops", "window_hbm_bytes"):
        assert stacked[key] == pytest.approx(M * one[key], rel=1e-12), key
    assert stacked["collective_bytes_per_window"] == 520.0
    assert stacked["workers_per_device"] == M
    # the host residual takes what the larger modeled terms leave
    assert stacked["t_host_s"] < one["t_host_s"]


def test_comm_analysis_kinds_and_host_records():
    recs = [CommRecord("sum", "xla", "workers", 4, 512, 768, calls=8),
            CommRecord("sum", "sparse", "workers", 4, 512, 96, calls=8),
            CommRecord("mean", "ring", "workers", 4, 8, 12, calls=8,
                       tag="eval"),
            CommRecord("host", "xla", "workers", 2, 512, 512, calls=1,
                       tag="late_delta")]
    out = comm_analysis.analyze_collectives(recs, [("window", 8),
                                                   ("step", 10)])
    assert out == {"total_bytes": 8256,
                   "bytes_by_kind": {"all-reduce": 4160,
                                     "all-gather": 4096},
                   "loops": [("window", 8), ("step", 10)]}


# ---------------------------------------------------------------------------
# profiled mesh runs (tests/test_profile.py:53-165)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["average", "delta", "async_delta"])
def test_attribution_sums_to_measured_wall(scheme):
    prof, _, _ = _port_run(scheme)
    assert len(prof.attributions) == 1
    a = prof.attributions[0]
    assert a["scheme"] == scheme
    assert a["consistency"] <= 0.15
    total = sum(a[f"t_{t}_s"] for t in TERMS)
    assert total == pytest.approx(a["attributed_window_s"])
    assert a["window_wall_s"] > 0
    assert a["compiled_in_run"] is True
    assert a["workers_per_device"] == M
    assert a["n_windows"] == N // TAU


@pytest.mark.devices(4)
@pytest.mark.parametrize("scheme,merge", [
    ("average", None), ("delta", None), ("async_delta", None),
    ("delta", "dynamic")])
def test_collective_bytes_match_reference_hlo_and_commlog(scheme, merge):
    prof, _, ex = _port_run(scheme, merge=merge)
    a = prof.attributions[0]
    got = a["collective_bytes_per_window"] * a["n_windows"]
    jprof, _ = _ref_run(scheme, merge)
    (jprog,) = jprof.programs.values()
    assert got == pytest.approx(jprog.collective_bytes, rel=1e-6)
    (prog,) = prof.programs.values()
    assert prog.bytes_by_kind == {"all-reduce": prog.collective_bytes}
    commlog = sum(ex.transport.log.logical_bytes_by_tag().values())
    if merge == "dynamic":
        # the log re-prices the merge to the windows that merged; the
        # program (and the reference's HLO) counts it every window
        assert commlog < got
        assert 0 < ex.last_triggers.sum() < N // TAU
    else:
        assert got == pytest.approx(commlog, rel=1e-6)


@pytest.mark.devices(4)
@pytest.mark.parametrize("scheme", ["delta", "async_delta"])
def test_loops_pin_the_window_loop(scheme):
    """Sync: the window loop = n_windows, the step loop = tau; eq. 9: the
    tick loop = n.  The reference's HLO trip counts are the same."""
    prof, _, _ = _port_run(scheme)
    (prog,) = prof.programs.values()
    if scheme == "delta":
        assert prog.loops == [("window", N // TAU), ("step", TAU)]
    else:
        assert prog.loops == [("tick", N)]
    jprof, _ = _ref_run(scheme)
    (jprog,) = jprof.programs.values()
    assert sorted(t for _, t in prog.loops) == sorted(
        t for _, t in jprog.loops)
    assert prog.cost_flops is None and prog.cost_bytes is None


def test_metrics_emission_gauges_and_counters():
    prof, reg, _ = _port_run("average")
    for term in TERMS:
        g = reg.gauge("roofline_efficiency", term=term, scheme="average",
                      transport="xla")
        assert g.value >= 0.0
        c = reg.counter(f"attributed_{term}_ns", scheme="average",
                        transport="xla")
        assert c.value >= 0.0
    a = prof.attributions[0]
    host_ns = reg.counter("attributed_host_ns", scheme="average",
                          transport="xla").value
    assert host_ns == pytest.approx(
        a["t_host_s"] * a["n_windows"] * 1e9, rel=1e-6)


@pytest.mark.parametrize("scheme", ["delta", "async_delta"])
def test_second_run_reuses_the_recorded_program(scheme):
    prof, _, _ = _port_run(scheme, runs=2)
    assert len(prof.programs) == 1
    assert [a["compiled_in_run"] for a in prof.attributions] == [True, False]


def test_a_profiler_turns_observation_on_and_changes_no_bit():
    port, _ = _inputs()
    bare = MeshExecutor(InstantNetwork(), device="cpu").run("delta", *port,
                                                            tau=TAU)
    ex = MeshExecutor(InstantNetwork(), profiler=Profiler(), device="cpu")
    assert ex._observe
    prof = ex.run("delta", *port, tau=TAU)
    assert torch.equal(bare.distortion, prof.distortion)
    assert torch.equal(bare.w_shared, prof.w_shared)


@pytest.mark.devices(8)
def test_elastic_shares_one_profiler_across_segments():
    prof = Profiler()
    ex = ElasticMeshExecutor([(20, 4)], InstantNetwork(), profiler=prof,
                             device="cpu")
    port, ref = _inputs(m=8)
    ex.run("delta", *port, tau=10)
    assert len(prof.attributions) == 1
    a = prof.attributions[0]
    assert a["segments"] == 2
    assert a["consistency"] <= 0.15
    assert len(prof.programs) == 2
    # the same segments and bytes as the reference's elastic run
    jprof = JProfiler()
    JElastic([(20, 4)], network=JInstant(), profiler=jprof).run(
        "delta", *ref, tau=10, eps0=0.5, key=jax.random.PRNGKey(0))
    b = jprof.attributions[0]
    for key in ("segments", "n_windows", "m"):
        assert a[key] == b[key], key
    assert a["collective_bytes_per_window"] == pytest.approx(
        b["collective_bytes_per_window"], rel=1e-6)


def test_export_json_roundtrip(tmp_path):
    prof, _, _ = _port_run("delta")
    p = tmp_path / "prof.json"
    prof.export_json(str(p))
    doc = json.loads(p.read_text())
    assert doc["attributions"] == prof.attributions
    assert set(doc["programs"]) == set(map(str, prof.programs))
    table = prof.summary_table()
    assert "delta" in table and "consistency" in table


def test_profiler_empty_run_is_inert():
    prof = Profiler()
    assert prof.finish_run(1.0) is None
    assert prof.attributions == []
    assert prof.summary_table() == "(no profiled runs)"


# ---------------------------------------------------------------------------
# the report (tests/test_profile.py:285-325), and against the reference's
# ---------------------------------------------------------------------------

def _attr(scheme, *, consistency=0.01, coll=520.0, eff=1e-7, wall=0.5):
    n_windows = 40
    return {
        "kind": "attribution", "scheme": scheme, "transport": "xla",
        "m": 8, "n": 2000, "d": 8, "kappa": 16, "tau": 50,
        "wall_s": wall, "commlog_logical_bytes_per_window": coll,
        "attribution": {
            "scheme": scheme, "transport": "xla", "n_windows": n_windows,
            "wall_s": wall, "window_wall_s": wall / n_windows,
            "t_compute_s": 1e-8, "t_memory_s": 1e-7,
            "t_collective_s": 1e-8, "t_host_s": wall / n_windows,
            "consistency": consistency,
            "collective_bytes_per_window": coll,
            "efficiency": {"compute": eff, "memory": 1e-6,
                           "collective": 1e-7, "host": 0.99},
        },
    }


def _doc(*records):
    return {"suite": "profile", "devices": 8, "backend": "cpu",
            "results": list(records)}


def test_report_renders_self_contained_html(tmp_path):
    (tmp_path / "BENCH_profile.json").write_text(
        json.dumps(_doc(_attr("delta"), _attr("average"))))
    (tmp_path / "BENCH_engine.json").write_text(json.dumps({
        "suite": "engine", "devices": 8, "backend": "cpu",
        "results": [{"executor": "mesh", "m": 8, "wall_s": 1.25,
                     "curve": [0.5, 0.4, 0.3]}]}))
    (tmp_path / "BENCH_engine.fresh.json").write_text("{ not json")
    out = tmp_path / "perf_report.html"
    assert report.main(["--dir", str(tmp_path), "--out", str(out)]) == 0
    text = out.read_text()
    for needle in ("http://", "https://", "<script", "<link", "@import"):
        assert needle not in text, needle
    assert "Roofline attribution" in text
    assert "engine" in text and "delta" in text
    assert "<svg" in text and "polyline" in text


def test_report_includes_profiler_exports(tmp_path):
    prof_doc = {"attributions": [_attr("delta")["attribution"]],
                "programs": {}}
    p = tmp_path / "prof.json"
    p.write_text(json.dumps(prof_doc))
    out = tmp_path / "r.html"
    assert report.main(["--dir", str(tmp_path), "--out", str(out),
                        "--profile", str(p)]) == 0
    text = out.read_text()
    assert "prof.json" in text and "Roofline attribution" in text


def test_report_empty_dir_still_writes(tmp_path):
    out = tmp_path / "r.html"
    assert report.main(["--dir", str(tmp_path), "--out", str(out)]) == 0
    assert "<html" in out.read_text()


def test_report_default_out_is_the_current_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert report.main(["--dir", str(tmp_path)]) == 0
    assert (tmp_path / "perf_report.html").exists()


def test_report_html_equals_the_references_bytewise(tmp_path):
    """The repo's BENCH_*.json plus one port profile export, rendered by
    both packages: the same page."""
    prof, _, _ = _port_run("delta")
    export = tmp_path / "prof.json"
    prof.export_json(str(export))
    docs = report.load_bench_dir(str(REPO))
    assert docs == jreport.load_bench_dir(str(REPO))
    assert {"comm", "hier", "adapt", "profile"} <= set(docs)
    runs = [("prof.json", json.loads(export.read_text())["attributions"])]
    got = report.render_report(docs, title="t", profile_runs=runs)
    want = jreport.render_report(docs, title="t", profile_runs=runs)
    assert got == want
    outs = []
    for mod, name in ((report, "port.html"), (jreport, "ref.html")):
        assert mod.main(["--dir", str(REPO), "--out", str(tmp_path / name),
                         "--profile", str(export)]) == 0
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1]
    assert b"Roofline attribution" in outs[0]
    for series in ([0.5, 0.25, 0.125], [1, 2]):
        assert report.sparkline(series) == jreport.sparkline(series)
    shares = {"compute": 0.1, "memory": 0.2, "collective": 0.05,
              "host": 0.65}
    assert report._stacked_bar(shares) == jreport._stacked_bar(shares)
