"""The benchmark harness on the CPU: what it imports, that its manifest keeps
to its contract, its operation and byte counts against the kernel table,
its trace reduction, and whole runs at tiny sizes, sound and with each
planted fault (``vqbench/faults.py``), where ``correct`` must come out
true and false."""

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "vqbench"
sys.path.insert(0, str(REPO))

from vqbench import faults, harness, trace_reader, yardstick  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TINY = dict(kappa=16, d=8, points_per_worker=400, job_points=200, n_eval=40)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.fixture(autouse=True)
def _one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


@pytest.fixture
def manifest():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=[str(p.relative_to(REPO)) for p in BENCH_FILES])
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy\nfrom repro.core import vq\n"
                   "import repro_torch\nfrom jaxlib import x\nimport flax\n")
    assert [n for n in _imports(src) if n.split(".")[0] in FORBIDDEN] == [
        "jax.numpy", "repro.core", "jaxlib", "flax"]


def test_the_reference_imports_torch_alone():
    for path in (BENCH / "reference").glob("*.py"):
        assert {n.split(".")[0] for n in _imports(path)} <= {
            "__future__", "torch"}, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run at a tiny size in a fresh process, every per-layer reader
    loaded: the process's modules hold no JAX and no ``repro``."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from vqbench import harness\n"
        "r = harness.run_cell('dbpedia3072.async_delta', seed=1, seconds=0.1, "
        "trace=True, device='cpu', sizes=%r)\n"
        "for n in ('step_mfu', 'launches_per_step', 'device_idle_share', "
        "'window_kernel_roofline', 'blocked_kernel_roofline'):\n"
        "    harness.read_metric(n, harness.TraceContext(None, "
        "harness.trace_reader.Trace(0, 1, [], []), 1, 1, {}))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (str(REPO), TINY))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "vqbench" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_run_exits_two_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "vqbench/run.py", "--workload", "sift1m.sync_delta",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_manifest_keeps_to_the_contract(manifest):
    assert manifest["command"] == ["python3", "vqbench/run.py"]
    assert manifest["paths"] == ["vqbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("vqbench/")
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    names = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for cell in m.get("workloads", names):
            assert cell in names
            assert cell in e2e[m["moves"]].get("workloads", names)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest)
        assert cell.per_layer, w["name"]
        assert len(cell.end_to_end) >= 2
        assert cell.plan.shards >= 1


def test_cell_files_carry_a_job_and_both_limits(manifest):
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest)
        assert set(cell.cell["limits"]) == {"eval_gap", "curve_gap",
                                            "rows_apart", "codebook_gap"}
        plan = cell.plan
        assert plan.m * plan.points_per_worker >= plan.kappa
        assert plan.points_per_worker % plan.job_points == 0


@pytest.mark.parametrize("fn, args, want_ms", [
    (yardstick.window_bound_s, (8, 10, 4096, 128), 0.0056),
    (yardstick.delta_bound_s, (8, 1, 4096, 3072), 0.2405),
    (yardstick.delta_bound_s, (8, 1, 4096, 128), 0.0101),
    (yardstick.window_bound_s, (1, 10, 4096, 128), 0.0013),
])
def test_bounds_reproduce_the_kernel_table(fn, args, want_ms):
    assert round(fn(*args) * 1e3, 4) == want_ms


def test_job_flops_count_the_eval_and_the_steps():
    # a SIFT1M-shaped window: the eval's 8 x 1,000 x 4,096 distances at
    # 2d + 3 operations, the window's 80 steps, the merge
    per_window = yardstick.sync_window_flops(8, 10, 4096, 128, 1000)
    assert per_window == (8 * 1000 * 4096 * 259 + 10 * 8 * 4096 * 259
                          + 10 * 8 * 3 * 128 + 17 * 4096 * 128)
    assert yardstick.job_flops("window", m=8, kappa=4096, d=128, tau=10,
                               points=12500, n_eval=1000,
                               eval_every=1) == 1250 * per_window
    tick = yardstick.async_tick_flops(8, 4096, 3072)
    assert yardstick.job_flops("tick", m=8, kappa=4096, d=3072,
                               tau=10, points=625, n_eval=625,
                               eval_every=10) == (
        625 * tick + 62 * yardstick.eval_flops(8, 625, 4096, 3072))


def _write_trace(path: Path, events: list) -> None:
    path.write_text(json.dumps({"traceEvents": events}))


def test_trace_reader_unions_device_time_and_names_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "vqbench.traced",
         "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void ns::window_resident_kernel"
         "<8>(float const*)", "ts": 110.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel"
         "<4>(float*)", "ts": 120.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 160.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 10.0,
         "dur": 5.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "vqbench.traced",
         "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 170.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 140.0,
         "dur": 25.0},
    ]
    path = tmp_path / "t.json"
    _write_trace(path, ev)
    tr = trace_reader.read(path)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)
    assert len(tr.device) == 3
    assert [n for n, _, _ in tr.kernels("window_(resident|stream)_kernel")
            ] == ["void ns::window_resident_kernel<8>(float const*)"]
    gaps = dict((k, v) for k, v in tr.top_idle_gaps())
    assert gaps["python"] == pytest.approx(10e-6)
    assert gaps["aten::sum"] == pytest.approx(20e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    ops = dict((k, v) for k, v in tr.top_device_ops())
    assert ops["ns::window_resident_kernel"] == pytest.approx(20e-6)
    assert ops["at::native::reduce_kernel"] == pytest.approx(20e-6)


def test_readers_return_nothing_where_nothing_ran():
    ctx = harness.TraceContext(
        plan=harness.load_cell("sift1m.sync_delta").plan,
        trace=trace_reader.Trace(0.0, 100.0, [], []), jobs=1, steps=1,
        counts={"window": 0, "delta": 0, "blocked": 0})
    for m in ("step_mfu", "launches_per_step", "device_idle_share",
              "window_kernel_roofline", "blocked_kernel_roofline"):
        assert harness.read_metric(m, ctx) is None


def test_roofline_readers_take_their_route_from_the_counters():
    plan = harness.load_cell("dbpedia3072.async_delta").plan
    bound_us = yardstick.delta_bound_s(8, 1, 4096, 3072) * 1e6
    dev = [("void vq::sweep_kernel<1>(float const*)", "kernel",
            10.0 * i, 2 * bound_us) for i in range(5)]
    tr = trace_reader.Trace(0.0, 100.0, dev, [])
    as_delta = harness.TraceContext(plan, tr, 1, 5, {"delta": 5,
                                                     "blocked": 0})
    as_blocked = harness.TraceContext(plan, tr, 1, 5, {"delta": 0,
                                                       "blocked": 5})
    assert harness.read_metric("blocked_kernel_roofline", as_delta) is None
    assert harness.read_metric("blocked_kernel_roofline", as_blocked) == (
        pytest.approx(50.0))
    assert harness.read_metric("launches_per_step", as_delta) == 1.0


@pytest.mark.parametrize("cell", ["sift1m.sync_delta",
                                  "dbpedia3072.async_delta"])
def test_a_sound_run_is_correct(cell):
    r = harness.run_cell(cell, seed=2**31 + 9, seconds=0.2, trace=False,
                         device="cpu", sizes=TINY)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert 1 <= len(r["checked_jobs"]) <= min(3, r["attempted"])
    assert r["checked_jobs"] == sorted(set(r["checked_jobs"]))
    assert set(r["setup_parts"]) == {"imports_s", "device_s", "program_s",
                                     "inputs_s", "warm_up_s"}
    assert len(r["host_probe_ms"]) == 2
    assert set(r["metrics"]) == {"train_points_per_s", "peak_mem_gib",
                                 "setup_s"}
    assert all(math.isfinite(m["value"]) for m in r["metrics"].values())


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", ["sift1m.sync_delta",
                                  "dbpedia3072.async_delta"])
def test_each_planted_fault_makes_the_run_incorrect(cell, fault,
                                                   monkeypatch):
    build = harness.Bench.build_executor

    def broken(bench):
        executor = build(bench)
        faults.plant(executor, fault)
        return executor

    monkeypatch.setattr(harness.Bench, "build_executor", broken)
    r = harness.run_cell(cell, seed=2**31 + 9, seconds=0.2, trace=False,
                         device="cpu", sizes=TINY)
    assert r["correct"] is False, r["checks"]
    assert harness.checks_lines(r)


def test_a_traced_run_reports_per_layer_metrics_only():
    r = harness.run_cell("sift1m.sync_delta", seed=3, seconds=0.1,
                         trace=True, device="cpu", sizes=TINY)
    assert r["correct"] and r["attempted"] >= 2
    assert not set(r["metrics"]) & {"train_points_per_s", "setup_s"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0.0


@pytest.mark.parametrize("traffic", sorted(
    p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_a_mix_s_launcher_flags_and_reference_come_from_its_file(traffic):
    """The launcher gets the mix's own flags as given, and the reference is
    the function the mix names."""
    from vqbench import check, generator
    cfg = json.loads((BENCH / "configs" / "sift1m-ivf4096.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    plan = generator.make_plan(cfg, mix, {"job_points": 1000})
    argv = harness.launcher_argv(plan, 7, torch.device("cpu"))
    assert argv[len(argv) - len(mix["flags"]):] == mix["flags"]
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.launch import train
    args = train.parse_args(argv)
    assert args.scheme == mix["scheme"] and args.workers == plan.m
    module, _, fn = mix["reference"].rpartition(".")
    assert check.reference_function(mix["reference"]).__name__ == fn
    assert (BENCH / "reference" / f"{module}.py").is_file()


def test_a_new_scheme_needs_no_edit_of_the_generator():
    from vqbench import generator
    cfg = json.loads((BENCH / "configs" / "sift1m-ivf4096.json").read_text())
    mix = {"scheme": "average", "flags": ["--transport", "ring"],
           "reference": "vq_average.run", "step": "window",
           "round_lengths": None, "n_eval": 1000, "eval_every": 1}
    plan = generator.make_plan(cfg, mix, {"job_points": 1000})
    assert plan.scheme == "average" and plan.steps == 100
    assert harness.launcher_argv(plan, 1, torch.device("cpu"))[-2:] == [
        "--transport", "ring"]
    with pytest.raises(ValueError):
        generator.make_plan(cfg, {**mix, "step": "round"},
                            {"job_points": 1000})


@pytest.mark.parametrize("metric, want", [
    ("blocked_kernel_roofline", {"blocked", "delta"}),
    ("step_mfu", set()),
    ("window_kernel_roofline", set()),
])
def test_counters_are_those_the_metric_files_declare(metric, want):
    spec = harness.metric_counters([metric])
    assert set(spec) == want
    sys.path.insert(0, str(REPO / "src"))
    values = harness.read_counters(spec)
    assert set(values) == want
    assert all(isinstance(v, int) and v >= 0 for v in values.values())


@pytest.mark.parametrize("values, want", [
    ([0.0, 0.6, 0.0], {"largest": 0.6, "mean": 0.2}),
    ([0.2], {"largest": 0.2, "mean": 0.2}),
    ([0.1, 0.3], {"largest": 0.3, "mean": 0.2}),
])
def test_combine_takes_the_largest_and_the_mean(values, want):
    from vqbench import check
    per_job = [{k: v for k in check.OVER_JOBS} for v in values]
    out = check.combine(per_job)
    assert out["eval_gap"] == out["curve_gap"] == want["largest"]
    assert out["rows_apart"] == pytest.approx(want["mean"])
    assert out["codebook_gap"] == pytest.approx(want["mean"])
