"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` a run.

A cell names a configuration (``configs/<config>.json``), a traffic mix
(``traffic/<traffic>.json``: the scheme, its own launcher flags, the
reference function that judges it, what a step is, the evals and the
round lengths) and its own file (``cells/<cell>.json``: the job length,
the jobs checked and the correctness limits); ``generator.make_plan``
turns the three into the shapes and the job, and each per-layer metric is
read by ``metrics/<metric>.py``, which names the program's counters it
reads (``COUNTERS``).  Adding a cell, a mix or a metric adds files and
entries; no file here names one.

A run:

  1. set-up (``setup_s``, from the process's start): the launcher's own
     ``parse_args`` and ``build_executor`` build the ``MeshExecutor`` the
     cell's flags name (the configuration's sizes, ``--autotune cache``,
     and the mix's flags as given), the inputs are drawn on the card from
     the seed, and one short job on the cell's shapes builds or loads the
     kernels and warms cuBLAS; the parts' times go into the result line
     (``setup_parts``);
  2. the window: ``MeshExecutor.run`` job after job in a closed loop, one
     job outstanding, no new job after ``--seconds``; ``train_points_per_s``
     is every point every worker stepped over the window's wall time, and
     ``peak_mem_gib`` the allocator's peak over the window less the
     benchmark's own inputs and the job outputs it keeps for the check; a
     fixed piece of host work timed before and after the window
     (``host_probe_ms``) shows whether the host ran slow;
  3. with ``--trace 1``, the window's second job runs under
     ``torch.profiler`` and the per-layer metrics are read from its trace;
  4. after the window: no module of JAX or of the JAX package may be loaded;
     the jobs kept (a seeded reservoir sample of ``checked_jobs`` of the
     window's jobs) are run again by the plain reference and compared
     (``check``).

The last line of standard output is the result, and the numbers compared
close standard error and the result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import random
import sys
import tempfile
import time
from pathlib import Path

import torch

from vqbench import check, generator, trace_reader

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Jobs a run checks where the cell file names no ``checked_jobs``.
CHECKED_JOBS = 3
#: The window's job that a traced run profiles (its first is the second
#: job, after the window's first has settled the allocator).
TRACED_JOB = 1
GIB = float(1 << 30)


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list
    per_layer: list

    @property
    def plan(self) -> generator.Plan:
        return generator.make_plan(self.config, self.traffic, self.cell)


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest and the files it names."""
    manifest = load_manifest() if manifest is None else manifest
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        names = [w["name"] for w in manifest["workloads"]]
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {names}")
    w = found[0]
    cfg = [c for c in manifest["configs"] if c["name"] == w["config"]][0]
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "cells" / f"{name}.json") as f:
        cell = json.load(f)
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, cell=cell, end_to_end=e2e,
                per_layer=per_layer)


def launcher_argv(plan: generator.Plan, seed: int, device: torch.device
                  ) -> list:
    """The launcher flags of the cell (``python -m repro_torch.launch.train
    <flags>`` runs the same executor over one job): the configuration's
    sizes, then the traffic mix's own flags as given."""
    return ["--mode", "vq", "--executor", "mesh",
            "--scheme", plan.scheme, "--workers", str(plan.m),
            "--points", str(plan.job_points), "--dim", str(plan.d),
            "--kappa", str(plan.kappa), "--tau", str(plan.tau),
            "--eps0", str(plan.eps0), "--autotune", "cache",
            "--seed", str(seed), "--device", device.type, *plan.flags]


def _import_program():
    """The program under test, from this checkout's ``src``."""
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.kernels import autotune
    from repro_torch.launch import train
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise ImportError(f"repro_torch comes from {where}, not {src}")
    return train, autotune


def read_counters(spec: dict) -> dict:
    """``{name: value}`` of the program's counters ``{name:
    "<module>.<attribute>"}`` (the metric files' ``COUNTERS``)."""
    out = {}
    for name, where in spec.items():
        module, _, attr = where.rpartition(".")
        out[name] = int(getattr(importlib.import_module(module), attr))
    return out


class Bench:
    """The set-up of one cell: the executor the launcher builds for the
    cell's flags, and the inputs drawn from the seed."""

    def __init__(self, plan: generator.Plan, seed: int,
                 device: torch.device, parts: dict | None = None):
        self.plan, self.seed, self.device = plan, seed, device
        parts = {} if parts is None else parts
        t = time.perf_counter()
        train, autotune = _import_program()
        self._train = train
        self.args = train.parse_args(launcher_argv(plan, seed, device))
        autotune.set_mode(self.args.autotune)
        self.executor = self.build_executor()
        _sync(device)
        parts["program_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.inputs = generator.make_inputs(plan, seed, device)
        _sync(device)
        parts["inputs_s"] = time.perf_counter() - t

    def build_executor(self):
        executor = self._train.build_executor(self.args, self.device)
        if (self.plan.step == "tick"
                and executor.eval_every != self.plan.eval_every):
            raise ValueError(
                f"the traffic mix scores every {self.plan.eval_every} ticks, "
                f"the launcher's executor every {executor.eval_every}")
        return executor

    def run_job(self, job: int, *, points: int | None = None):
        """Job ``job`` through ``MeshExecutor.run``: (codebook, curve)."""
        plan = self.plan
        w0, data, eval_data, lengths = generator.job_inputs(
            plan, self.inputs, job, points=points)
        res = self.executor.run(
            plan.scheme, w0, data, eval_data, tau=plan.tau, eps0=plan.eps0,
            decay=plan.decay, lengths=lengths)
        return res.w_shared, res.distortion

    def warm_up(self) -> None:
        """One short job on the cell's shapes: the kernels built or loaded,
        every shape of a job launched once."""
        short = 2 * (self.plan.eval_every if self.plan.step == "tick"
                     else self.plan.tau)
        self.run_job(0, points=min(short, self.plan.job_points))
        _sync(self.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_probe_ms() -> float:
    """Milliseconds of a fixed piece of host work (pure Python, one
    thread): it reads longer where the host runs the process slow."""
    t = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i * i % 7
    return (time.perf_counter() - t) * 1e3


@dataclasses.dataclass
class Window:
    jobs: int
    wall_s: float
    failed: int
    samples: list            # [(job index, (codebook, curve))], by index
    peak_bytes: int          # the allocator's peak over the window
    ends: list               # each job's end, seconds into the window
    trace: object = None     # trace_reader.Trace of the traced job
    counts: dict | None = None


def measure(bench: Bench, seconds: float, *, trace: bool, keep: int,
            counters: dict | None = None) -> Window:
    """The closed-loop window; with ``trace`` the job ``TRACED_JOB`` runs
    under the profiler (and the window lasts until it has run), with the
    program's ``counters`` read around it.  ``keep`` jobs' outputs are
    kept for the check, a seeded reservoir sample of the window's."""
    dev = bench.device
    pick = random.Random(f"vqbench-sample-{bench.seed}")
    lasts, ends, samples, traced, counts = [], [], [], None, None
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    jobs = 0
    while (jobs == 0 or time.perf_counter() - t0 < seconds
           or (trace and jobs <= TRACED_JOB)):
        if trace and jobs == TRACED_JOB:
            before = read_counters(counters or {})
            out, traced = _profiled(bench, jobs)
            after = read_counters(counters or {})
            counts = {k: after[k] - before[k] for k in after}
        else:
            out = bench.run_job(jobs)
        lasts.append(out[1][-1])
        ends.append(time.perf_counter() - t0)
        if len(samples) < keep:
            samples.append((jobs, out))
        else:
            slot = pick.randrange(jobs + 1)
            if slot < keep:
                samples[slot] = (jobs, out)
        del out
        jobs += 1
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(lasts))).sum())
    return Window(jobs=jobs, wall_s=wall, failed=failed,
                  samples=sorted(samples, key=lambda s: s[0]),
                  peak_bytes=peak, ends=ends, trace=traced, counts=counts)


def _profiled(bench: Bench, job: int):
    """Job ``job`` under ``torch.profiler``; returns its output and the
    reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if bench.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace_reader.WINDOW_SPAN):
            out = bench.run_job(job)
    with tempfile.TemporaryDirectory(prefix="vqbench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return out, trace_reader.read(path)


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader gets: the cell's plan, the traced
    window (``trace_reader.Trace``), the jobs and steps it holds, and the
    program's launch counters over it."""

    plan: generator.Plan
    trace: trace_reader.Trace
    jobs: int
    steps: int
    counts: dict


def load_metric(name: str):
    """The reader ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vqbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(name: str, ctx: TraceContext):
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where it
    finds nothing to read."""
    return load_metric(name).read(ctx)


def metric_counters(names) -> dict:
    """The program's counters that the readers ``names`` declare
    (``COUNTERS = {name: "<module>.<attribute>"}``); a name means one
    counter throughout."""
    spec = {}
    for name in names:
        for k, where in getattr(load_metric(name), "COUNTERS", {}).items():
            if spec.setdefault(k, where) != where:
                raise ValueError(f"counter {k!r} is {spec[k]!r} and "
                                 f"{where!r}")
    return spec


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             sizes: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object, or raises.
    ``sizes`` shrinks the plan (the CPU tests); the benchmark's own runs
    pass none."""
    t_start = time.perf_counter() if t_start is None else t_start
    parts = {"imports_s": time.perf_counter() - t_start}
    cell = load_cell(name)
    plan = cell.plan if not sizes else generator.shrink(cell.plan, **sizes)
    keep = int(cell.cell.get("checked_jobs", CHECKED_JOBS))
    dev = torch.device(device)
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.zeros(1, device=dev)
        _sync(dev)
    parts["device_s"] = time.perf_counter() - t
    bench = Bench(plan, seed, dev, parts)
    t = time.perf_counter()
    bench.warm_up()
    parts["warm_up_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    counters = metric_counters(m["name"] for m in cell.per_layer)
    probe = [host_probe_ms()]
    win = measure(bench, seconds, trace=trace, keep=keep, counters=counters)
    probe.append(host_probe_ms())
    held = sum(x.numel() * x.element_size()
               for _, out in win.samples for x in out)
    own = bench.inputs.nbytes() + held
    metrics = {}
    if not trace:
        values = {
            "train_points_per_s": win.jobs * plan.points_per_job / win.wall_s,
            "peak_mem_gib": (win.peak_bytes - own) / GIB,
            "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    breakdown = None
    device_info = _device_info(dev, max(setup_peak, win.peak_bytes))
    if trace:
        ctx = TraceContext(plan=plan, trace=win.trace, jobs=1,
                           steps=plan.steps, counts=win.counts or {})
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s
        breakdown = {"device_ops": win.trace.top_device_ops(),
                     "idle_gaps": win.trace.top_idle_gaps()}
    # the program's state goes before the reference runs
    del bench.executor
    per_job = []
    for job, out in win.samples:
        ref = check.reference(plan, bench.inputs, job)
        per_job.append(check.compare(plan, bench.inputs, job, out, ref))
        del ref
    numbers = check.combine(per_job)
    limits = cell.cell["limits"]
    result = {"correct": check.judge(numbers, limits) and win.failed == 0,
              "attempted": win.jobs, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts"] = parts
    result["host_probe_ms"] = probe
    result["checked_jobs"] = [job for job, _ in win.samples]
    result["job_ends_s"] = win.ends
    result["checks"] = check.report(numbers, limits)
    return result


def _device_info(dev: torch.device, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def checks_lines(result: dict) -> list:
    """The numbers compared beside their limits, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def main(argv=None, *, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 vqbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("vqbench: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"vqbench: the cell needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"vqbench: JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    print("vqbench: the window's jobs ended at (s): "
          + " ".join(f"{t:.3f}" for t in result["job_ends_s"]),
          file=sys.stderr)
    print("vqbench: set-up parts (s): " + " ".join(
        f"{k} {v:.3f}" for k, v in result["setup_parts"].items())
        + "; host probe before and after the window (ms): " + " ".join(
        f"{v:.2f}" for v in result["host_probe_ms"]), file=sys.stderr)
    for line in checks_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

