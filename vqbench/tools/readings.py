"""The readings that the correctness limits are set from, at a cell's own
size on the card, in one process (set-up once, the inputs drawn again for
each seed).  Each seed's reading is what a run judges: ``checked_jobs``
jobs (the seed's shard ``seed mod shards`` and the next ones), each
compared with the plain reference, combined by ``check.combine``:

  * the program: the jobs through the cell's executor (the lower
    readings), with ``eval_err_f64``, the program's last eval against eq. 2
    of its own codebook in f64 (what an f32 eval rounds, the room an honest
    re-spelling of the eval needs);
  * the control: the reference with its products in TF32 (``vq_plain``'s
    ``precision="tf32"``, emulated, steps and eval) in the program's place,
    and ``"tf32_steps"``, TF32 in the steps alone, so that the step route's
    precision is read apart from the eval's; and the reference run with the
    card's TF32 on (``allow_tf32``: cuBLAS's eval product alone);
  * each planted fault of ``vqbench/faults.py``;
  * with ``--witness``, the reference with its argmins from the f32
    expansion, a second f32 spelling, against the reference.

    python3 vqbench/tools/readings.py --workload sift1m.sync_delta \
        --seeds 101-112 --control-seeds 3 --fault-seeds 3

Prints one JSON line a job and a reading (``judged``: what ``check.judge``
says of the combined numbers under the cell's limits) and a summary line:
the largest sound reading, the smallest control and fault reading of each
number, and how many seeds of each kind came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from vqbench import check, faults, generator, harness  # noqa: E402
from vqbench.reference import vq_plain  # noqa: E402


def _seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,200")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    plan = cell.plan
    limits = cell.cell["limits"]
    keep = int(cell.cell.get("checked_jobs", harness.CHECKED_JOBS))
    seeds = _seeds(args.seeds)
    bench = harness.Bench(plan, seeds[0], dev)
    bench.warm_up()
    sound = bench.executor
    rows = []

    def emit(kind, seed, per_job, seconds):
        for job, numbers in per_job:
            print(json.dumps({"kind": kind, "seed": seed, "job": job,
                              **numbers}), flush=True)
        numbers = check.combine([n for _, n in per_job])
        row = {"kind": kind, "seed": seed, **numbers,
               "judged": check.judge(numbers, limits),
               "s": round(seconds, 3)}
        if kind == "program":
            row["eval_err_f64"] = max(n["eval_err_f64"] for _, n in per_job)
        rows.append(row)
        print(json.dumps({"combined": True, **row}), flush=True)

    for n, seed in enumerate(seeds):
        if n:
            bench.inputs = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            bench.inputs = generator.make_inputs(plan, seed, dev)
        jobs = [(seed + i) % plan.shards for i in range(keep)]
        refs, per_job = {}, []
        t = time.perf_counter()
        for job in jobs:
            out = bench.run_job(job)
            refs[job] = check.reference(plan, bench.inputs, job)
            numbers = check.compare(plan, bench.inputs, job, out, refs[job])
            _, _, eval_data, _ = generator.job_inputs(plan, bench.inputs, job)
            exact = vq_plain.distortion(eval_data.double(), out[0].double())
            numbers["eval_err_f64"] = float(
                torch.abs(out[1][-1].double() - exact) / exact)
            per_job.append((job, numbers))
            del out
        emit("program", seed, per_job, time.perf_counter() - t)

        def against_ref(kind, precision, card_tf32=False):
            t = time.perf_counter()
            per = []
            for job in jobs:
                torch.backends.cuda.matmul.allow_tf32 = card_tf32
                alt = check.reference(plan, bench.inputs, job, precision)
                torch.backends.cuda.matmul.allow_tf32 = False
                per.append((job, check.compare(plan, bench.inputs, job, alt,
                                               refs[job])))
                del alt
            emit(kind, seed, per, time.perf_counter() - t)

        if args.witness:
            against_ref("witness_f32_expansion", "f32_expansion")
        if n < args.control_seeds:
            against_ref("control_tf32", "tf32")
            against_ref("control_tf32_steps", "tf32_steps")
            if dev.type == "cuda":
                against_ref("card_tf32_eval", "f32", card_tf32=True)
        if n < args.fault_seeds:
            for name in faults.FAULTS:
                bench.executor = bench.build_executor()
                faults.plant(bench.executor, name)
                t = time.perf_counter()
                per = []
                for job in jobs:
                    out = bench.run_job(job)
                    per.append((job, check.compare(plan, bench.inputs, job,
                                                   out, refs[job])))
                    del out
                emit(f"fault_{name}", seed, per, time.perf_counter() - t)
            bench.executor = sound
        del refs
    summary = {"workload": args.workload, "limits": limits,
               "checked_jobs": keep}
    for kind in sorted({r["kind"] for r in rows}):
        of = [r for r in rows if r["kind"] == kind]
        sound_kind = kind in ("program", "witness_f32_expansion")
        pick = max if sound_kind else min
        keys = check.NUMBERS + check.WIDEST + (
            ("eval_err_f64",) if kind == "program" else ())
        summary[kind] = {k: pick(r[k] for r in of) for k in keys}
        summary[kind]["seeds"] = len(of)
        summary[kind]["correct"] = sum(r["judged"] for r in of)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
