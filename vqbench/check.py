"""The comparison that decides ``correct``: jobs the window ran, against the
plain reference run on the same inputs.  The reference is the function the
traffic mix names (``"vq_plain.run_sync"``: ``reference/vq_plain.py``'s
``run_sync``), called with the arguments every scheme's function takes.

Four numbers a job, each against the cell's limit (``cells/<cell>.json``):

  * ``eval_gap``: the program's last eq.-2 eval (the job's last curve
    point, scored on its final shared codebook) against the reference's
    eq. 2 of that same codebook, ``|C_prog - C_ref(W_prog)| / C_ref``: the
    eval alone, whatever path the codebook took;
  * ``curve_gap``: the median over the curve of ``|C_prog(t) - C_ref(t)| /
    C_ref(t)``, the program's eval curve against the reference's own run;
  * ``rows_apart``: the share of the prototypes the reference moved from
    the shared start whose final rows lie apart from the reference's by
    more than a thousandth of that move;
  * ``codebook_gap``: ``||W_prog - W_ref||_F / ||W_ref - W0||_F``, the
    final shared codebook's distance from the reference's over how far the
    reference moved it.

The last three judge the local steps' route (the window, delta or blocked
kernel) and the merge (eq. 8, or eq. 9's masked merge) together.  The
program's kernels and the reference round a squared distance differently,
so at a near tie they may pick different winners (both right to f32's
rounding), and an early one moves the rest of the run: most jobs then
read exactly 0, and a few read a cascade from one such tie.  A step in
TF32 widens the ties a thousandfold, and nearly every job reads such
cascades (PERF.md, section 6).

A run checks several jobs (``checked_jobs`` of the cell file, a seeded
sample of the window's), and judges, of each number, what ``OVER_JOBS``
names: ``eval_gap`` and ``curve_gap`` by the largest over the jobs, so
that every job is held to the limit; ``rows_apart`` and ``codebook_gap``,
whose sound readings come from one job's rare cascade, by the mean over
the jobs, which one cascade does not decide and a lower precision or a
fault, which reads in every job, does.  ``compare`` also returns
``curve_gap_max``, the widest gap of the curve, for the readings; it is
not judged.  A number that is not finite fails.
"""

from __future__ import annotations

import importlib
import math
import sys

import torch

from vqbench.generator import Plan, job_inputs
from vqbench.reference import vq_plain

NUMBERS = ("eval_gap", "curve_gap", "rows_apart", "codebook_gap")
WIDEST = ("curve_gap_max",)
#: How a run's checked jobs combine into the number judged.
OVER_JOBS = {"eval_gap": "max", "curve_gap": "max", "rows_apart": "mean",
             "codebook_gap": "mean", "curve_gap_max": "max"}


def reference_function(name: str):
    """The reference function ``"<module>.<function>"`` of
    ``vqbench/reference/``."""
    module, _, function = name.rpartition(".")
    return getattr(importlib.import_module(f"vqbench.reference.{module}"),
                   function)


def reference(plan: Plan, inputs, job: int, precision: str = "f32"):
    """The reference's (codebook (K, d), curve) for job ``job``."""
    w0, data, eval_data, lengths = job_inputs(plan, inputs, job)
    run = reference_function(plan.reference)
    return run(w0.contiguous(), data.contiguous(), eval_data.contiguous(),
               lengths=lengths, tau=plan.tau, eps0=plan.eps0,
               decay=plan.decay, eval_every=plan.eval_every,
               precision=precision)


def compare(plan: Plan, inputs, job: int, out, ref) -> dict:
    """The numbers compared for a job's output ``(codebook, curve)`` against
    the reference's ``ref``, and the widest forms beside them."""
    w0, _, eval_data, _ = job_inputs(plan, inputs, job)
    w, curve = out
    w_ref, c_ref = (x.double() for x in ref)
    if (curve.shape != c_ref.shape or w.shape != w_ref.shape
            or curve.numel() == 0):
        return {k: math.inf for k in NUMBERS + WIDEST}
    c_own = vq_plain.distortion(eval_data.contiguous(), w.contiguous())
    eval_gap = torch.abs(curve[-1].double() - c_own.double()) / c_own.double()
    curve = curve.double()
    rel = torch.abs(curve - c_ref) / c_ref
    w, w0 = w.double(), w0.double()
    rows = torch.linalg.vector_norm(w - w_ref, dim=-1)
    moved = torch.linalg.vector_norm(w_ref - w0, dim=-1)
    live = moved > 0
    numbers = {
        "eval_gap": float(eval_gap),
        "curve_gap": float(torch.median(rel)),
        "rows_apart": float(torch.mean(
            (rows[live] > 1e-3 * moved[live]).double())),
        "codebook_gap": float(torch.linalg.vector_norm(rows)
                              / torch.linalg.vector_norm(moved)),
        "curve_gap_max": float(torch.max(rel))}
    return {k: (v if math.isfinite(v) else math.inf)
            for k, v in numbers.items()}


def combine(per_job: list) -> dict:
    """The numbers judged for a run from each checked job's numbers: of each,
    the largest over the jobs or their mean (``OVER_JOBS``)."""
    out = {}
    for k, how in OVER_JOBS.items():
        values = [n.get(k, math.inf) for n in per_job]
        if not values:
            out[k] = math.inf
        elif how == "max":
            out[k] = max(values)
        else:
            out[k] = sum(values) / len(values)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN or a missing number
    fails)."""
    return all(numbers.get(k, math.inf) <= limits[k] for k in NUMBERS)


def report(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` in NUMBERS' order; a number
    that is not finite is written as the largest float, so the line stays
    JSON."""
    def finite(v):
        return v if math.isfinite(v) else sys.float_info.max

    return {k: {"value": finite(numbers.get(k, math.inf)),
                "limit": limits[k]} for k in NUMBERS}
