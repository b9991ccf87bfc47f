"""The program's measured phases, read by ``metrics/local_us_per_step.py``,
``merge_us_per_step.py`` and ``eval_us_per_step.py``.

``repro_torch.engine.mesh`` counts, over every run it times (a run under
``torch.profiler`` is timed), each phase's nanoseconds on the device's
clock, ``phase_ns_local``, ``phase_ns_merge`` and ``phase_ns_eval``, and
the windows or ticks timed, ``phase_steps``.  A phase runs from its
opening mark to its closing one, so its time holds the device's idle time
inside it.  A program without these counters declares none here: the
traced run then reads nothing for the three metrics and leaves them out.
"""

from __future__ import annotations

import importlib

MODULE = "repro_torch.engine.mesh"
STEPS = "phase_steps"


def counters(phase: str) -> dict:
    """``COUNTERS`` of the metric of ``phase``: its phase counter and the
    steps, or nothing where the program lacks them."""
    name = f"phase_ns_{phase}"
    try:
        mesh = importlib.import_module(MODULE)
    except ImportError:
        return {}
    if not (hasattr(mesh, name) and hasattr(mesh, STEPS)):
        return {}
    return {name: f"{MODULE}.{name}", STEPS: f"{MODULE}.{STEPS}"}


def us_per_step(ctx, phase: str):
    """Microseconds of ``phase`` a step over the traced job, or None where
    no step was timed."""
    steps = ctx.counts.get(STEPS, 0)
    if steps <= 0:
        return None
    return ctx.counts[f"phase_ns_{phase}"] / 1e3 / steps
