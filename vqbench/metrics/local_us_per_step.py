"""``local_us_per_step``: the ``local`` phase of ``engine/mesh.py``'s step,
in microseconds a window or tick of the traced job: the window kernel (eq. 3
and eq. 8), or eq. 9's step at batch 1 and its eager epilogue (``eps * H``,
``w - step``, ``dcur + step``).

The program's own marks on the device's clock, from the phase's start to
the next phase's (``vqbench/phases.py``), over the steps it timed."""

from vqbench import phases

COUNTERS = phases.counters("local")


def read(ctx):
    return phases.us_per_step(ctx, "local")
