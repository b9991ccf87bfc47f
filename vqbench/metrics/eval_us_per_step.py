"""``eval_us_per_step``: the ``eval`` phase of ``engine/mesh.py``'s step, in
microseconds a window or tick of the traced job: eq. 2 of the shared
codebook through the transport, on the windows or ticks that score it.

The program's own marks on the device's clock, from the phase's start to
the next phase's (``vqbench/phases.py``), over the steps it timed."""

from vqbench import phases

COUNTERS = phases.counters("eval")


def read(ctx):
    return phases.us_per_step(ctx, "eval")
