"""``merge_us_per_step``: the ``merge`` phase of ``engine/mesh.py``'s step,
in microseconds a window or tick of the traced job: the merge through the
transport (eq. 8's sum, eq. 3's mean; the dynamic probe and the quorum's
late bits where they run), or eq. 9's masked merge and its where-updates.

The program's own marks on the device's clock, from the phase's start to
the next phase's (``vqbench/phases.py``), over the steps it timed."""

from vqbench import phases

COUNTERS = phases.counters("merge")


def read(ctx):
    return phases.us_per_step(ctx, "merge")
