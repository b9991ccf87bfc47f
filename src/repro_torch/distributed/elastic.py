"""Elastic-training helpers, counterpart of ``repro/distributed/elastic.py``.

Only ``staleness_scale`` is ported so far: the quorum and dynamic merges
damp a late or skipped delta by it.  The rest of the module (resharding,
``merge_weights``) comes with the elastic executor (ROADMAP queue 1,
item 5)."""

from __future__ import annotations


def staleness_scale(delay_windows: int, *, gamma: float = 0.5) -> float:
    """Weight for a late worker's delta: 1 / (1 + delay)^gamma.

    delay=0 (on time) gives 1.0: the paper's eq. (9) applies deltas at full
    weight one round late; heavier staleness is damped as in asynchronous
    SGD practice."""
    return float(1.0 / (1.0 + delay_windows) ** gamma)
