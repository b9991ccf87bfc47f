"""Elastic-training helpers, counterpart of ``repro/distributed/elastic.py``.

  * ``plan_remesh``: given the surviving worker count, the largest valid
    (data, model) grid, biased to keep the model (tensor-parallel) axis
    intact: changing its width invalidates head shardings, while shrinking
    the data axis only re-spreads shards.  The elastic executor's workers
    form a 1-D grid (model = 1).
  * ``staleness_scale``: the damping of a late delta.
  * ``merge_late_delta``: the paper's rule for integrating a late worker's
    delta, eq. 8 applied to its stale window, scaled by staleness.

  * ``build_groups``: the process groups of a plan's (data, model) grid
    over the world's first ranks, the counterpart of ``build_mesh``.
  * ``build_count_groups``: the groups of every worker count an elastic
    run over processes visits, built up front on every rank: each count's
    worker grid over ranks 0 .. m - 1 and a group spanning them (the late
    deltas' gather, a grow's broadcast).  ``torch.distributed.new_group``
    is collective over the whole world, so a rank outside a count's grid
    still makes its groups, in the same order as every other rank; the
    counts come from the resize schedule and the chaos kills, which every
    rank knows before the run, so no control message is needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    dropped_hosts: int
    tp_preserved: bool


def plan_remesh(n_devices: int, *, prev_data: int, prev_model: int
                ) -> RemeshPlan:
    """Largest (data, model) grid over the survivors, keeping ``model``
    where ``n_devices`` allows it, else the largest power of two that
    fits."""
    del prev_data
    if n_devices >= prev_model and prev_model > 0:
        data = n_devices // prev_model
        return RemeshPlan(data=data, model=prev_model,
                          dropped_hosts=n_devices - data * prev_model,
                          tp_preserved=True)
    model = 1
    while model * 2 <= n_devices:
        model *= 2
    data = n_devices // model
    return RemeshPlan(data=data, model=model,
                      dropped_hosts=n_devices - data * model,
                      tp_preserved=False)


def build_groups(plan: RemeshPlan):
    """This rank's (data, model) groups of ``plan``'s grid over ranks 0 ..
    data * model - 1 (``topology.Groups``); every rank of the world calls
    it, and the ranks past the grid get none."""
    from repro_torch.topology import Topology, grid_groups
    grid, axes = Topology.flat(plan.data * plan.model).rank_grid(
        model=plan.model)
    return grid_groups(grid, axes)


@dataclasses.dataclass(frozen=True)
class CountGroups:
    """One worker count's groups over the world's first ``m`` ranks."""

    #: the count's worker grid (``topology.Groups``): ``(workers,)`` flat,
    #: ``(hosts, workers)`` for whole host groups (one host included)
    grid: object
    #: the ``ProcessGroup`` of ranks 0 .. m - 1 (None on a rank past them)
    span: object


def build_count_groups(counts, *, workers_per_host: int | None = None,
                       host_axis: str = "hosts",
                       worker_axis: str = "workers") -> dict[int, CountGroups]:
    """``{m: CountGroups}`` for every count in ``counts``, made in
    ascending order; every rank of the world calls it with the same
    counts.  ``workers_per_host``: each count is whole host groups of that
    many ranks, its grid ``(m // workers_per_host, workers_per_host)``."""
    from repro_torch.topology import grid_groups
    out = {}
    for m in sorted(set(counts)):
        ranks = np.arange(m)
        if workers_per_host is None:
            grid = grid_groups(ranks, (worker_axis,))
            span = grid.groups[0]
        else:
            if m % workers_per_host:
                raise ValueError(
                    f"M={m} is not whole host groups of {workers_per_host}")
            grid = grid_groups(ranks.reshape(-1, workers_per_host),
                               (host_axis, worker_axis))
            span = grid_groups(ranks, (worker_axis,)).groups[0]
        out[m] = CountGroups(grid=grid, span=span)
    return out


def staleness_scale(delay_windows: int, *, gamma: float = 0.5) -> float:
    """Weight for a late worker's delta: 1 / (1 + delay)^gamma.

    delay=0 (on time) gives 1.0: the paper's eq. (9) applies deltas at full
    weight one round late; heavier staleness is damped as in asynchronous
    SGD practice."""
    return float(1.0 / (1.0 + delay_windows) ** gamma)


def merge_late_delta(w_shared, delta, *, delay_windows: int = 0,
                     gamma: float = 0.5):
    """Paper eq. (8)/(9) merge of one (possibly stale) delta:
    ``w - s * delta`` in f32, cast back to ``w``'s dtype, with ``s =
    staleness_scale(delay_windows)``.  ``w_shared`` and ``delta`` are
    tensors, or dicts or tuples of them with one structure."""
    s = staleness_scale(delay_windows, gamma=gamma)
    if isinstance(w_shared, dict):
        return {k: merge_late_delta(w_shared[k], delta[k],
                                    delay_windows=delay_windows, gamma=gamma)
                for k in w_shared}
    if isinstance(w_shared, tuple):
        return tuple(merge_late_delta(w, d, delay_windows=delay_windows,
                                      gamma=gamma)
                     for w, d in zip(w_shared, delta, strict=True))
    return (w_shared.to(torch.float32)
            - s * delta.to(torch.float32)).to(w_shared.dtype)
