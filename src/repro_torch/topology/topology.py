"""``Topology``: the M workers as ``hosts`` groups of ``workers_per_host``.

Counterpart of ``repro/topology/topology.py``.  The paper's platform was
hierarchical: cheap links inside a machine, slow links between machines.
Tier 0 is the worker axis inside one host group, tier 1 the host axis
across groups.

The reference's topology is a grid of JAX devices, one worker each.  Here
the workers are dimension 0 of one stacked tensor on one card, so a
topology is a row-major ``(hosts, workers_per_host)`` view of that
dimension (``view``): worker ``i`` is host ``i // workers_per_host``, the
order in which the reference's grid enumerates its devices.  Nothing maps
to a device, so the reference's device-partition check has no counterpart,
and neither has its device count limit.

Not ported: ``grid_mesh``, ``Topology.make_mesh``, ``Topology.detect``,
``make_worker_mesh``, ``make_production_mesh`` and ``make_host_mesh``.
They build JAX device meshes and have no stacked counterpart; the
process-group backend takes them up (ROADMAP queue 1, item 9b).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    """``hosts`` groups of ``workers_per_host`` stacked workers."""

    hosts: int
    workers_per_host: int
    host_axis: str = "hosts"
    worker_axis: str = "workers"

    def __post_init__(self):
        if not self.host_axis or not self.worker_axis:
            raise ValueError(
                f"topology axis names must be non-empty, got "
                f"({self.host_axis!r}, {self.worker_axis!r})")
        if self.host_axis == self.worker_axis:
            raise ValueError(
                f"host and worker axes must be distinct, both are "
                f"{self.host_axis!r}")
        if self.hosts < 1 or self.workers_per_host < 1:
            raise ValueError(
                f"need hosts >= 1 and workers_per_host >= 1, got "
                f"{self.hosts}x{self.workers_per_host}")

    @property
    def total_workers(self) -> int:
        return self.hosts * self.workers_per_host

    @property
    def is_flat(self) -> bool:
        """One host group: the flat worker dimension."""
        return self.hosts == 1

    @property
    def axes(self) -> tuple[str, ...]:
        """Axis names, outermost first."""
        if self.is_flat:
            return (self.worker_axis,)
        return (self.host_axis, self.worker_axis)

    def describe(self) -> str:
        return f"{self.hosts}x{self.workers_per_host}"

    def group_of(self, worker: int) -> int:
        """Host group owning worker ``worker`` (row-major)."""
        if not 0 <= worker < self.total_workers:
            raise ValueError(
                f"worker {worker} outside 0..{self.total_workers - 1}")
        return worker // self.workers_per_host

    def group_members(self, host: int) -> range:
        """Workers living on host group ``host``, the inverse of
        ``group_of``."""
        if not 0 <= host < self.hosts:
            raise ValueError(f"host {host} outside 0..{self.hosts - 1}")
        return range(host * self.workers_per_host,
                     (host + 1) * self.workers_per_host)

    def view(self, x: torch.Tensor) -> torch.Tensor:
        """x (M, ...) -> the (hosts, workers_per_host, ...) view of it."""
        if x.dim() < 1 or x.shape[0] != self.total_workers:
            raise ValueError(
                f"a {self.describe()} topology holds {self.total_workers} "
                f"workers, got a payload of shape {tuple(x.shape)}")
        return x.view(self.hosts, self.workers_per_host, *x.shape[1:])

    @classmethod
    def flat(cls, m: int, *, worker_axis: str = "workers",
             host_axis: str = "hosts") -> Topology:
        """1 x m: the flat worker dimension."""
        return cls.simulate(1, m, worker_axis=worker_axis,
                            host_axis=host_axis)

    @classmethod
    def simulate(cls, hosts: int, workers_per_host: int, *,
                 host_axis: str = "hosts",
                 worker_axis: str = "workers") -> Topology:
        """``hosts`` contiguous groups of ``workers_per_host`` workers."""
        return cls(hosts, workers_per_host, host_axis=host_axis,
                   worker_axis=worker_axis)

    @classmethod
    def from_spec(cls, m: int, hosts: int | None = None, *,
                  host_axis: str = "hosts",
                  worker_axis: str = "workers") -> Topology:
        """``m`` workers split over ``hosts`` groups (None or 1: flat), the
        ``--hosts H`` form: M must split into H equal groups, so
        ``--workers 8 --hosts 3`` is an error, not a rounding."""
        if hosts is None or hosts == 1:
            return cls.flat(m, worker_axis=worker_axis, host_axis=host_axis)
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if m % hosts:
            raise ValueError(
                f"M={m} workers cannot split into {hosts} equal host "
                f"groups — the topology must partition the workers")
        return cls.simulate(hosts, m // hosts, host_axis=host_axis,
                            worker_axis=worker_axis)
