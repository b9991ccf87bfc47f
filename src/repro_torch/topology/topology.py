"""``Topology``: the M workers as ``hosts`` groups of ``workers_per_host``.

Counterpart of ``repro/topology/topology.py``.  The paper's platform was
hierarchical: cheap links inside a machine, slow links between machines.
Tier 0 is the worker axis inside one host group, tier 1 the host axis
across groups.

The reference's topology is a grid of JAX devices, one worker each.  The
port runs its workers two ways:

  * stacked: the workers are dimension 0 of one tensor on one card, and a
    topology is a row-major ``(hosts, workers_per_host)`` view of that
    dimension (``view``): worker ``i`` is host ``i // workers_per_host``,
    the order in which the reference's grid enumerates its devices;
  * one worker a process (``distributed.process_group``): worker ``i`` is
    rank ``i``, and ``make_groups`` gives this rank its process group on
    each axis, the counterpart of the reference's ``make_mesh``.

The mesh builders' counterparts: ``grid_groups`` (``grid_mesh``), the one
place in ``src/repro_torch`` that calls ``dist.new_group``;
``Topology.make_groups`` (``make_mesh``); ``Topology.detect`` (ranks
grouped by host name); ``make_worker_groups``, ``make_host_groups`` and
``make_production_groups`` (``make_worker_mesh``, ``make_host_mesh``,
``make_production_mesh``).  Their rank layouts are plain arithmetic
(``Topology.rank_grid``, ``production_grid``), tested without a world.
"""

from __future__ import annotations

import dataclasses
import socket

import numpy as np
import torch

#: TP width of one production worker group, and DP workers per pod: the
#: reference's (16, 16) production grid.
PRODUCTION_MODEL = 16
PRODUCTION_DATA = 16


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's process group on each axis of a rank grid.

    ``members[i]`` are the global ranks of the group along ``axes[i]`` that
    holds this rank, in order, and ``coords[i]`` this rank's index in it;
    ``groups[i]`` is that ``ProcessGroup`` (None for a rank outside the
    grid, whose ``coords`` are empty)."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    members: tuple[tuple[int, ...], ...]
    coords: tuple[int, ...]
    groups: tuple

    def group(self, axis: str):
        return self.groups[self.axes.index(axis)]

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[self.axes.index(axis)]


def axis_members(grid: np.ndarray, axis: int, rank: int
                 ) -> tuple[tuple[int, ...], int] | None:
    """The ranks of ``grid`` along ``axis`` through ``rank``, and ``rank``'s
    index among them; None when ``rank`` is not in the grid."""
    where = np.argwhere(grid == rank)
    if len(where) == 0:
        return None
    idx = list(where[0])
    idx[axis] = slice(None)
    line = tuple(int(r) for r in grid[tuple(idx)])
    return line, int(where[0][axis])


def grid_groups(ranks, axes: tuple[str, ...]) -> Groups:
    """The one ``dist.new_group`` caller in ``src/repro_torch``: a process
    group for every line of the rank grid ``ranks`` along every axis.
    Every rank of the world calls it with the same grid and makes every
    group in the same order, as ``torch.distributed`` requires; each gets
    back its own groups.  Counterpart of the reference's ``grid_mesh``."""
    import torch.distributed as dist
    grid = np.asarray(ranks, dtype=np.int64)
    if grid.ndim != len(axes):
        raise ValueError(
            f"rank grid rank {grid.ndim} != {len(axes)} axes {axes}")
    if any(not name for name in axes):
        raise ValueError(f"axis names must be non-empty, got {axes}")
    if len(set(grid.reshape(-1).tolist())) != grid.size:
        raise ValueError("the rank grid must hold each rank once")
    world = dist.get_world_size()
    if grid.size and (grid.min() < 0 or grid.max() >= world):
        raise ValueError(
            f"the rank grid {grid.shape} names ranks outside the world of "
            f"{world}")
    me = dist.get_rank()
    members, coords, groups = [], [], []
    for a in range(grid.ndim):
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        mine = None
        for line in lines:
            g = dist.new_group(ranks=[int(r) for r in line])
            if me in line:
                mine = g
        found = axis_members(grid, a, me)
        if found is not None:
            members.append(found[0])
            coords.append(found[1])
        groups.append(mine)
    return Groups(axes=tuple(axes), shape=tuple(grid.shape),
                  members=tuple(members), coords=tuple(coords),
                  groups=tuple(groups))


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

    def rank_grid(self, *, model: int | None = None) -> tuple[np.ndarray,
                                                              tuple]:
        """``(the rank grid, its axes)`` of ``make_groups``: worker i is
        rank i, row-major, as the reference's ``make_mesh`` lays out its
        devices.  ``model=None``: ``(workers,)`` flat, ``(hosts,
        workers)`` not; ``model=k``: ``(data, model)`` flat, ``(hosts,
        data, model)`` not."""
        grid = np.arange(self.total_workers).reshape(self.hosts,
                                                     self.workers_per_host)
        if model is None:
            if self.is_flat:
                return grid[0], (self.worker_axis,)
            return grid, (self.host_axis, self.worker_axis)
        if model < 1:
            raise ValueError(f"model axis size must be >= 1, got {model}")
        if self.workers_per_host % model:
            raise ValueError(
                f"model={model} must divide workers_per_host="
                f"{self.workers_per_host}")
        grid = grid.reshape(self.hosts, self.workers_per_host // model, model)
        if self.is_flat:
            return grid[0], ("data", "model")
        return grid, (self.host_axis, "data", "model")

    def make_groups(self, *, model: int | None = None) -> Groups:
        """This rank's process group on each axis of ``rank_grid``: with
        ``hosts > 1``, tier 0 (the worker axis) is the ranks of my host and
        tier 1 (the host axis) the ranks with my in-host index across
        hosts.  The world must hold the topology's workers."""
        import torch.distributed as dist
        world = dist.get_world_size()
        if world != self.total_workers:
            raise ValueError(
                f"a {self.describe()} topology needs a world of "
                f"{self.total_workers} ranks, this one has {world}")
        grid, axes = self.rank_grid(model=model)
        return grid_groups(grid, axes)

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
    def detect(cls, *, host_axis: str = "hosts",
               worker_axis: str = "workers") -> Topology:
        """The world's shape: its ranks grouped by host name (every rank
        calls it; one ``all_gather_object``).  One machine is flat.  Ragged
        groups are refused, as the reference refuses them, and so are a
        host's ranks that are not consecutive (torchrun numbers a node's
        ranks consecutively)."""
        import torch.distributed as dist
        world = dist.get_world_size()
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        by_host: dict[str, list[int]] = {}
        for r, name in enumerate(names):
            by_host.setdefault(name, []).append(r)
        sizes = {len(v) for v in by_host.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"ragged host groups "
                f"{sorted((k, len(v)) for k, v in by_host.items())} — the "
                f"topology needs the same rank count per host")
        wph = sizes.pop()
        for ranks in by_host.values():
            if ranks != list(range(ranks[0], ranks[0] + wph)):
                raise ValueError(
                    f"a host's ranks {ranks} are not consecutive; the "
                    f"topology is row-major over the ranks")
        return cls(len(by_host), wph, host_axis=host_axis,
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


def make_worker_groups(m: int, axis: str = "workers") -> Groups:
    """The flat worker group over a world of ``m`` ranks (the reference's
    ``make_worker_mesh``)."""
    if not axis:
        raise ValueError("axis name must be a non-empty string")
    return Topology.flat(m, worker_axis=axis).make_groups()


def make_host_groups(*, data: int = 1, model: int = 1) -> Groups:
    """A small (data, model) grid over the first ranks of the world,
    clamped as the reference's ``make_host_mesh`` clamps to the devices
    there are; ranks past ``data * model`` get no group."""
    import torch.distributed as dist
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    grid, axes = Topology.flat(data * model).rank_grid(model=model)
    return grid_groups(grid, axes)


def production_grid(*, multi_pod: bool = False) -> tuple[np.ndarray, tuple]:
    """The production LM layout as ranks: ``(data, model)`` = (16, 16), or
    ``(pod, data, model)`` = (2, 16, 16) multi-pod, row-major (the
    reference's ``make_production_mesh``)."""
    topo = Topology.simulate(2 if multi_pod else 1,
                             PRODUCTION_DATA * PRODUCTION_MODEL,
                             host_axis="pod")
    return topo.rank_grid(model=PRODUCTION_MODEL)


def make_production_groups(*, multi_pod: bool = False) -> Groups:
    """The production layout's groups; the world must hold its 256 (512
    multi-pod) ranks."""
    import torch.distributed as dist
    grid, axes = production_grid(multi_pod=multi_pod)
    world = dist.get_world_size()
    if world < grid.size:
        raise ValueError(
            f"the production layout {'x'.join(map(str, grid.shape))} needs "
            f"a world of {grid.size} ranks, this one has {world}")
    return grid_groups(grid, axes)
