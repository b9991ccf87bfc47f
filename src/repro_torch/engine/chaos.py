"""Seeded failure injection, counterpart of ``repro/engine/chaos.py``.

The paper's headline numbers come from Azure VMs, a platform that loses
workers mid-run, slows them unpredictably and partitions whole host groups.
``ChaosSchedule`` is a seed-reproducible list of such faults on the global
window axis; ``ChaosNetwork`` composes it over any ``NetworkModel``, so the
executors see faults through the two hooks they already consult: round
lengths for the eq.-9 loop, the per-window late matrix for the quorum merge.

One ``ChaosEvent`` each:

  * ``kill``: worker ``target`` dies at ``window`` and never returns.  The
    ``ElasticMeshExecutor`` turns it into an unscheduled shrink by one at
    the next window barrier; a plain ``MeshExecutor`` sees the worker late
    for ever.
  * ``slow``: worker ``target`` straggles for ``duration`` windows; its delta
    misses the merge deadline and is folded in late, damped by
    ``staleness_scale`` (the quorum merge).
  * ``partition``: host group ``target`` drops off the inter-host wire for
    ``duration`` windows: every worker of the group is late at once.

Everything here is host numpy seeded by ``numpy.random.Philox``, as in the
reference, so the same seed gives the reference's events and late matrices
bit for bit.  A kill's row stays marked by its index: after an elastic run
removes the dead worker, the index names a survivor, which the segments'
late matrices then mark late from the kill window on.  The reference does
the same, and the port keeps it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.engine.network import NetworkModel

KINDS = ("kill", "slow", "partition")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One injected fault at global window ``window`` (>= 1)."""

    window: int     # global window index the fault fires at
    kind: str       # 'kill' | 'slow' | 'partition'
    target: int     # worker index (kill/slow) or host-group index (partition)
    duration: int = 1   # windows the fault lasts (kill: permanent)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r}; choose from {KINDS}")
        if self.window < 1:
            raise ValueError(
                f"chaos window must be >= 1 (after at least one merge), "
                f"got {self.window}")
        if self.target < 0:
            raise ValueError(f"chaos target must be >= 0, got {self.target}")
        if self.duration < 1:
            raise ValueError(
                f"chaos duration must be >= 1 window, got {self.duration}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ChaosSchedule:
    """An ordered, seed-reproducible list of ``ChaosEvent``s.

    ``hosts`` is the logical host grouping partition targets index into
    (workers ``[g*wph, (g+1)*wph)`` are group ``g``), independent of the
    topology actually running: a flat run can still suffer a tier-1-shaped
    outage."""

    def __init__(self, events, *, seed: int = 0, hosts: int = 1):
        evs = sorted(
            (e if isinstance(e, ChaosEvent) else ChaosEvent(*e)
             for e in events),
            key=lambda e: (e.window, KINDS.index(e.kind), e.target))
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        kills = [e.target for e in evs if e.kind == "kill"]
        if len(set(kills)) != len(kills):
            raise ValueError(
                f"a worker can only die once; duplicate kill targets in "
                f"{kills}")
        self.events: tuple[ChaosEvent, ...] = tuple(evs)
        self.seed = seed
        self.hosts = hosts

    # -- constructors -------------------------------------------------------

    @classmethod
    def generate(cls, seed: int, *, windows: int, m: int, kills: int = 0,
                 slows: int = 0, partitions: int = 0, hosts: int = 2,
                 slow_duration: int = 3,
                 partition_duration: int = 2) -> ChaosSchedule:
        """Draw a schedule from ``seed`` (numpy Philox).

        Faults land in the middle half of the run, ``[windows//4,
        3*windows//4)``, so the run reaches them and has windows left to
        recover in; event windows are distinct, kill targets are distinct
        workers, and no worker is both killed and slowed."""
        if windows < 8:
            raise ValueError(
                f"need >= 8 windows to place faults with recovery room, "
                f"got {windows}")
        n_events = kills + slows + partitions
        if n_events == 0:
            return cls([], seed=seed, hosts=hosts)
        if kills >= m:
            raise ValueError(
                f"cannot kill {kills} of {m} workers — at least one must "
                f"survive")
        lo, hi = max(1, windows // 4), max(2, 3 * windows // 4)
        if hi - lo < n_events:
            raise ValueError(
                f"{n_events} events do not fit in the fault span "
                f"[{lo}, {hi}) of a {windows}-window run")
        rng = np.random.Generator(np.random.Philox(key=abs(int(seed))))
        wins = lo + rng.permutation(hi - lo)[:n_events]
        victims = rng.permutation(m)            # distinct kill/slow targets
        groups = rng.permutation(max(hosts, 1))
        events: list[ChaosEvent] = []
        i = 0
        for k in range(kills):
            events.append(ChaosEvent(int(wins[i]), "kill", int(victims[k])))
            i += 1
        for s in range(slows):
            events.append(ChaosEvent(
                int(wins[i]), "slow", int(victims[(kills + s) % m]),
                duration=slow_duration))
            i += 1
        for p in range(partitions):
            events.append(ChaosEvent(
                int(wins[i]), "partition", int(groups[p % max(hosts, 1)]),
                duration=partition_duration))
            i += 1
        return cls(events, seed=seed, hosts=hosts)

    @classmethod
    def from_spec(cls, spec: str, *, windows: int, m: int,
                  hosts: int = 2) -> ChaosSchedule:
        """Parse the CLI form ``"SEED:kill=2,slow=1,part=1"``; counts
        default to 0, so ``"7:kill=1"`` is one kill drawn from seed 7."""
        head, sep, tail = spec.partition(":")
        if not sep or not head.strip():
            raise ValueError(
                f"bad chaos spec {spec!r} (want 'SEED:kill=K,slow=S,"
                f"part=P')")
        try:
            seed = int(head)
        except ValueError:
            raise ValueError(
                f"bad chaos seed {head!r} (want an integer)") from None
        counts = {"kill": 0, "slow": 0, "part": 0}
        for part in tail.split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, val = part.partition("=")
            if not eq or name not in counts:
                raise ValueError(
                    f"bad chaos schedule entry {part!r} (want "
                    f"'kill=K' | 'slow=S' | 'part=P')")
            try:
                counts[name] = int(val)
            except ValueError:
                raise ValueError(
                    f"bad chaos count {val!r} in {part!r}") from None
        return cls.generate(seed, windows=windows, m=m, hosts=hosts,
                            kills=counts["kill"], slows=counts["slow"],
                            partitions=counts["part"])

    # -- queries ------------------------------------------------------------

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    @property
    def kill_events(self) -> tuple[ChaosEvent, ...]:
        return tuple(e for e in self.events if e.kind == "kill")

    def events_between(self, w0: int, w1: int) -> tuple[ChaosEvent, ...]:
        """Events firing in the global window span ``[w0, w1)``."""
        return tuple(e for e in self.events if w0 <= e.window < w1)

    def describe(self) -> str:
        if not self.events:
            return f"seed={self.seed}: no faults"
        return f"seed={self.seed}: " + ",".join(
            f"{e.kind}@{e.window}:{e.target}" for e in self.events)

    def _group_members(self, group: int, m: int) -> range:
        """Worker indices of logical host group ``group`` under the
        schedule's grouping, clamped to the live worker count ``m``."""
        wph = max(1, m // max(self.hosts, 1))
        return range(min(group * wph, m), min((group + 1) * wph, m))

    def late_matrix(self, m: int, n_windows: int, *,
                    window0: int = 0) -> np.ndarray:
        """(m, n_windows) float32 lateness bits over global windows
        ``[window0, window0 + n_windows)``: 1.0 = that worker's delta misses
        that window's merge deadline.

        slow: the target worker for ``duration`` windows; partition: every
        worker of the target host group for ``duration`` windows; kill: the
        target worker from its death window on.  Targets at or past ``m``
        are ignored."""
        late = np.zeros((m, n_windows), np.float32)
        for e in self.events:
            w = e.window - window0
            if e.kind == "kill":
                if e.target < m and w < n_windows:
                    late[e.target, max(w, 0):] = 1.0
                continue
            lo, hi = max(w, 0), min(w + e.duration, n_windows)
            if hi <= lo:
                continue
            if e.kind == "slow":
                if e.target < m:
                    late[e.target, lo:hi] = 1.0
            else:  # partition: the whole host group drops off the wire
                for worker in self._group_members(e.target, m):
                    late[worker, lo:hi] = 1.0
        return late


class ChaosNetwork(NetworkModel):
    """A ``NetworkModel`` that injects a ``ChaosSchedule``'s faults.

    Tick pricing (``window_ticks``, ``transfer_ticks``) passes through to the
    inner model: a fault changes who arrives, not what the healthy wire
    costs.  The two fault-visible hooks overlay the schedule:

      * ``round_lengths`` (eq. 9): slowed workers' rounds, and partitioned
        groups', stretch by ``slow_factor`` for the fault's duration; a
        killed worker's rounds from its death on last ``DEAD_TICKS``, so
        they never complete (``core.async_vq.done_mask`` sums the rounds in
        int64);
      * ``late_matrix`` (the quorum merge): the union of the inner model's
        stragglers and the schedule's lateness.
    """

    name = "chaos"
    #: a dead worker's round length: longer than any run
    DEAD_TICKS = 10 ** 7

    def __init__(self, inner: NetworkModel, schedule: ChaosSchedule, *,
                 topology=None, slow_factor: int = 4):
        if slow_factor < 1:
            raise ValueError(f"slow_factor must be >= 1, got {slow_factor}")
        self.inner = inner
        self.schedule = schedule
        self.slow_factor = slow_factor
        if topology is not None and not topology.is_flat:
            # a real topology overrides the schedule's logical grouping:
            # partition targets then index its host groups
            self.schedule = ChaosSchedule(schedule.events,
                                          seed=schedule.seed,
                                          hosts=topology.hosts)

    def window_ticks(self, tau: int) -> int:
        return self.inner.window_ticks(tau)

    def transfer_ticks(self, wire_bytes, *, tier=None) -> int:
        return self.inner.transfer_ticks(wire_bytes, tier=tier)

    def events_between(self, w0: int, w1: int):
        return self.schedule.events_between(w0, w1)

    def round_lengths(self, generator: torch.Generator, m: int,
                      max_rounds: int, tau: int) -> torch.Tensor:
        """The inner model's (m, max_rounds) draw from ``generator`` with
        the schedule overlaid in int64, clamped to ``DEAD_TICKS``: an int32
        host tensor."""
        base = self.inner.round_lengths(generator, m, max_rounds, tau)
        lengths = np.asarray(base).astype(np.int64)
        # eq. 9 has no window barrier; round r of a healthy worker covers
        # about window r, so faults map window -> round index
        for e in self.schedule:
            if e.kind == "kill":
                if e.target < m and e.window < max_rounds:
                    lengths[e.target, e.window:] = self.DEAD_TICKS
                continue
            lo, hi = e.window, min(e.window + e.duration, max_rounds)
            if hi <= lo:
                continue
            targets = ([e.target] if e.kind == "slow"
                       else self.schedule._group_members(e.target, m))
            for worker in targets:
                if worker < m:
                    lengths[worker, lo:hi] *= self.slow_factor
        return torch.from_numpy(
            np.minimum(lengths, self.DEAD_TICKS).astype(np.int32))

    def late_matrix(self, m: int, n_windows: int, tau: int, *,
                    window0: int = 0) -> np.ndarray:
        inner = self.inner.late_matrix(m, n_windows, tau, window0=window0)
        sched = self.schedule.late_matrix(m, n_windows, window0=window0)
        return np.maximum(np.asarray(inner, np.float32), sched)
