"""``ElasticMeshExecutor``: the worker set grows and shrinks between merge
windows, without a restart.  Counterpart of ``repro/engine/elastic.py``.

A cloud deployment of the paper's schemes sees workers appear and
disappear, and the displacement merge (eq. 8) stays sound under stale and
late contributions, so a change of worker count is a resharding event:

    window k merge complete
        |
        v
    the schedule (or a chaos kill) says M -> M' at window k
        |
        +- 1. late deltas: the departing workers' in-flight window, computed
        |     from the shared version, merged by eq. 8 damped by
        |     ``staleness_scale`` (``late_policy="merge"``)
        +- 2. the executor for M' (one ``MeshExecutor`` a worker count)
        +- 3. checkpoint {w_srd, t, cursor, window, m, tick_offset}
        +- 4. reslice the global sample pool into M' streams
        |
        v
    window k+1 runs on M' stacked workers (the step schedule continues)

On one card a resize re-slices the stacked worker dimension.  The executor
consumes one time-major global pool of ``M0 * n`` points (the input streams
interleaved point by point), so an elastic run and a fixed-M run on the
same ``data`` see the same sample budget, and a schedule that never fires
is the fixed-M run bit for bit.  Each segment's streams are cut from the
pool and made contiguous once; the eval pool is split over the current M,
so every M scores (almost) all of it.  The late deltas go through the
executor's own window route: on the card the window kernel, in one launch
over the departing workers' ``(n_dep, tau, d)`` stack.  Nothing leaves the
device but the checkpoints.

A hierarchical ``topology`` resizes whole host groups: targets round down
to a multiple of ``workers_per_host``, each worker count runs on its own
``Topology`` through the ``HierarchicalTransport`` regrouped onto it
(``regroup``), so one ``CommLog`` holds the whole run, and the late deltas
are charged to tier 1.  ``max_workers`` caps the worker count, the
counterpart of the reference's device count (``None``: the card holds any
M).

``chaos`` (a ``ChaosSchedule``): each kill is an unscheduled shrink by one
at the next window barrier; slow and partition faults ride the quorum
merge's late matrix through a ``ChaosNetwork`` given as ``network``.

Checkpoints: one after every resize event (the post-event state, so a
resume continues bit for bit), and with ``checkpoint_every`` one every N
global windows through the segments' ``on_window`` hook.  ``resume=True``
restores the latest and skips the consumed prefix.  ``ResizeStats.wall_s``
is a resize's own time: the card is drained before it starts and synced at
its end; ``checkpoint_s`` is the part the save took (it copies the
codebook to the host).

``tracer=`` / ``metrics=`` are shared by every per-M executor, so a run is
one timeline (the reference's ``elastic.py`` hooks): wall spans ``run``,
``resplit`` (a segment's streams cut from the pool), ``resize``,
``late_delta``, ``remesh`` and ``checkpoint`` (after a resize, and
``periodic=True`` from the hook), beside the segments' own; the counters
``resize_events``, ``chaos_kills``, ``staleness_windows``,
``late_delta_points``, ``late_delta_skipped`` and
``periodic_checkpoints``, and the ``resize_wall_s`` and ``run_wall_s``
histograms.  The registry is attached to the transport's log once: the
per-M executors share that log.

``profiler=`` (``obs.Profiler``) is shared by the per-M executors too: each
segment notes its own shapes, and the run's wall, started and ended with
the device drained, is attributed across them, so an elastic run gives one
attribution whose ``segments`` counts its M-segments.  The late deltas are
no program's collective and stay out of it.

One worker a process (``group=``, a process group spanning the world in
rank order; ``distributed.process_group``): worker i is rank i, and a
count of M runs on ranks 0 .. M - 1, the counterpart of the reference
rebuilding its device mesh at every resize.  ``prepare`` builds, on every
rank and before the first window, the groups of every count the schedule
and the chaos kills will visit (``elastic.build_count_groups``); the cap
is the world's size, the counterpart of ``len(jax.devices())``.  Each
count's ``MeshExecutor`` runs over its grid with the executor's transport
rebuilt over it (``process_transport``; whole host groups on a
hierarchical topology), sharing one ``CommLog``.  Every rank holds the
global inputs and keeps the run's cursor itself, so a rank past the
current count takes no part in that segment and waits for the grow that
includes it, which hands it ``w_srd`` by one broadcast from rank 0 over
the new count's ranks.  At a shrink each departing rank runs its in-flight
window at ``(1, tau, d)`` on its rows of the pool; the rows are gathered
over the old count's ranks in rank order and summed with the stacked
``torch.sum``, so the merge is the stacked run's bit for bit, and every
rank records the same ``late_delta``.  A chaos kill leaves the last active
rank idle in the world until the run ends.  Rank 0 writes the checkpoints;
every rank passes a world barrier at each resize, so the next window
starts with the file on disk, and a resume restores on every rank.
``run`` returns rank 0's result on every rank (the idle ranks' part of it
by one broadcast at the end); its wall starts and ends with the device
drained and a world barrier, and ``ResizeStats.wall_s`` is each rank's own
reading of its resize (the device drained at its start; the world
barrier at its end included), rank 0's the one the launcher reports.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from repro_torch import comm
from repro_torch import device as device_lib
from repro_torch.comm.api import WORKER_AXIS
from repro_torch.core import vq
from repro_torch.core.schemes import SchemeResult
from repro_torch.distributed import elastic as elastic_lib
from repro_torch.distributed import process_group
from repro_torch.engine import api
from repro_torch.engine.mesh import MeshExecutor, _hier_of, process_transport
from repro_torch.engine.network import InstantNetwork, NetworkModel
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.topology import Topology

ELASTIC_SCHEMES = ("average", "delta")


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """At the end of global window ``window``, the worker set becomes
    ``new_m`` (clamped by ``max_workers`` and, on a hierarchical topology,
    to whole host groups)."""

    window: int
    new_m: int


class ResizeSchedule:
    """An ordered list of ``ResizeEvent``s, e.g. ``[(20, 4), (40, 8)]``."""

    def __init__(self, events):
        evs = [e if isinstance(e, ResizeEvent) else ResizeEvent(*e)
               for e in events]
        for e in evs:
            if e.window < 1:
                raise ValueError(
                    f"resize window must be >= 1 (after at least one merge), "
                    f"got {e.window}")
            if e.new_m < 1:
                raise ValueError(f"resize target M must be >= 1, "
                                 f"got {e.new_m}")
        windows = [e.window for e in evs]
        if sorted(windows) != windows or len(set(windows)) != len(windows):
            raise ValueError(
                f"resize windows must be strictly increasing, got {windows}")
        self.events: tuple[ResizeEvent, ...] = tuple(evs)

    @classmethod
    def parse(cls, spec: str) -> ResizeSchedule:
        """Parse the CLI form ``"WINDOW:M,WINDOW:M,..."`` (e.g. "20:4,40:8")."""
        events = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                win, m = part.split(":")
                events.append(ResizeEvent(int(win), int(m)))
            except ValueError as e:
                raise ValueError(
                    f"bad resize spec {part!r} (want 'WINDOW:M'): {e}") from None
        if not events:
            raise ValueError(f"empty resize spec {spec!r}")
        return cls(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)


@dataclasses.dataclass
class ResizeStats:
    """What one resize event did (filled in at run time)."""

    window: int
    old_m: int
    new_m: int
    # from plan_remesh; the workers form a 1-D grid, so always True here
    tp_preserved: bool
    late_points: int
    checkpoint_step: int | None
    wall_s: float
    # 'merge' was asked for but the pool had too few points left for the
    # departing workers' window: the event degraded to 'drop'
    late_skipped: bool = False
    # 'schedule' (a ResizeEvent) or 'chaos_kill' (an injected death)
    cause: str = "schedule"
    # the part of wall_s the checkpoint save took
    checkpoint_s: float = 0.0


def _regrouped(transport: comm.Transport, topology: Topology,
               groups=None) -> comm.Transport:
    """``transport`` over ``topology``: its hierarchical transport (under a
    quantized wire, if any) regrouped, sharing the logs.  With ``groups``
    (a count's grid over processes), the same transport built over them by
    ``process_transport``, sharing ``transport``'s log."""
    hier = _hier_of(transport)
    if groups is not None:
        if isinstance(transport, comm.QuantizedTransport):
            raise ValueError(
                "an elastic run over processes takes a dense, ring, sparse "
                "or hierarchical transport (a quantized wire's residual is "
                "per-worker state a resize does not carry)")
        if hier is None:
            out = process_transport(transport.name, groups,
                                    frac=getattr(transport, "frac", 0.01))
        else:
            out = process_transport(
                hier.tier0.name, groups, topology, tier1=hier.tier1.name,
                frac=getattr(hier.tier0, "frac", 0.01),
                tier1_frac=getattr(hier.tier1, "frac", 0.01))
        out.log = transport.log
        return out
    if hier is None:
        return transport
    if transport is hier:
        return hier.regroup(topology)
    out = copy.copy(transport)
    out.inner = hier.regroup(topology)
    return out


class ElasticMeshExecutor:
    """``MeshExecutor`` with a ``ResizeSchedule``.

    Parameters
    ----------
    schedule:          a ``ResizeSchedule`` (or what its constructor takes).
    network:           ``NetworkModel`` for the tick accounting (default
                       instant); a ``ChaosNetwork`` feeds the quorum merge.
    transport:         one transport for every segment, so the run streams
                       into one ``CommLog`` (segments and late deltas).
    topology:          a hierarchical one resizes whole host groups.
    checkpointer:      a ``repro_torch.checkpoint.Checkpointer``; every
                       resize saves the post-event state (blocking, timed).
    resume:            restore the latest checkpoint and skip the consumed
                       prefix.
    late_policy:       'merge' (default) or 'drop' the departing workers'
                       in-flight window.
    staleness_gamma:   the late deltas' and the quorum merge's damping.
    resize_cost_ticks: wall ticks charged a resize on the curve's axis.
    on_window:         ``on_window(global window, w_shared)`` after every
                       chunk of ``publish_every`` windows.
    chaos:             a ``ChaosSchedule`` whose kills shrink the run.
    checkpoint_every:  a periodic checkpoint every N global windows.
    merge:             None or 'quorum', for every segment.
    max_workers:       the largest worker count (None: any; over processes
                       the world's size).
    group:             one worker a process: a process group spanning the
                       world in rank order (see the module docstring).
    tracer, metrics:   ``repro_torch.obs`` sinks shared by every segment.
    profiler:          an ``obs.Profiler`` shared by every segment.
    use_kernels, fused, smem_budget_bytes, device: as ``MeshExecutor``.
    """

    name = "elastic"

    def __init__(self, schedule, network: NetworkModel | None = None, *,
                 use_kernels: bool = True, fused: bool = True,
                 transport: comm.Transport | str | None = None,
                 topology: Topology | None = None,
                 checkpointer=None, resume: bool = False,
                 late_policy: str = "merge", staleness_gamma: float = 0.5,
                 resize_cost_ticks: int = 0, on_window=None,
                 publish_every: int = 1, chaos=None,
                 checkpoint_every: int | None = None,
                 merge: str | None = None, quorum_frac: float = 0.6,
                 max_workers: int | None = None,
                 smem_budget_bytes: int | None = None,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 profiler=None, group=None,
                 device: str | torch.device | None = None):
        if not isinstance(schedule, ResizeSchedule):
            schedule = ResizeSchedule(schedule)
        if late_policy not in ("merge", "drop"):
            raise ValueError(
                f"late_policy must be 'merge' or 'drop', got {late_policy!r}")
        if resume and checkpointer is None:
            raise ValueError(
                "resume=True needs a checkpointer to restore from — "
                "silently restarting from scratch is not a resume")
        if publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, "
                             f"got {publish_every}")
        if checkpoint_every is not None:
            if checkpoint_every < 1:
                raise ValueError(f"checkpoint_every must be >= 1, "
                                 f"got {checkpoint_every}")
            if checkpointer is None:
                raise ValueError(
                    "checkpoint_every needs a checkpointer to save to")
        if merge not in (None, "quorum"):
            raise ValueError(
                f"merge override must be None (scheme default) or 'quorum', "
                f"got {merge!r}")
        if max_workers is not None and max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self.schedule = schedule
        self.network = network or InstantNetwork()
        self.transport = comm.get_transport(
            transport if transport is not None else "xla")
        hier = _hier_of(self.transport)
        if hier is not None:
            if topology is not None and topology != hier.topology:
                raise ValueError(
                    f"topology {topology.describe()} differs from the "
                    f"hierarchical transport's {hier.topology.describe()}; "
                    f"configure one place only")
            topology = hier.topology
        self.topology = topology
        self.use_kernels = use_kernels
        self.fused = fused
        self.smem_budget_bytes = smem_budget_bytes
        self.device = device_lib.resolve(device)
        self.checkpointer = checkpointer
        self.resume = resume
        self.late_policy = late_policy
        self.staleness_gamma = staleness_gamma
        self.resize_cost_ticks = resize_cost_ticks
        # fires with the GLOBAL window index, continuous across resizes
        self.on_window = on_window
        self.publish_every = publish_every
        self.chaos = chaos
        self.checkpoint_every = checkpoint_every
        self._last_ckpt_window = -1
        self.merge = merge
        self.quorum_frac = quorum_frac
        self.max_workers = max_workers
        # one worker a process: this rank, the world's size, and every
        # visited count's groups (built by prepare)
        self.group = group
        self.rank = 0
        self._counts: dict[int, elastic_lib.CountGroups] = {}
        if group is not None:
            self._check_world(group)
            self.rank = process_group.group_rank(group)
            world = process_group.group_size(group)
            self.max_workers = world if max_workers is None else min(
                max_workers, world)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        if metrics is not None:
            self.transport.log.attach_metrics(metrics)
        self.profiler = profiler
        # one MeshExecutor a worker count
        self._mesh_ex: dict[int, MeshExecutor] = {}
        # of the last run
        self.resize_events: list[ResizeStats] = []
        self.last_comm: dict | None = None
        self.last_late_worker_windows = 0

    # -- internals ----------------------------------------------------------

    @property
    def _hierarchical(self) -> bool:
        return self.topology is not None and not self.topology.is_flat

    @property
    def _axis(self) -> str:
        return (self.topology.worker_axis if self.topology is not None
                else WORKER_AXIS)

    @staticmethod
    def _check_world(group) -> None:
        import torch.distributed as dist
        ranks = dist.get_process_group_ranks(group)
        if ranks != list(range(dist.get_world_size())):
            raise ValueError(
                f"group= must span the world in rank order (worker i is "
                f"rank i), got ranks {ranks}")

    def _active(self, m: int) -> bool:
        """Does this rank run a worker of an ``m``-worker segment?"""
        return self.rank < m

    def _visits(self, m: int, after: int) -> set[int]:
        """The worker counts a run at ``m`` after global window ``after``
        visits: every boundary's target, clamped, in order."""
        out = {m}
        for _, cause, new_m in self._boundaries(after):
            m, _ = self._clamp_m(max(1, m - 1) if cause == "chaos_kill"
                                 else new_m)
            out.add(m)
        return out

    def _boundaries(self, after: int) -> list[tuple[int, str, int]]:
        """Scheduled resizes and injected deaths past global window
        ``after``, each a (window, cause, target M) barrier in order; a
        kill's target is resolved when it fires (the current M less one)."""
        out = [(e.window, "schedule", e.new_m)
               for e in self.schedule if e.window > after]
        if self.chaos is not None:
            out += [(ce.window, "chaos_kill", -1)
                    for ce in self.chaos.kill_events if ce.window > after]
        out.sort(key=lambda b: (b[0], b[1] != "schedule"))
        return out

    def prepare(self, m0: int) -> None:
        """Over processes, build the groups of every worker count a run
        starting at ``m0`` workers visits (collective over the world: every
        rank calls it, in the same order as its other group builders).
        ``run`` calls it itself; a caller whose other threads use the world
        calls it first, on the main thread."""
        self._build(self._visits(self._clamp_m(m0)[0], 0))

    def _build(self, counts) -> None:
        """The groups of the counts not built yet, in ascending order."""
        if self.group is None:
            return
        missing = sorted(set(counts) - set(self._counts))
        if missing:
            self._counts.update(elastic_lib.build_count_groups(
                missing, workers_per_host=(self.topology.workers_per_host
                                           if self._hierarchical else None),
                host_axis=self.topology.host_axis if self.topology else
                "hosts", worker_axis=self._axis))

    def _topology_for(self, m: int) -> Topology | None:
        """``m`` workers' topology: on a hierarchical one ``m //
        workers_per_host`` whole host groups."""
        if not self._hierarchical:
            return None
        return Topology.from_spec(
            m, hosts=max(1, m // self.topology.workers_per_host),
            host_axis=self.topology.host_axis,
            worker_axis=self.topology.worker_axis)

    def _executor_for(self, m: int) -> MeshExecutor:
        """The executor for ``m`` workers (cached): on a hierarchical
        topology it holds ``m // workers_per_host`` whole host groups; over
        processes it runs over the count's grid (on its ranks only)."""
        if m not in self._mesh_ex:
            topo = self._topology_for(m)
            groups = None if self.group is None else self._counts[m].grid
            transport = _regrouped(self.transport, topo or Topology.flat(
                m, worker_axis=self._axis), groups)
            self._mesh_ex[m] = MeshExecutor(
                self.network, transport=transport,
                use_kernels=self.use_kernels, fused=self.fused,
                smem_budget_bytes=self.smem_budget_bytes, merge=self.merge,
                quorum_frac=self.quorum_frac,
                staleness_gamma=self.staleness_gamma,
                topology=topo if groups is None else None,
                tracer=self.tracer, metrics=self.metrics,
                profiler=self.profiler, group=groups, device=self.device)
        return self._mesh_ex[m]

    def _clamp_m(self, requested: int
                 ) -> tuple[int, elastic_lib.RemeshPlan]:
        cap = self.max_workers
        m_req = requested if cap is None else min(requested, cap)
        if self._hierarchical:
            # whole host groups: round down to a multiple of
            # workers_per_host, at least one group
            wph = self.topology.workers_per_host
            m = max(wph, m_req // wph * wph)
            if cap is not None and m > cap:
                raise ValueError(
                    f"one host group needs {wph} workers, max_workers={cap}")
            return m, elastic_lib.plan_remesh(m, prev_data=requested,
                                              prev_model=1)
        plan = elastic_lib.plan_remesh(m_req, prev_data=requested,
                                       prev_model=1)
        return plan.data * plan.model, plan

    @staticmethod
    def _eval_streams(eval_pool: torch.Tensor, m: int) -> torch.Tensor:
        """The shared eval pool split over m workers, (m, n_ev, d)."""
        n_ev = eval_pool.shape[0] // m
        if n_ev == 0:
            raise ValueError(
                f"eval pool of {eval_pool.shape[0]} points cannot feed "
                f"M={m} workers")
        return eval_pool[: n_ev * m].reshape(m, n_ev, eval_pool.shape[-1])

    @staticmethod
    def _state(w_srd, t: int, cursor: int, window: int, m: int,
               tick_offset: int) -> dict:
        """The checkpointed state, the reference's leaves and names."""
        return {"w_srd": w_srd, "t": np.asarray(t, np.int64),
                "cursor": np.asarray(cursor, np.int64),
                "window": np.asarray(window, np.int64),
                "m": np.asarray(m, np.int64),
                "tick_offset": np.asarray(tick_offset, np.int64)}

    def _segment_hook(self, window_idx: int, t0: int, cursor: int, m: int,
                      tau: int, wt: int, tick_offset: int):
        """One segment's ``on_window``: forwards the caller's hook with the
        global window, and with ``checkpoint_every`` saves the state every N
        global windows (a save copies the codebook to the host)."""
        periodic = (self.checkpointer is not None
                    and self.checkpoint_every is not None)
        if self.on_window is None and not periodic:
            return None

        def hook(wi: int, w: torch.Tensor) -> None:
            gw = window_idx + wi
            if self.on_window is not None:
                self.on_window(gw, w)
            if (periodic and gw % self.checkpoint_every == 0
                    and gw > self._last_ckpt_window):
                if self.rank == 0:      # over processes rank 0 writes
                    with self.tracer.span("checkpoint", step=gw,
                                          periodic=True):
                        self.checkpointer.save(gw, self._state(
                            w, t0 + wi * tau, cursor + wi * m * tau, gw, m,
                            tick_offset + wi * wt))
                    if self.metrics is not None:
                        self.metrics.counter("periodic_checkpoints").inc()
                self._last_ckpt_window = gw

        return hook

    # -- public API ---------------------------------------------------------

    def _drain(self) -> None:
        """Wait for the device and, over processes, for every rank."""
        device_lib.synchronize(self.device)
        if self.group is not None:
            process_group.barrier(self.group)

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        del generator, lengths  # the sync schemes draw nothing
        self._drain()
        t_wall = time.perf_counter()
        with self.tracer.span("run", scheme=scheme, executor=self.name,
                              m=data.shape[0] if data.dim() == 3 else None):
            res = self._run(scheme, w0, data, eval_data, tau=tau, eps0=eps0,
                            decay=decay)
        self._drain()
        wall_s = time.perf_counter() - t_wall
        if self.metrics is not None:
            self.metrics.histogram("run_wall_s", executor=self.name,
                                   scheme=scheme).observe(wall_s)
        if self.profiler is not None:
            # the segments were noted by the per-M executors
            self.profiler.finish_run(wall_s)
        return res

    def _run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
             eval_data: torch.Tensor, *, tau: int, eps0: float,
             decay: float) -> SchemeResult:
        api.validate_scheme(scheme)
        if scheme not in ELASTIC_SCHEMES:
            raise ValueError(
                f"elastic execution supports {ELASTIC_SCHEMES}; "
                f"async_delta has no window barrier to resize at")
        if data.dim() != 3:
            raise ValueError(f"data must be (M, n, d), got {tuple(data.shape)}")
        if eval_data.dim() != 3:
            raise ValueError(f"eval_data must be (M, n_eval, d), got "
                             f"{tuple(eval_data.shape)}")
        m0, n, d = data.shape
        if n < tau:
            raise ValueError(
                f"need at least one tau={tau} window per worker, got n={n}")
        w0, data, eval_data = (x.to(self.device, torch.float32)
                               for x in (w0, data, eval_data))
        # one global pool, time-major: elastic and fixed-M runs on the same
        # data consume the same sample budget
        pool = data.transpose(0, 1).reshape(-1, d)
        eval_pool = eval_data.reshape(-1, d)
        total = pool.shape[0]
        wt = self.network.window_ticks(tau)

        cur_m, _ = self._clamp_m(m0)
        w_srd, t0, cursor, window_idx, tick_offset = w0, 0, 0, 0, 0
        self.resize_events = []
        self.last_late_worker_windows = 0
        comm_mark = self.transport.log.mark()
        resumed = False
        if self.resume:
            latest = self.checkpointer.latest_step()
            if latest is None:
                raise ValueError(
                    f"resume=True but no checkpoint found in "
                    f"{self.checkpointer.dir!r} — silently restarting from "
                    f"scratch is not a resume (drop resume for a fresh run)")
            st = self.checkpointer.restore(latest, self._state(
                torch.zeros_like(w0), 0, 0, 0, 0, 0), device=self.device)
            w_srd = st["w_srd"]
            t0, cursor = int(st["t"]), int(st["cursor"])
            window_idx, tick_offset = int(st["window"]), int(st["tick_offset"])
            cur_m, _ = self._clamp_m(int(st["m"]))
            resumed = True

        boundaries = self._boundaries(window_idx)
        # over processes, every count this run (or the run a resume
        # continues) visits
        self._build(self._visits(self._clamp_m(m0)[0], 0)
                    | self._visits(cur_m, window_idx))
        ei = 0
        curves: list[torch.Tensor] = []
        ticks: list[torch.Tensor] = []
        self._last_ckpt_window = window_idx

        while True:
            target = boundaries[ei][0] if ei < len(boundaries) else None
            max_w = (total - cursor) // (cur_m * tau)
            seg_w = max_w if target is None else min(max_w,
                                                     target - window_idx)
            if seg_w > 0:
                seg_pts = cur_m * seg_w * tau
                if self._active(cur_m):
                    res = self._segment(
                        scheme, w_srd, pool, eval_pool, cur_m, seg_w,
                        cursor=cursor, t0=t0, window_idx=window_idx,
                        tick_offset=tick_offset, tau=tau, wt=wt, eps0=eps0,
                        decay=decay)
                    w_srd = res.w_shared
                    curves.append(res.distortion)
                    ticks.append(tick_offset + res.wall_ticks)
                else:
                    # an idle rank: its part of the result comes from rank 0
                    curves.append(None)
                    ticks.append(None)
                tick_offset += seg_w * wt
                cursor += seg_pts
                t0 += seg_w * tau
                window_idx += seg_w
            if target is None or window_idx < target:
                break  # no more events, or the pool ran dry before the next
            win, cause, new_m = boundaries[ei]
            ei += 1
            if cause == "chaos_kill":
                new_m = max(1, cur_m - 1)
            w_srd, cur_m, cursor = self._do_resize(
                ResizeEvent(win, new_m), w_srd, cur_m, pool, cursor, t0,
                window_idx, tick_offset, tau=tau, eps0=eps0, decay=decay,
                cause=cause)
            tick_offset += self.resize_cost_ticks

        self.last_comm = comm.CommLog.summarize(
            self.transport.log.since(comm_mark))
        self.transport.log.mirror_metrics()
        if self.group is not None and curves:
            w_srd, curves, ticks = self._from_rank0(w_srd, curves, ticks)
        if not curves:
            if resumed:
                # the checkpoint holds a complete run: report its state
                return SchemeResult(
                    w_shared=w_srd,
                    wall_ticks=torch.tensor([tick_offset], dtype=torch.int32),
                    distortion=vq.distortion(eval_pool, w_srd).reshape(1))
            raise ValueError(
                "elastic run produced no windows — pool exhausted before the "
                "first merge (reduce tau or provide more data)")
        return SchemeResult(w_shared=w_srd, wall_ticks=torch.cat(ticks),
                            distortion=torch.cat(curves))

    def _segment(self, scheme: str, w_srd, pool, eval_pool, m: int,
                 seg_w: int, *, cursor: int, t0: int, window_idx: int,
                 tick_offset: int, tau: int, wt: int, eps0: float,
                 decay: float) -> SchemeResult:
        """``seg_w`` windows on ``m`` workers from the pool's ``cursor``."""
        seg_pts = m * seg_w * tau
        d = pool.shape[-1]
        # the pool's next seg_pts points as m time-major streams
        with self.tracer.span("resplit", m=m, windows=seg_w,
                              points=seg_pts):
            seg_data = pool[cursor: cursor + seg_pts].reshape(
                seg_w * tau, m, d).transpose(0, 1).contiguous()
        mex = self._executor_for(m)
        # assigned every segment: the executors are cached, so a previous
        # run's hook must not survive into this one
        mex.on_window = self._segment_hook(window_idx, t0, cursor, m, tau,
                                           wt, tick_offset)
        mex.publish_every = self.publish_every
        res = mex.run_segment(scheme, w_srd, seg_data,
                              self._eval_streams(eval_pool, m), tau=tau,
                              eps0=eps0, decay=decay, t0=t0)
        self.last_late_worker_windows += mex.last_late_worker_windows
        return res

    def _from_rank0(self, w_srd, curves, ticks):
        """Over processes, rank 0's codebook, curve, ticks, ``last_comm``
        and late worker-windows on every rank: an idle rank missed some
        segments (the active ones hold the same bits already)."""
        w_srd = process_group.broadcast(
            w_srd if self.rank == 0 else torch.empty_like(w_srd), 0,
            self.group)
        mine = None
        if self.rank == 0:
            mine = (torch.cat(curves).cpu(), torch.cat(ticks),
                    self.last_comm, self.last_late_worker_windows)
        curve, tick, self.last_comm, self.last_late_worker_windows = (
            process_group.all_gather_object(mine, self.group)[0])
        return w_srd, [curve.to(self.device)], [tick]

    # -- resize event -------------------------------------------------------

    def _late_windows(self, w_srd, late, cur_m: int, new_m: int, t0: int, *,
                      tau: int, eps0: float, decay: float) -> torch.Tensor:
        """The departing workers' in-flight windows from the shared
        version, (n_dep, kappa, d): one launch over their ``late`` rows
        (n_dep, tau, d) stacked, or, over processes, each departing rank's
        (1, tau, d) window gathered over the old count's ranks in rank
        order (the others send zeros)."""
        eps = vq.default_steps(
            torch.arange(t0 + 1, t0 + tau + 1, device=self.device),
            eps0=eps0, decay=decay)
        mex = self._executor_for(cur_m)
        if self.group is None:
            return mex._local_window(w_srd, late, eps)
        if self.rank >= new_m:
            j = self.rank - new_m
            mine = mex._local_window(w_srd, late[j:j + 1].contiguous(), eps)
        else:
            mine = torch.zeros((1, *w_srd.shape), dtype=w_srd.dtype,
                               device=self.device)
        rows = process_group.all_gather(mine, self._counts[cur_m].span)
        return rows[new_m:cur_m, 0]

    def _do_resize(self, ev: ResizeEvent, w_srd: torch.Tensor, cur_m: int,
                   pool: torch.Tensor, cursor: int, t0: int, window_idx: int,
                   tick_offset: int, *, tau: int, eps0: float, decay: float,
                   cause: str):
        device_lib.synchronize(self.device)
        t_start = time.perf_counter()
        new_m, plan = self._clamp_m(ev.new_m)
        tr, mt = self.tracer, self.metrics
        if cause == "chaos_kill" and mt is not None:
            mt.counter("chaos_kills").inc()
        late_pts, late_skipped = 0, False
        ckpt_step, ckpt_s = None, 0.0
        with tr.span("resize", window=window_idx, old_m=cur_m, new_m=new_m,
                     cause=cause):
            if new_m < cur_m and self.late_policy == "merge":
                # the departing workers were mid-window when the resize
                # fired: their deltas, computed from the shared version,
                # arrive one window late and are summed in by eq. 8, damped
                n_dep = cur_m - new_m
                need = n_dep * tau
                if pool.shape[0] - cursor >= need:
                    with tr.span("late_delta", n_dep=n_dep, points=need):
                        late = pool[cursor: cursor + need].reshape(
                            n_dep, tau, pool.shape[-1])
                        cursor += need
                        late_pts = need
                        if self._active(cur_m):
                            w_fin = self._late_windows(
                                w_srd, late, cur_m, new_m, t0, tau=tau,
                                eps0=eps0, decay=decay)
                            w_srd = elastic_lib.merge_late_delta(
                                w_srd, torch.sum(w_srd - w_fin, dim=0),
                                delay_windows=1, gamma=self.staleness_gamma)
                        # each departing worker uploads one (kappa, d) f32
                        # delta; on a hierarchical topology they were whole
                        # host groups, so the upload crossed tier 1
                        self.transport.record_host_transfer(
                            logical_bytes=4 * w_srd.numel(),
                            wire_bytes=4 * w_srd.numel(), participants=n_dep,
                            axis=self._axis, tag="late_delta",
                            tier=1 if self._hierarchical else None)
                    if mt is not None:
                        # each departing delta lands one window stale
                        mt.counter("staleness_windows").inc(n_dep)
                        mt.counter("late_delta_points").inc(need)
                else:
                    late_skipped = True  # the pool is too dry; recorded
                    if mt is not None:
                        mt.counter("late_delta_skipped").inc()
            with tr.span("remesh", m=new_m):
                if self._active(new_m):
                    self._executor_for(new_m)
                if self.group is not None and new_m > cur_m \
                        and self._active(new_m):
                    # the joining ranks take the shared version from rank 0
                    w_srd = process_group.broadcast(
                        w_srd if self.rank == 0 else torch.empty_like(w_srd),
                        0, self._counts[new_m].span)
            if self.checkpointer is not None:
                # the post-event state: a resume from here continues bit
                # for bit
                if self.rank == 0:
                    with tr.span("checkpoint", step=window_idx):
                        t_ck = time.perf_counter()
                        self.checkpointer.save(window_idx, self._state(
                            w_srd, t0, cursor, window_idx, new_m,
                            tick_offset + self.resize_cost_ticks))
                        ckpt_s = time.perf_counter() - t_ck
                ckpt_step = window_idx
            self._drain()
        wall_s = time.perf_counter() - t_start
        if mt is not None:
            mt.counter("resize_events").inc()
            mt.histogram("resize_wall_s").observe(wall_s)
        self.resize_events.append(ResizeStats(
            window=window_idx, old_m=cur_m, new_m=new_m,
            tp_preserved=plan.tp_preserved, late_points=late_pts,
            checkpoint_step=ckpt_step, wall_s=wall_s,
            late_skipped=late_skipped, cause=cause, checkpoint_s=ckpt_s))
        return w_srd, new_m, cursor
