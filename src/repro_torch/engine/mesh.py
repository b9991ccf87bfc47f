"""``MeshExecutor``: the paper's schemes with the workers stacked on one card.

Counterpart of ``repro/engine/mesh.py`` for ``average`` (eq. 3), ``delta``
(eq. 8) and ``async_delta`` (eq. 9).  The reference shards one worker per
device and merges with collectives; here the M workers are the leading
dimension of the codebook tensor ``(M, kappa, d)``, one kernel launch runs
every worker's window (or tick), and the merge is a reduction over that
dimension through the executor's ``Transport``, which records the wire
bytes a ring all-reduce among M devices would move.

The inner loop (``_local_window``) has the reference's three routes:

  * the window kernel, one launch per window, when ``fused`` is on and the
    codebook fits (``ops.window_fits``);
  * the per-step loop through ``ops.vq_delta_routed`` (the delta kernel, or
    past its shared memory the blocked kernel, or with ``fused`` off there
    the assign kernel and an ``index_add_``), with the eq.-1 update in
    PyTorch, when ``fused`` is off or the window kernel does not fit;
  * the per-step loop through ``core.vq.H``, when ``use_kernels`` is off.

``smem_budget_bytes`` is the reference's ``vmem_budget_bytes``: the budget
the window and delta kernels must fit (``ops.smem_budget_bytes``), so a
small one sends the sync loop and the eq.-9 tick through the blocked
kernel at any width.  On the CPU the kernels' plain versions stand in, and
all three routes give the same codebooks bit for bit; on the card the
first two do (the kernels share their distance routine).

After every window the shared codebook is scored by eq. 2: the mean over
workers of ``vq.distortion`` on each worker's eval points, reduced through
the transport with tag ``"eval"``.

The merge runs on the executor's transport: the dense ``XlaTransport`` by
default, the dense ``RingTransport`` (the ring kernel), the top-k
``SparseTransport`` (``transport="sparse"`` or an instance with its
``frac``), or a ``QuantizedTransport`` over any of them.  A stateful
transport's state (the sparse or quantization residual, f32 (M, kappa, d)
on the device) is made once per run and threaded window by window, or tick
by tick for eq. 9, as the reference threads it through its scans.  With
``use_kernels`` off the transport's kernels are their plain versions too
(``Transport.plain``).

The merge override (``merge=``) swaps the delta scheme's merge for the
straggler-tolerant ``QuorumMerge`` (``quorum_frac``; each window's late
bits are a column of the network's ``late_matrix``, drawn once for the run
and moved to the device once) or the divergence-triggered ``DynamicMerge``
(``divergence_thresh``, ``max_stale``; the trigger bits stay on the device
until the loop ends, are read once, and the merge records are re-priced
to the windows that merged through ``CommLog.rewrite_since``).  Both merge
eq.-8 displacements and refuse any other scheme.

A ``topology=`` splits the workers into host groups for a
``HierarchicalTransport``, which must carry the same topology; the merge
wire is then charged per tier, each at its link class's bandwidth
(``NetworkModel.transfer_ticks(tier=)``).  A ``tier1_controller=``
(``Tier1BudgetController``) runs the sync loop in chunks of
``publish_every`` windows, the merge state threaded across them, and
re-sizes the sparse tier's ``frac`` between chunks from the chunk's
measured tier-1 bytes; ``last_tier1_fracs`` keeps the value after each
chunk.  An ``on_window(windows_done, w_shared)`` hook rides the same
chunks (a ``CodebookStore.publisher()``, or the elastic executor's
periodic checkpoint), and fires once after an eq.-9 run; a hook that reads
``w_shared`` on the host syncs the card once a chunk.  ``run_segment`` is
the elastic executor's sync run from a global step ``t0``.

The async scheme (``_run_async``, the reference's ``mesh.py:812-915``) has
no window: every tick each worker takes one eq.-1 step at batch 1 (through
``ops.vq_delta_routed``, or ``vq.H`` with ``use_kernels`` off), then the
in-flight displacements of the workers whose round completes land on the
shared version through ``Transport.masked_all_reduce``.  The completion
schedule is one (n, M) mask made from the round lengths before the loop
starts (``core.async_vq.done_mask``), so no tick waits on the host; the
shared version is scored every ``eval_every`` ticks as the loop passes
them.

``tracer=`` / ``metrics=`` (``repro_torch.obs``) observe a run as the
reference's executor does: wall spans ``run``, ``segment`` and, on the
chunked path, ``chunk``; the modeled per-worker tick timeline (``window``,
``compute`` and ``merge`` spans by tier for the sync schemes, ``round``,
``compute`` and ``merge`` for eq. 9); the ``distortion``,
``codebook_divergence``, ``divergence_trigger``, ``tier1_frac`` and
``chaos_late_workers_per_window`` counter series and the ``chaos_*`` fault
spans; and the metrics ``run_wall_s``, ``windows_total``,
``async_rounds_total``, ``merge_wire_bytes``, ``divergence_trigger``,
``merge_skipped_total``, ``chaos_*``, the ``distortion`` histogram, the
``codebook_divergence`` and ``tier1_frac`` gauges, and the transport log's
``comm_*`` counters.  An observed sync window also reduces each worker's
divergence ``||w_local - w_shared||^2`` (one launch of the divergence
kernel, ``ops.vq_divergence``) beside its distortion on the one "eval"
collective (a tuple payload, so the distortion's reduction is the bare
run's and the curve keeps its bits), in the bare run's loop order.
Everything else is emitted after the run from the curve, the trigger bits, the late matrix and the
tick arithmetic, which are read from the device once; the loops hold no
device read and no counter update.  The tick timeline and the counter
series are recorded with ``Tracer.add_spans`` / ``add_counters``, built
when the trace is read, and the histograms and gauges take a run's values
at once (``observe_many``, ``set_many``).  The reference's
``compile`` span has no counterpart: eager PyTorch compiles no program.

Measured phases (the port's own; ``obs.trace.PhaseClock``): a run is timed
when the tracer is enabled, a profiler is attached or a ``torch.profiler``
is active (``torch.autograd._profiler_enabled()``, read once a ``run`` or
``run_segment``).  A timed loop calls each phase's first function through a
wrapper that marks the phase's start with a CUDA event on the current
stream (``time.perf_counter_ns`` on the CPU) and, under a
``torch.profiler``, opens its range ``repro_torch.local`` / ``.merge`` /
``.eval``: ``local`` is the window kernel (``_local_window``), or eq. 9's
step and its epilogue from ``_h`` on; ``merge`` the strategy's merge
through the transport (the dynamic probe and the quorum's late bits
included), or eq. 9's ``masked_all_reduce`` and the where-updates after
it; ``eval`` is ``_eval``.  So a window takes 3 events and a tick 2 or 3,
each phase ending where the next begins.  An untimed loop binds the
functions themselves: no event, no range, no test a step.  Timing turns no
observation on (no divergence kernel, no tuple eval), launches nothing,
adds no sync and reads nothing inside the loop; its cost is host time, a
few microseconds a mark (``obs/trace.py``), which shows on the device only
where the host sets the pace.  After the run's closing drain the marks are
read into the module's counters ``phase_ns_local``, ``phase_ns_merge``,
``phase_ns_eval`` (nanoseconds, each phase's idle time included) and
``phase_steps`` (windows or ticks timed), which the benchmark reads, into
the tracer's ``"device"`` spans (``local_phase``, ``merge_phase``,
``eval_phase``, attrs ``step`` and ``run``) placed through an anchor event
recorded right after the opening drain, and into the profiler's
``measured_s``.  A segment has no drain of its own: its marks wait for its
caller's (``read_phases``, which ``ElasticMeshExecutor.run`` calls after
its closing drain), and its anchor follows no drain, so its spans may sit
early by the work queued at its start.  On the card the device spans of a
``run`` may end after its host ``run`` span, by the launches the host
queued ahead.  The counters are no ``MetricsRegistry`` entries: the
registry's names are the reference's.

One worker a process (``group=``): each rank of a process group runs one
worker (``distributed.process_group``; gloo on the CPU, NCCL or gloo on the
card).  Every rank gets the same global inputs and keeps only its own
worker's rows, ``data[i]``, on its device; its window is the window kernel
at ``(1, tau, d)`` (the thread runtime's launch), an eq.-9 tick one delta
launch at ``(1, 1)`` and the masked reduce with its entry of the shared
late matrix, and the merge and the eval reduce run over the group's
transport (``XlaTransport(group=)``, ``RingTransport(group=)``,
``SparseTransport(group=)``, a ``QuantizedTransport`` over any of them, or,
over ``Topology.make_groups``' groups, tier 0 inside my host and tier 1,
dense or sparse, across hosts).  ``group`` is a flat ``ProcessGroup`` or a
``topology.Groups``; ``transport`` a name (``"xla"``, ``"ring"`` or
``"sparse"``) or a transport built over those groups.  ``run`` returns the
same curve, ``w_shared`` and ``last_comm`` on every rank, its wall between
a ``device.synchronize`` and a group barrier at each end.  Everything the
stacked run takes runs here too: the quorum merge
(this rank's row of the shared late matrix, the quorum counted on the
group's size), the dynamic merge (the probe a (1,) payload reduced over
the group, so every rank reads the same trigger bits), the tier-1
controller (it prices the chunk's ``CommLog`` bytes, shape arithmetic equal
on every rank, so every rank sets the same ``frac``), ``ChaosNetwork``
(kills as a worker late for ever, as on stacked workers) and ``tracer`` /
``metrics`` / ``profiler``: every rank observes its run, whose modeled
timeline, counters and metrics are the stacked run's (the M workers'
tracks, from the shared late matrix and round lengths), and an observed
window launches the divergence kernel at (1, kappa, d) and reduces
(distortion, divergence) on the one "eval" record.  The profiler's terms
are per card: ``workers_per_device`` is the number of ranks sharing this
rank's device (``process_group.ranks_per_device``).  Elastic segments
(``run_segment``) run over the count's groups as on stacked workers
(``ElasticMeshExecutor(group=)``).

``profiler=`` (``obs.Profiler``) attributes each run's wall to compute,
memory, collective and host terms per window, as the reference's does.  A
profiler turns observation on, as in the reference, whose profiled program
is the observed one: a profiled sync window launches the divergence kernel
too.  A program key (the scheme, the inner loop's route, the transport,
the topology and the shapes) is recorded with its ``CommRecord``s and
loops on the executor's first run of it; each ``_run_sync`` or eq.-9 run
notes one segment, with the M stacked workers sharing the device; eq. 9 is
attributed against the nominal ``n // tau`` windows, its eval folded in as
an effective per-window ``n_eval``.  ``run``'s wall, which ``run_wall_s``
and the profiler read, starts and ends with the device drained
(``device.synchronize``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time

import numpy as np
import torch

from repro_torch import comm
from repro_torch import device as device_lib
from repro_torch.core import async_vq, vq
from repro_torch.core.schemes import SchemeResult
from repro_torch.engine import api
from repro_torch.engine import merge as merge_lib
from repro_torch.engine.network import GeometricDelayNetwork, NetworkModel
from repro_torch.kernels import ops, vq_fused
from repro_torch.obs import (NULL_TRACER, PHASES, CounterEvent,
                             MetricsRegistry, PhaseClock, SpanEvent, Tracer)
from repro_torch.topology import Topology

# the measured phases of every timed run in this process (see the module
# docstring): nanoseconds from each phase's opening mark to its closing one
# on the device's clock, and the windows or ticks timed
_phase_lock = threading.Lock()
phase_ns_local = 0
phase_ns_merge = 0
phase_ns_eval = 0
phase_steps = 0


def _count_phases(ns: dict, steps: int) -> None:
    global phase_ns_local, phase_ns_merge, phase_ns_eval, phase_steps
    with _phase_lock:
        phase_ns_local += ns["local"]
        phase_ns_merge += ns["merge"]
        phase_ns_eval += ns["eval"]
        phase_steps += steps


def _over(name: str, group, frac: float) -> comm.Transport:
    """Transport ``name`` over ``group``: ``"xla"``, ``"ring"`` or
    ``"sparse"`` (at ``frac``)."""
    if name == "sparse":
        return comm.SparseTransport(frac, group=group)
    if name not in ("xla", "ring"):
        raise ValueError(f"unknown transport {name!r}; over a process "
                         f"group choose 'xla', 'ring' or 'sparse'")
    cls = comm.RingTransport if name == "ring" else comm.XlaTransport
    return cls(group=group)


def process_transport(transport, groups, topology=None, *,
                      tier1: str | None = None, frac: float = 0.01,
                      tier1_frac: float = 0.01):
    """The transport of a process-mode run: a name (``"xla"``, ``"ring"``,
    ``"sparse"`` at ``frac``) built over the group(s), over
    ``Topology.make_groups``' two tiers for a hierarchical topology (tier 1
    over ``tier1``, by default the same name, a sparse one at
    ``tier1_frac``), or a transport whose collectives already carry
    groups."""
    from repro_torch.topology import Groups
    if isinstance(transport, str) or transport is None:
        name = transport or "xla"
        if isinstance(groups, Groups) and len(groups.axes) == 2:
            return comm.HierarchicalTransport(
                _over(name, groups.group(topology.worker_axis), frac),
                _over(tier1 or name, groups.group(topology.host_axis),
                      tier1_frac),
                topology=topology)
        group = (groups.group(groups.axes[0]) if isinstance(groups, Groups)
                 else groups)
        return _over(name, group, frac)
    inner = getattr(transport, "inner", transport)
    tiers = ((inner.tier0, inner.tier1)
             if isinstance(inner, comm.HierarchicalTransport) else (inner,))
    for t in tiers:
        if getattr(t, "group", None) is None:
            raise ValueError(
                "a process-mode transport reduces over process groups: "
                "build it with group= (or pass 'xla' / 'ring')")
    return transport


def _hier_of(transport: comm.Transport):
    """The ``HierarchicalTransport`` under transport (a quantized wire is
    transparent), or None."""
    transport = getattr(transport, "inner", transport)
    return (transport if isinstance(transport, comm.HierarchicalTransport)
            else None)


class MeshExecutor:
    """M workers stacked on one device, merged through a transport."""

    name = "mesh"

    def __init__(self, network: NetworkModel | None = None, *,
                 transport: comm.Transport | str | None = None,
                 use_kernels: bool = True, fused: bool = True,
                 eval_every: int = 10,
                 smem_budget_bytes: int | None = None,
                 merge: str | None = None, quorum_frac: float = 0.6,
                 staleness_gamma: float = 0.5,
                 divergence_thresh: float = 0.0, max_stale: int = 8,
                 topology: Topology | None = None,
                 tier1_controller=None, publish_every: int = 1,
                 on_window=None,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 profiler=None,
                 group=None,
                 device: str | torch.device | None = None):
        if merge not in (None, "quorum", "dynamic"):
            raise ValueError(
                f"merge override must be None (scheme default), 'quorum', "
                f"or 'dynamic', got {merge!r}")
        if not 0.0 < quorum_frac <= 1.0:
            raise ValueError(
                f"quorum_frac must be in (0, 1], got {quorum_frac}")
        if divergence_thresh < 0.0:
            raise ValueError(
                f"divergence_thresh must be >= 0, got {divergence_thresh}")
        if max_stale < 1:
            raise ValueError(f"max_stale must be >= 1, got {max_stale}")
        if publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, "
                             f"got {publish_every}")
        self.network = network or GeometricDelayNetwork()
        # one worker a process: this rank's worker index among the group's
        # M, and the group's topology (see the module docstring)
        self.group = group
        self.worker = None
        if group is not None:
            topology = self._process_mode(group, topology)
            transport = process_transport(transport, group, topology)
        # use_kernels=False is the reference's use_pallas=False: the plain
        # vq.H step, and the transport's plain selection.  fused=False keeps
        # the per-step loop (and past the delta kernel's budget the assign
        # kernel + index_add_ route) as the comparator of the window and
        # blocked kernels; all give the same codebooks.
        self.transport = comm.get_transport(
            transport if transport is not None else "xla")
        if not use_kernels:
            self.transport = self.transport.plain()
        hier = _hier_of(self.transport)
        if hier is not None:
            if topology is not None and topology != hier.topology:
                raise ValueError(
                    f"topology {topology.describe()} differs from the "
                    f"hierarchical transport's {hier.topology.describe()}; "
                    f"configure one place only")
            topology = hier.topology
        self.topology = topology
        # merge override: None = the scheme's own strategy; "quorum" and
        # "dynamic" replace the delta scheme's (see the module docstring)
        self.merge = merge
        self.quorum_frac = quorum_frac
        self.staleness_gamma = staleness_gamma
        self.divergence_thresh = divergence_thresh
        self.max_stale = max_stale
        self.tier1_controller = tier1_controller
        self.publish_every = publish_every
        # on_window(windows_done, w_shared) fires after every chunk of
        # publish_every sync windows, and once after an eq.-9 run
        self.on_window = on_window
        # of the last run: the sparse tier's frac after each chunk, the
        # dynamic merge's trigger bit of each window (a host tensor), the
        # quorum merge's late worker-windows
        self.last_tier1_fracs: list[float] = []
        self.last_triggers: torch.Tensor | None = None
        self.last_late_worker_windows = 0
        self.use_kernels = use_kernels
        self.fused = fused
        # None: REPRO_SMEM_BUDGET_BYTES or the H100's (ops.smem_budget_bytes)
        self.smem_budget_bytes = smem_budget_bytes
        # the async scheme scores the shared version every eval_every ticks
        self.eval_every = eval_every
        self.device = device_lib.resolve(device)
        # comm summary of the most recent run() (CommLog.summarize dict)
        self.last_comm: dict | None = None
        # observability (see the module docstring): the transport log's
        # records are mirrored onto the registry at the end of each run
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        if metrics is not None:
            self.transport.log.attach_metrics(metrics)
        # a sync run's chunks as (emit function, its arguments), emitted
        # once the run's loop is done
        self._pending_obs: list = []
        # roofline attribution (see the module docstring), and the program
        # keys this executor has run, whose records the profiler holds
        self.profiler = profiler
        self._programs: set = set()
        # the running run's PhaseClock, None when it is not timed; timed
        # segments whose marks wait for the caller's drain (read_phases)
        self._clock: PhaseClock | None = None
        self._unread: list[PhaseClock] = []

    def _process_mode(self, group, topology) -> Topology | None:
        """Check a process-mode grid, set ``self.worker``; returns the run's
        topology (None when flat)."""
        from repro_torch.distributed import process_group
        from repro_torch.topology import Groups
        if isinstance(group, Groups):
            if len(group.axes) == 1:
                self.worker = group.coords[0]
                topo = Topology.flat(group.shape[0],
                                     worker_axis=group.axes[0])
            elif len(group.axes) == 2:
                hosts, wph = group.shape
                topo = Topology.simulate(hosts, wph, host_axis=group.axes[0],
                                         worker_axis=group.axes[1])
                self.worker = group.coords[0] * wph + group.coords[1]
            else:
                raise ValueError(
                    f"a worker grid is (workers,) or (hosts, workers), got "
                    f"axes {group.axes}")
            if topology is not None and topology != topo:
                raise ValueError(
                    f"topology {topology.describe()} differs from the "
                    f"groups' {topo.describe()}")
            return None if topo.is_flat else topo
        if topology is not None and not topology.is_flat:
            raise ValueError("a hierarchical process-mode run takes the "
                             "groups of Topology.make_groups as group=")
        self.worker = process_group.group_rank(group)
        return None

    @property
    def _observe(self) -> bool:
        return (self.tracer.enabled or self.metrics is not None
                or self.profiler is not None)

    @property
    def _topology_label(self) -> str:
        """'flat', or the host groups' 'HxW'."""
        return "flat" if self.topology is None else self.topology.describe()

    def _route(self, kappa: int, d: int, *, window: bool) -> str:
        """The inner loop's route, a program key's part: "plain" with the
        kernels off, "window" where ``_local_window`` takes the window
        kernel, else the per-step ``ops.delta_route``."""
        if not self.use_kernels:
            return "plain"
        if window and self.fused and ops.window_fits(
                kappa, d, budget_bytes=self.smem_budget_bytes):
            return "window"
        return ops.delta_route(d, budget_bytes=self.smem_budget_bytes,
                               fused=self.fused)

    def _profile(self, key: tuple, records, loops, **shapes) -> None:
        """Record ``key``'s program on its first run here, and note the
        segment: the M stacked workers share the device, or, one worker a
        process, the ranks on this rank's device."""
        fresh = key not in self._programs
        if fresh:
            self._programs.add(key)
            self.profiler.record_program(key, records, loops)
        if self.worker is None:
            per_device = shapes["m"]
        else:
            from repro_torch.distributed import process_group
            per_device = process_group.ranks_per_device()
            shapes = {**shapes, "m": self._process_workers()}
        self.profiler.note_segment(
            program=key, transport=self.transport.name,
            topology=self._topology_label, compiled=fresh,
            workers_per_device=per_device, **shapes)

    def _workers_of(self, m: int) -> int:
        """The run's worker count: ``m`` stacked rows, or the process
        group's workers (one a rank, this rank's one row)."""
        return m if self.worker is None else self._process_workers()

    def _local_window(self, w0: torch.Tensor, zwin: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
        """tau sequential eq.-1 steps for every worker from the shared w0
        (kappa, d) over zwin (M, tau, d); returns (M, kappa, d)."""
        zwin = zwin.contiguous()
        if self.use_kernels:
            return ops.window_routed(zwin, w0, eps,
                                     budget_bytes=self.smem_budget_bytes,
                                     fused=self.fused)
        m, tau, d = zwin.shape
        w = w0.expand(m, *w0.shape).contiguous()
        for s in range(tau):
            w = w - eps[s] * self._h(zwin[:, s], w)
        return w

    def _h(self, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Eq. (4)'s H(z, w) for every worker: z (M, d), w (M, kappa, d)."""
        if not self.use_kernels:
            return vq.H(z, w)
        # a batch of one point per worker, so counts/zsum reduce exactly to
        # H(z, w)
        counts, zsum = ops.vq_delta_routed(
            z.unsqueeze(1).contiguous(), w,
            budget_bytes=self.smem_budget_bytes, fused=self.fused)
        return counts.unsqueeze(-1) * w - zsum

    def _run_async(self, w0: torch.Tensor, data: torch.Tensor,
                   eval_data: torch.Tensor, *, tau: int, eps0: float,
                   decay: float, lengths: torch.Tensor) -> SchemeResult:
        """Eq. (9), tick by tick; the where-updates follow the reference's
        ``mesh.py:834-866`` line for line."""
        m, n, _ = data.shape
        kappa, d = w0.shape
        dones = async_vq.done_mask(lengths, lengths.shape[0], n, tau,
                                   self.device)
        if self.worker is not None:
            # this rank's column of the shared completion schedule
            dones = dones[:, self.worker:self.worker + 1].contiguous()
        dones_f = dones.to(torch.float32)
        eps_all = vq.default_steps(torch.arange(1, n + 1, device=self.device),
                                   eps0=eps0, decay=decay)
        mark = self.transport.log.mark()
        w = w0.expand(m, kappa, d).contiguous()
        w_srd, snap = w0, w.clone()
        dcur = torch.zeros_like(w)
        dinf = torch.zeros_like(w)
        comm_state = self.transport.init_state(dinf)
        curve = []
        # a timed run marks each phase's start at its first call
        h, masked, evaluate = (self._h, self.transport.masked_all_reduce,
                               self._eval)
        clock = self._clock
        if clock is not None:
            h, masked, evaluate = (clock.before("local", h),
                                   clock.before("merge", masked),
                                   clock.before("eval", evaluate))
        for t in range(n):
            # local VQ step on every worker (1st line of eq. 9)
            step = eps_all[t] * h(data[:, t], w)
            w_tmp = w - step
            dcur = dcur + step
            # masked merge: only completing workers' in-flight deltas land
            # on the shared version (4th line)
            landed, comm_state = masked(
                dinf, dones_f[t], state=comm_state, tag="merge")
            w_srd = w_srd - landed
            # completed: adopt the downloaded snapshot and replay the local
            # delta (3rd line); the others keep the plain step (2nd line)
            mask = dones[t][:, None, None]
            w = torch.where(mask, snap - dcur, w_tmp)
            snap = torch.where(mask, w_srd, snap)
            dinf = torch.where(mask, dcur, dinf)
            dcur = dcur.masked_fill(mask, 0.0)
            if (t + 1) % self.eval_every == 0:
                curve.append(evaluate(eval_data, w_srd))
        if clock is not None:
            clock.close()
        if self.profiler is not None:
            # no window barrier: the nominal n // tau windows, the eval
            # folded in as an effective per-window n_eval
            nominal = max(n // tau, 1)
            self._profile(
                ("async", self._route(kappa, d, window=False),
                 self.transport.name, self._topology_label, tuple(w0.shape),
                 tuple(data.shape), tuple(eval_data.shape), tau,
                 self.eval_every),
                self.transport.log.since(mark), [("tick", n)],
                scheme="async_delta", m=m, n_windows=nominal, d=d,
                kappa=kappa, tau=tau,
                n_eval=int(eval_data.shape[1] * len(curve) / nominal))
        ticks = async_vq.eval_ticks(n, self.eval_every) + 1
        res = SchemeResult(
            w_shared=w_srd, wall_ticks=ticks.to(torch.int32),
            distortion=torch.stack(curve) if curve else torch.zeros(0))
        if self._observe:
            self._emit_async_obs(m=self._workers_of(m), n=n, tau=tau,
                                 lengths=lengths,
                                 ticks=ticks, curve=res.distortion,
                                 tier_wire=self._tier_wire(mark,
                                                           ("merge",)))
        return res

    def _eval(self, eval_data: torch.Tensor, w_srd: torch.Tensor,
              w_fin: torch.Tensor | None = None):
        """Eq. 2 of the shared codebook: the mean over workers, reduced
        through the transport with tag "eval".  Given the workers' window
        results ``w_fin`` (M, kappa, d) (an observed sync run), also the
        mean of their divergence ``||w_fin - w_srd||^2``, on the same
        collective: returns ``(distortion, divergence)``."""
        if w_fin is None:
            return self.transport.all_reduce(vq.distortion(eval_data, w_srd),
                                             op="mean", tag="eval")[0]
        div = (ops.vq_divergence(w_fin, w_srd)
               if self.use_kernels
               else vq_fused.vq_divergence_plain(w_fin, w_srd))
        dist = vq.distortion(eval_data, w_srd)
        return self.transport.all_reduce((dist, div), op="mean",
                                         tag="eval")[0]

    def _inputs(self, scheme: str, w0, data, eval_data, tau: int):
        """Validate a run's inputs; returns them as f32 contiguous tensors
        on the executor's device."""
        api.validate_scheme(scheme)
        if data.dim() != 3:
            raise ValueError(f"data must be (M, n, d), got {tuple(data.shape)}")
        if eval_data.dim() != 3 or eval_data.shape[0] != data.shape[0]:
            raise ValueError(
                f"eval_data must be (M, n_eval, d) with the same M as data; "
                f"got {tuple(eval_data.shape)} vs M={data.shape[0]}")
        if w0.dim() != 2 or w0.shape[1] != data.shape[2]:
            raise ValueError(
                f"w0 must be (kappa, d={data.shape[2]}), got {tuple(w0.shape)}")
        m, n, _ = data.shape
        if n // tau == 0:
            raise ValueError(f"need at least one tau={tau} window, got n={n}")
        if self.topology is not None and m != self.topology.total_workers:
            raise ValueError(
                f"data has M={m} worker streams but the topology "
                f"{self.topology.describe()} holds "
                f"{self.topology.total_workers} workers")
        if self.merge is not None and scheme != "delta":
            self._strategy(scheme)             # raises: delta only
        if self.worker is not None:
            if m != self._process_workers():
                raise ValueError(
                    f"data has M={m} worker streams; the process group "
                    f"runs {self._process_workers()} workers, one a rank")
            # this rank's worker only: its rows go to its device
            data = data[self.worker:self.worker + 1]
            eval_data = eval_data[self.worker:self.worker + 1]
        return tuple(x.to(self.device, torch.float32).contiguous()
                     for x in (w0, data, eval_data))

    def _process_workers(self) -> int:
        """The process group's worker count M (one a rank)."""
        from repro_torch.topology import Groups
        if isinstance(self.group, Groups):
            return math.prod(self.group.shape)
        from repro_torch.distributed import process_group
        return process_group.group_size(self.group)

    def _drain(self) -> None:
        """Wait for the device and, in process mode, for every rank."""
        device_lib.synchronize(self.device)
        if self.worker is not None:
            from repro_torch.distributed import process_group
            process_group.barrier(self._barrier_group())

    def _barrier_group(self):
        from repro_torch.topology import Groups
        if not isinstance(self.group, Groups):
            return self.group
        return None if len(self.group.axes) == 2 else self.group.groups[0]

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        m_all = data.shape[0]
        w0, data, eval_data = self._inputs(scheme, w0, data, eval_data, tau)
        m, n, _ = data.shape
        # the wall starts and ends with the device drained (and, one worker
        # a process, every rank there): on the card the host queues
        # launches ahead of them
        self._drain()
        clock = self._start_clock(step0=0)
        t_wall = time.perf_counter()
        try:
            with self.tracer.span("run", scheme=scheme, executor=self.name,
                                  m=m, transport=self.transport.name):
                if scheme != "async_delta":
                    res = self._sync(scheme, w0, data, eval_data, tau=tau,
                                     eps0=eps0, decay=decay, t0=0)
                else:
                    lengths = api.async_lengths(self.network, m_all, n, tau,
                                                generator=generator,
                                                lengths=lengths)
                    mark = self.transport.log.mark()
                    try:
                        res = self._run_async(w0, data, eval_data, tau=tau,
                                              eps0=eps0, decay=decay,
                                              lengths=lengths)
                    finally:
                        self.last_comm = comm.CommLog.summarize(
                            self.transport.log.since(mark))
                        self.transport.log.mirror_metrics()
                    if self.on_window is not None:
                        self.on_window(n // tau, res.w_shared)
        finally:
            self._stop_clock(clock)
        self._drain()
        wall_s = time.perf_counter() - t_wall
        if clock is not None:
            self._read_clock(clock)
        if self.metrics is not None:
            self.metrics.histogram("run_wall_s", executor=self.name,
                                   scheme=scheme).observe(wall_s)
        if self.profiler is not None:
            self.profiler.finish_run(wall_s)
        return res

    def run_segment(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
                    eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
                    decay: float = 1.0, t0: int = 0) -> SchemeResult:
        """One elastic segment (``ElasticMeshExecutor``): ``run`` for the
        sync schemes, the step schedule continuing from step ``t0``, so a
        resized run keeps the eps_t sequence a fixed-M run sees, and the
        quorum merge's late bits keyed by global window ``t0 // tau``.  The
        merge state starts fresh, as the reference's does."""
        if scheme == "async_delta":
            raise ValueError(
                "elastic segments support the synchronous schemes "
                "('average', 'delta'); async_delta has no window barrier "
                "to resize at")
        w0, data, eval_data = self._inputs(scheme, w0, data, eval_data, tau)
        clock = self._start_clock(step0=t0 // tau)
        try:
            with self.tracer.span("segment", scheme=scheme, m=data.shape[0],
                                  t0=t0):
                res = self._sync(scheme, w0, data, eval_data, tau=tau,
                                 eps0=eps0, decay=decay, t0=t0)
        finally:
            self._stop_clock(clock)
        if clock is not None:
            # no drain of its own: the caller reads the marks after its own
            self._unread.append(clock)
        return res

    def read_phases(self) -> None:
        """Read the timed segments' marks (``run_segment``); call once the
        device has drained, as ``ElasticMeshExecutor.run`` does at its
        end."""
        unread, self._unread = self._unread, []
        for clock in unread:
            self._read_clock(clock)

    # -- measured phases (see the module docstring) --------------------------

    def _start_clock(self, *, step0: int) -> PhaseClock | None:
        """The run's ``PhaseClock`` and its anchor, when the run is timed:
        the tracer is enabled, a profiler attached or a ``torch.profiler``
        active."""
        profiled = torch.autograd._profiler_enabled()
        if not (self.tracer.enabled or self.profiler is not None
                or profiled):
            return None
        self._clock = PhaseClock(self.device, self.tracer, step0=step0,
                                 ranges=profiled)
        return self._clock

    def _stop_clock(self, clock: PhaseClock | None) -> None:
        self._clock = None
        if clock is not None:
            clock.close()

    def _read_clock(self, clock: PhaseClock) -> None:
        """The drained run's phases into the module's counters, the
        tracer's ``"device"`` spans and the profiler's ``measured_s``."""
        phases = clock.phases()
        ns = dict.fromkeys(PHASES, 0)
        for phase, _, _, dur in phases:
            ns[phase] += dur
        _count_phases(ns, clock.steps)
        if self.tracer.enabled:
            runs = self.tracer.opened("run")
            self.tracer.add_spans(len(phases), functools.partial(
                clock.spans, phases, runs - 1 if runs else None))
        if self.profiler is not None:
            self.profiler.note_phases({k: v / 1e9 for k, v in ns.items()})

    def _sync(self, scheme: str, w0, data, eval_data, *, tau: int,
              eps0: float, decay: float, t0: int) -> SchemeResult:
        """A sync run from step ``t0``, chunked when a hook or the tier-1
        controller needs the chunk barriers; sets ``last_comm`` and, when
        observed, emits the chunks' spans and metrics after the loop."""
        m = data.shape[0]
        strategy = self._strategy(scheme)
        log = self.transport.log
        mark = log.mark()
        state = strategy.init_state(w0.expand(m, *w0.shape))
        self.last_tier1_fracs = []
        self.last_triggers = None
        self.last_late_worker_windows = 0
        self._pending_obs = []
        try:
            if self.tier1_controller is None and self.on_window is None:
                res, _ = self._run_sync(strategy, w0, data, eval_data,
                                        tau=tau, eps0=eps0, decay=decay,
                                        t0=t0, state=state)
            else:
                res = self._run_sync_published(strategy, w0, data, eval_data,
                                               tau=tau, eps0=eps0,
                                               decay=decay, t0=t0,
                                               state=state)
        finally:
            self.last_comm = comm.CommLog.summarize(log.since(mark))
            log.mirror_metrics()
        for emit, kwargs in self._pending_obs:
            emit(**kwargs)
        self._pending_obs = []
        return res

    def _strategy(self, scheme: str) -> merge_lib.MergeStrategy:
        if self.merge is None:
            return merge_lib.get_merge(scheme, transport=self.transport)
        if scheme != "delta":
            raise ValueError(
                f"the {self.merge} merge folds eq.-8 displacements, so it "
                f"rides scheme 'delta' only; got scheme {scheme!r}")
        if self.merge == "quorum":
            return merge_lib.get_merge(
                "quorum", transport=self.transport,
                quorum_frac=self.quorum_frac, gamma=self.staleness_gamma)
        return merge_lib.get_merge(
            "dynamic", transport=self.transport,
            thresh=self.divergence_thresh, gamma=self.staleness_gamma,
            max_stale=self.max_stale)

    def _run_sync(self, strategy, w0, data, eval_data, *, tau: int,
                  eps0: float, decay: float, t0: int, state
                  ) -> tuple[SchemeResult, object]:
        """The sync windows of data (M, n, d) from the shared w0, the step
        schedule continuing from step ``t0``; returns ``(result, the merge
        state after them)``."""
        m, n, _ = data.shape
        observe = self._observe
        n_windows = n // tau
        quorum = isinstance(strategy, merge_lib.QuorumMerge)
        dynamic = isinstance(strategy, merge_lib.DynamicMerge)
        # every window's step sizes at once: eps_t for t = t0+1 .. t0+n
        eps_all = vq.default_steps(
            torch.arange(t0 + 1, t0 + n_windows * tau + 1,
                         device=self.device), eps0=eps0, decay=decay)
        late = late_np = None
        if quorum:
            # the (M, n_windows) lateness bits, keyed by global window, drawn
            # on the host once and moved to the device once; one worker a
            # process keeps its row of the matrix every rank draws
            late_np = np.asarray(self.network.late_matrix(
                self._workers_of(m), n_windows, tau, window0=t0 // tau),
                np.float32)
            self.last_late_worker_windows += int(late_np.sum())
            rows = (late_np if self.worker is None
                    else late_np[self.worker:self.worker + 1])
            late = torch.from_numpy(np.ascontiguousarray(rows)).to(
                self.device)
        log = self.transport.log
        mark = log.mark()
        w_srd, curve, trigs, divs = w0, [], [], []
        # a timed run marks each phase's start at its first call
        local, merge, evaluate = self._local_window, strategy, self._eval
        clock = self._clock
        if clock is not None:
            local, merge, evaluate = (clock.before("local", local),
                                      clock.before("merge", merge),
                                      clock.before("eval", evaluate))
        for i in range(n_windows):
            span = slice(i * tau, (i + 1) * tau)
            w_fin = local(w_srd, data[:, span], eps_all[span])
            if quorum:
                w_srd, state = merge(w_srd, w_fin, state=state,
                                     late=late[:, i])
            else:
                w_srd, state = merge(w_srd, w_fin, state=state)
            if dynamic:
                trigs.append(strategy.last_trigger)
            if observe:
                c, dv = evaluate(eval_data, w_srd, w_fin)
                divs.append(dv)
            else:
                c = evaluate(eval_data, w_srd)
            curve.append(c)
        if clock is not None:
            clock.close()
        # every merge override rides the delta scheme
        scheme = ("average" if isinstance(strategy, merge_lib.AverageMerge)
                  else "delta")
        if self.profiler is not None:
            # the records before the dynamic merge's re-pricing: its merge
            # ran every window, as the reference's program's does
            kappa, d = w0.shape
            self._profile(
                ("sync", scheme, self._route(kappa, d, window=True),
                 self.transport.name, self._topology_label, tuple(w0.shape),
                 tuple(data.shape), tuple(eval_data.shape), tau, self.merge,
                 self.quorum_frac, self.divergence_thresh,
                 self.staleness_gamma, self.max_stale),
                log.since(mark), [("window", n_windows), ("step", tau)],
                scheme=scheme, m=m, n_windows=n_windows, d=d, kappa=kappa,
                tau=tau, n_eval=eval_data.shape[1])
        tags = ("merge",)
        bits = None
        if dynamic:
            # the merge ran every window; re-price its records to the
            # windows whose probe triggered (the probe stays at every
            # window: it ran every window)
            bits = torch.stack(trigs).cpu()
            self.last_triggers = (bits if self.last_triggers is None
                                  else torch.cat([self.last_triggers, bits]))
            n_trig = int(bits.sum())
            tags = ("merge", "probe")

            def reprice(r):
                if r.tag != "merge" or r.calls == n_trig:
                    return r
                return (dataclasses.replace(r, calls=n_trig) if n_trig
                        else None)

            log.rewrite_since(mark, reprice)
        # each tier's bytes a window charged at its link class's bandwidth
        tier_wire = self._tier_wire(mark, tags)
        wt = self.network.window_ticks(tau)
        for tier, total in tier_wire.items():
            wt += self.network.transfer_ticks(total / n_windows, tier=tier)
        ticks = torch.arange(1, n_windows + 1, dtype=torch.int32) * wt
        curve = torch.stack(curve)
        if observe:
            self._pending_obs.append((self._emit_sync_obs, dict(
                scheme=scheme, m=self._workers_of(m), n_windows=n_windows,
                tau=tau, wt=wt,
                tier_wire=tier_wire, w_start=t0 // tau, curve=curve,
                divergence=torch.stack(divs), trig=bits)))
            if quorum:
                self._pending_obs.append((self._emit_chaos_obs, dict(
                    w_start=t0 // tau, n_windows=n_windows, wt=wt,
                    late_np=late_np)))
        return SchemeResult(w_shared=w_srd, wall_ticks=ticks,
                            distortion=curve), state

    def _tier_wire(self, mark: int, tags: tuple[str, ...]) -> dict:
        """Wire bytes (x calls) of the records since ``mark`` with one of
        ``tags``, by tier (None for a flat collective)."""
        out: dict = {}
        for r in self.transport.log.since(mark):
            if r.tag in tags:
                out[r.tier] = out.get(r.tier, 0) + r.wire_bytes * r.calls
        return out

    def _run_sync_published(self, strategy, w0, data, eval_data, *,
                            tau: int, eps0: float, decay: float, t0: int,
                            state) -> SchemeResult:
        """``_run_sync`` in chunks of ``publish_every`` windows, the merge
        state threaded across them (same numerics).  After each chunk
        ``on_window(windows done, w_shared)`` fires, then one
        ``Tier1BudgetController`` step, so the sparse tier's ``frac``
        changes only between chunks.  Nothing here waits for the card; a
        hook that reads ``w_shared`` on the host syncs it once a chunk."""
        n_windows = data.shape[1] // tau
        w, done, wt = w0, 0, None
        curves, ticks = [], []
        while done < n_windows:
            k = min(self.publish_every, n_windows - done)
            seg = data[:, done * tau:(done + k) * tau]
            cmark = self.transport.log.mark()
            with self.tracer.span("chunk", windows=k, t0=t0 + done * tau):
                res, state = self._run_sync(strategy, w, seg, eval_data,
                                            tau=tau, eps0=eps0, decay=decay,
                                            t0=t0 + done * tau, state=state)
            if wt is None:
                # the window's tick cost as the first chunk charged it
                wt = int(res.wall_ticks[0])
            curves.append(res.distortion)
            ticks.append(done * wt + res.wall_ticks)
            w = res.w_shared
            done += k
            if self.on_window is not None:
                self.on_window(done, w)
            if self.tier1_controller is not None:
                recs = self.transport.log.since(cmark)
                wire1 = sum(r.wire_bytes * r.calls for r in recs
                            if r.tag in ("merge", "probe") and r.tier == 1)
                frac = self.tier1_controller.update(self.transport, wire1 / k)
                if frac is not None:
                    self.last_tier1_fracs.append(frac)
                    if self.metrics is not None:
                        self.metrics.gauge("tier1_frac").set(frac)
                    self.tracer.counter("tier1_frac", float(frac),
                                        ts_us=float(t0 + done * tau))
        return SchemeResult(w_shared=w, wall_ticks=torch.cat(ticks),
                            distortion=torch.cat(curves))

    # -- observability: emitted after a run's loop ---------------------------

    def _emit_sync_obs(self, *, scheme: str, m: int, n_windows: int,
                       tau: int, wt: int, tier_wire: dict, w_start: int,
                       curve: torch.Tensor, divergence: torch.Tensor,
                       trig: torch.Tensor | None) -> None:
        """One sync chunk on the tick timeline and the registry, as the
        reference's ``_emit_sync_obs`` (``mesh.py:733-808``): each worker
        computes for ``tau`` ticks, then the merge takes the rest of the
        window, split across tiers by their wire bytes (1 tick = 1 us).
        Distortion and divergence are the real per-window values."""
        tr, mt = self.tracer, self.metrics
        both = torch.stack([curve, divergence]).cpu().numpy()
        curve_np, div_np = both[0], both[1]
        trig_np = None if trig is None else trig.numpy()
        n_trig = None if trig_np is None else int(trig_np.sum())
        if mt is not None:
            mt.counter("windows_total", scheme=scheme).inc(n_windows)
            if n_trig is not None:
                mt.counter("divergence_trigger", scheme=scheme).inc(n_trig)
                mt.counter("merge_skipped_total",
                           scheme=scheme).inc(n_windows - n_trig)
            mt.histogram("distortion", scheme=scheme).observe_many(curve_np)
            mt.gauge("codebook_divergence", scheme=scheme).set_many(div_np)
            for tier, total in tier_wire.items():
                mt.counter("merge_wire_bytes",
                           tier="flat" if tier is None else tier,
                           scheme=scheme).inc(total)
        if not tr.enabled:
            return
        merge_total = max(wt - tau, 0)
        wire_sum = sum(tier_wire.values()) or 1
        tier_rows = []                   # (track, tier attr, wire, dur)
        for tier, total in sorted(tier_wire.items(),
                                  key=lambda kv: (kv[0] is None,
                                                  kv[0] or 0)):
            tier_rows.append((
                "merge flat" if tier is None else f"merge tier {tier}",
                "flat" if tier is None else tier,
                int(round(total / max(n_windows, 1))),
                merge_total * (total / wire_sum)))
        process = tr.TICK_PROCESS
        trig_bits = None if trig_np is None else [bool(b) for b in trig_np]

        def build() -> list[SpanEvent]:
            out = []
            add = out.append
            tracks = [f"worker {w}" for w in range(m)]
            for wi in range(n_windows):
                win = w_start + wi
                t_start = float(win * wt)
                for worker, track in enumerate(tracks):
                    add(SpanEvent("window", t_start, float(wt), process,
                                  track, {"window": win, "worker": worker,
                                          "scheme": scheme}))
                    add(SpanEvent("compute", t_start, float(tau), process,
                                  track, {"window": win, "worker": worker}))
                t_m = t_start + tau
                tag = ({} if trig_bits is None
                       else {"triggered": trig_bits[wi]})
                for track, tier_attr, wire, dur in tier_rows:
                    add(SpanEvent("merge", t_m, max(float(dur), 0.0),
                                  process, track,
                                  {"tier": tier_attr, "wire_bytes": wire,
                                   "window": win, "scheme": scheme, **tag}))
                    t_m += dur
            return out

        tr.add_spans(n_windows * (2 * m + len(tier_rows)), build)
        series = [("distortion", curve_np), ("codebook_divergence", div_np)]
        if trig_np is not None:
            series.append(("divergence_trigger", trig_np))

        def build_counters() -> list[CounterEvent]:
            return [CounterEvent(name, float(values[wi]),
                                 float((w_start + wi) * wt + wt), process)
                    for wi in range(n_windows) for name, values in series]

        tr.add_counters(n_windows * len(series), build_counters)

    def _emit_chaos_obs(self, *, w_start: int, n_windows: int, wt: int,
                        late_np: np.ndarray) -> None:
        """Injected faults on the trace, as the reference's
        ``_emit_chaos_obs`` (``mesh.py:701-731``): one ``chaos_*`` span per
        scheduled event in this chunk's windows, each on its own track, the
        late workers of each window as a counter series, and the late
        worker-windows and per-kind event totals as metrics."""
        tr, mt = self.tracer, self.metrics
        n_late = int(late_np.sum())
        if mt is not None and n_late:
            mt.counter("chaos_late_worker_windows").inc(n_late)
        per_window = late_np.sum(axis=0)
        process = tr.TICK_PROCESS
        tr.add_counters(n_windows + 1, lambda: [
            CounterEvent("chaos_late_workers_per_window",
                         0.0 if wi < 0 else float(per_window[wi]),
                         float((w_start + wi + 1) * wt), process)
            for wi in range(-1, n_windows)])
        events_between = getattr(self.network, "events_between", None)
        if events_between is None:
            return
        for ev in events_between(w_start, w_start + n_windows):
            if mt is not None:
                mt.counter(f"chaos_{ev.kind}s").inc()
            dur = 1 if ev.kind == "kill" else ev.duration
            tr.add_span(f"chaos_{ev.kind}", float(ev.window * wt),
                        float(dur * wt),
                        track=f"chaos {ev.kind} {ev.target}@{ev.window}",
                        window=ev.window, target=ev.target, kind=ev.kind)

    def _emit_async_obs(self, *, m: int, n: int, tau: int,
                        lengths: torch.Tensor, ticks: torch.Tensor,
                        curve: torch.Tensor, tier_wire: dict) -> None:
        """The eq.-9 per-worker round timeline, as the reference's
        ``_emit_async_obs`` (``mesh.py:917-970``): round r of a worker
        computes for ``tau`` ticks and keeps computing while its upload is
        in flight, landing at ``done_at[worker, r]`` (the cumulative round
        lengths); the in-flight ``merge`` span beside the next worker's
        ``compute`` shows the overlap.  Wire bytes are the per-tick masked
        merge's charge attributed to the round."""
        tr, mt = self.tracer, self.metrics
        scheme = "async_delta"
        done_np = np.cumsum(np.asarray(lengths, np.int64), axis=1)
        curve_np = curve.cpu().numpy()
        if mt is not None:
            mt.histogram("distortion", scheme=scheme).observe_many(curve_np)
            mt.counter("async_rounds_total", scheme=scheme).inc(
                int((done_np <= n).sum()))
            for tier, total in tier_wire.items():
                mt.counter("merge_wire_bytes",
                           tier="flat" if tier is None else tier,
                           scheme=scheme).inc(total)
        if not tr.enabled:
            return
        # rounds a worker starts before tick n: round r starts where r-1
        # ended (ends clamp to n; lengths are positive, so ends increase)
        ends = np.minimum(done_np, n)
        starts = np.concatenate([np.zeros((m, 1), np.int64), ends[:, :-1]],
                                axis=1)
        n_rounds = int(((starts < n) & (ends > starts)).sum())
        process = tr.TICK_PROCESS
        tiers = list(tier_wire.items())

        def build() -> list[SpanEvent]:
            out = []
            add = out.append
            for worker in range(m):
                track = f"worker {worker}"
                prev = 0
                for r in range(done_np.shape[1]):
                    if prev >= n:
                        break
                    end = min(int(done_np[worker, r]), n)
                    if end <= prev:
                        continue
                    add(SpanEvent("round", float(prev), float(end - prev),
                                  process, track, {"worker": worker,
                                                   "round": r,
                                                   "scheme": scheme}))
                    c_end = prev + min(tau, end - prev)
                    add(SpanEvent("compute", float(prev),
                                  float(c_end - prev), process, track,
                                  {"worker": worker, "round": r}))
                    for tier, total in tiers:
                        add(SpanEvent(
                            "merge", float(c_end), float(end - c_end),
                            process, track,
                            {"tier": "flat" if tier is None else tier,
                             "wire_bytes": int(round(total / n
                                                     * (end - prev))),
                             "worker": worker, "round": r}))
                    prev = end
            return out

        tr.add_spans(n_rounds * (2 + len(tiers)), build)
        tick_list = ticks.tolist()
        tr.add_counters(len(tick_list), lambda: [
            CounterEvent("distortion", float(curve_np[k]), float(t), process)
            for k, t in enumerate(tick_list)])
