"""Host-side span tracer with Chrome trace-event (Perfetto) export.

The port's own copy of ``repro/obs/trace.py``, with one addition:
``add_spans`` and ``add_counters`` (below).

Two kinds of spans share one timeline:

* **wall spans** — real host work (``with tracer.span("run", ...):``),
  stamped with ``time.monotonic_ns`` (never the wall clock — span math
  must not jump with clock adjustments).  Nesting is the natural ``with``
  nesting; a span records its attrs, track, and thread automatically.
* **modeled spans** — the engine's tick-timeline reconstruction
  (``tracer.add_span(...)`` with explicit start/duration).  The mesh
  engine runs the workers' windows as device launches whose timing the
  host never reads, so per-worker compute and merge phases are *modeled*
  from the same ``NetworkModel`` arithmetic that produces ``wall_ticks``
  — which is what makes the eq.-9 compute/communication overlap visible
  in Perfetto without a device read in the hot loop.

Counters (``tracer.counter``) become Chrome ``"C"`` events — Perfetto
renders them as per-process line charts (distortion and codebook
divergence over the run).

``Tracer(enabled=False)`` (or the shared ``NULL_TRACER``) makes every
call a constant-time no-op.

``add_spans(count, build)`` records a block of ``count`` modeled spans
as one entry and calls ``build()`` for them the first time spans are
read (``spans``, ``chrome_events``, a trim); ``add_counters`` does the
same for counter samples.  A full-depth run's tick timeline is a few
hundred thousand spans (about 17 a window at M = 8) and two counter
samples a window; made one by one after the run they would cost the run
a few percent of its wall time, the reference's whole budget for
instrumentation.  The events, their order and the bounds are what
``add_span`` / ``counter`` calls in the same order would give.

**Measured phases** (``PhaseClock``, the port's own): a ``MeshExecutor``
run marks each step's three phases on the device's clock, ``local`` (the
window kernel, or eq. 9's step and its epilogue), ``merge`` (the merge
through the transport; eq. 9's masked merge and where-updates) and
``eval`` (eq. 2 through the transport).  A mark is a CUDA timing event on
the current stream at a phase's start (``time.perf_counter_ns()`` on the
CPU, whose ops run synchronously), each step's last boundary the next
step's first: 3 events a window, 2 or 3 a tick, and one that closes the
loop.  While a ``torch.profiler`` runs, each phase also runs inside a
profiler range, ``repro_torch.local`` / ``repro_torch.merge`` /
``repro_torch.eval``, on the profiler's own clock beside the kernels (a
``record_function`` through its C entry, ``_RecordFunctionFast``: under
the profiler ~1 us of host time a range where ``torch.profiler.
record_function`` takes ~8; the trace files it as a ``cpu_op``).  The
marks are read once the device has drained, after the loop, and become
spans on their own process (``DEVICE_PROCESS``, track ``"phases"``:
``local_phase``, ``merge_phase``, ``eval_phase`` with attrs ``step`` and
``run``, the ordinal of the ``run`` wall span), placed on this tracer's
clock through one anchor event recorded right after the run's opening
drain with ``now_us()`` read just before it.  The executor times a run
when the tracer is enabled, a ``Profiler`` is attached or a
``torch.profiler`` is active (read once a run); otherwise its loops hold
no mark, no range and no test.  On the card a mark costs the host one
``cudaEventRecord`` of an event from a pool kept for the process, and the
range's enter and exit while a ``torch.profiler`` runs; reading the marks
after the run costs one ``cudaEventElapsedTime`` each, in one C call
(``kernels/csrc/vq_events.cu``).  On an H100 machine that is ~5 us of host
time a mark (~6 under the profiler, its range included) and ~4.5 us a mark
to read.  The device runs nothing for them (an event is no kernel, copy or
set); where the host sets the pace, as a profiled d = 128 window does, the
host's time shows as device idle.

The exported file is plain Chrome trace-event JSON: open it at
https://ui.perfetto.dev (or chrome://tracing).  ``ts``/``dur`` are
microseconds; one Perfetto "process" per logical process (host, ticks,
device), one "thread" per track (worker, tier, host thread, phases).
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Callable

import torch


@dataclasses.dataclass(slots=True)
class SpanEvent:
    """One completed (or still-open) span on the trace timeline."""

    name: str
    start_us: float
    dur_us: float | None           # None while the span is still open
    process: str                   # Perfetto process (pid) label
    track: str                     # Perfetto thread (tid) label
    attrs: dict[str, Any]


@dataclasses.dataclass(slots=True)
class CounterEvent:
    """One sample of a numeric series (Chrome ``"C"`` counter event)."""

    name: str
    value: float
    ts_us: float
    process: str


class _Deferred:
    """``count`` events that ``build()`` makes when first read."""

    __slots__ = ("count", "build")

    def __init__(self, count: int, build: Callable[[], list]):
        self.count = count
        self.build = build


class Tracer:
    """Bounded span/counter recorder; thread-safe; monotonic-clock.

    ``process``/``track`` name the Perfetto lanes.  Wall spans default to
    ``process="host"`` and the current thread's name; modeled spans pick
    their own (e.g. ``process="ticks", track="worker 3"``).

    Buffers are bounded like ``CommLog``: a long-lived serve/train loop
    appends forever, so only the newest ``max_spans``/``max_counters``
    events are kept and the oldest dropped — ``dropped_spans``/
    ``dropped_counters`` say how many fell off the front, so a truncated
    export is detectable instead of silently partial.  The defaults are
    sized so a benchmark-scale run never trims (the obs overhead bench
    emits thousands of spans, not millions).
    """

    WALL_PROCESS = "host"
    TICK_PROCESS = "ticks"
    DEVICE_PROCESS = "device"

    def __init__(self, *, enabled: bool = True, max_spans: int = 1 << 20,
                 max_counters: int = 1 << 20):
        if max_spans < 1 or max_counters < 1:
            raise ValueError(
                f"span/counter buffer bounds must be >= 1, got "
                f"max_spans={max_spans} max_counters={max_counters}")
        self.enabled = enabled
        self.max_spans = max_spans
        self.max_counters = max_counters
        self._lock = threading.Lock()
        self._spans: list[SpanEvent] = []
        self._counters: list[CounterEvent] = []
        self._dropped_spans = 0           # trimmed off the front, ever
        self._dropped_counters = 0
        self._open = 0                    # wall spans entered but not exited
        # per buffer ("spans", "counters"): its _Deferred entries, and the
        # events they stand for beyond their one entry each, so that
        # len(_spans) + _extra["spans"] is the span count
        self._blocks = {"spans": 0, "counters": 0}
        self._extra = {"spans": 0, "counters": 0}
        self._opened: dict[str, int] = {}   # wall spans entered, by name
        self._t0_ns = time.monotonic_ns()

    # -- bounds --------------------------------------------------------------

    @property
    def dropped_spans(self) -> int:
        """Spans trimmed off the front of the buffer, ever."""
        return self._dropped_spans

    @property
    def dropped_counters(self) -> int:
        """Counter samples trimmed off the front of the buffer, ever."""
        return self._dropped_counters

    def _expand(self, kind: str) -> None:
        """Build every deferred block of one buffer in place (under
        ``_lock``).  Slice assignment keeps a concurrent lock-free append."""
        items = self._spans if kind == "spans" else self._counters
        i = 0
        while self._blocks[kind] and i < len(items):
            ev = items[i]
            if not isinstance(ev, _Deferred):
                i += 1
                continue
            built = ev.build()
            if len(built) != ev.count:
                raise RuntimeError(
                    f"a deferred block built {len(built)} {kind}, declared "
                    f"{ev.count}")
            items[i:i + 1] = built
            self._blocks[kind] -= 1
            self._extra[kind] -= ev.count - 1
            i += len(built)

    def _trim(self) -> None:
        """Drop-oldest down to the bounds (under ``_lock``)."""
        if len(self._spans) + self._extra["spans"] > self.max_spans:
            self._expand("spans")
        if len(self._counters) + self._extra["counters"] > self.max_counters:
            self._expand("counters")
        excess = len(self._spans) - self.max_spans
        if excess > 0:
            del self._spans[:excess]
            self._dropped_spans += excess
        excess = len(self._counters) - self.max_counters
        if excess > 0:
            del self._counters[:excess]
            self._dropped_counters += excess

    # -- clock ---------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since this tracer was created (monotonic)."""
        return (time.monotonic_ns() - self._t0_ns) / 1e3

    # -- wall spans ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, *, process: str | None = None,
             track: str | None = None, **attrs):
        """Record a real (monotonic-clock) span around the ``with`` body."""
        if not self.enabled:
            yield None
            return
        ev = SpanEvent(
            name=name, start_us=self.now_us(), dur_us=None,
            process=process or self.WALL_PROCESS,
            track=track or threading.current_thread().name,
            attrs=attrs)
        with self._lock:
            self._spans.append(ev)
            self._open += 1
            self._opened[name] = self._opened.get(name, 0) + 1
            if len(self._spans) + self._extra["spans"] > self.max_spans:
                self._trim()
        try:
            yield ev
        finally:
            ev.dur_us = self.now_us() - ev.start_us
            with self._lock:
                self._open -= 1

    def opened(self, name: str) -> int:
        """Wall spans named ``name`` entered so far (0 when disabled)."""
        with self._lock:
            return self._opened.get(name, 0)

    # -- modeled spans and counters ------------------------------------------

    def add_span(self, name: str, start_us: float, dur_us: float, *,
                 process: str | None = None, track: str, **attrs) -> None:
        """Record a span with explicit timestamps (tick-timeline tracks).

        Lock-free: ``list.append`` is atomic under the GIL, and modeled
        spans are the instrumentation hot path (hundreds per segment of
        windows).
        """
        if not self.enabled:
            return
        self._spans.append(SpanEvent(
            name, float(start_us), max(float(dur_us), 0.0),
            process or self.TICK_PROCESS, track, attrs))
        # bound check stays off the common path: with the default 1M cap
        # the branch is a len() compare, and only over-cap calls take the
        # lock to trim
        if len(self._spans) + self._extra["spans"] > self.max_spans:
            with self._lock:
                self._trim()

    def _add_deferred(self, kind: str, count: int, build) -> None:
        if not self.enabled or count <= 0:
            return
        items = self._spans if kind == "spans" else self._counters
        bound = self.max_spans if kind == "spans" else self.max_counters
        with self._lock:
            items.append(_Deferred(count, build))
            self._blocks[kind] += 1
            self._extra[kind] += count - 1
            if len(items) + self._extra[kind] > bound:
                self._trim()

    def add_spans(self, count: int,
                  build: Callable[[], list[SpanEvent]]) -> None:
        """Record ``count`` modeled spans that ``build()`` returns, in
        order, when spans are first read (see the module docstring).
        ``build`` must depend on host values only, fixed when it is
        passed."""
        self._add_deferred("spans", count, build)

    def add_counters(self, count: int,
                     build: Callable[[], list[CounterEvent]]) -> None:
        """``add_spans`` for ``count`` counter samples."""
        self._add_deferred("counters", count, build)

    def counter(self, name: str, value: float, ts_us: float | None = None, *,
                process: str | None = None) -> None:
        """Sample a numeric series (rendered as a Perfetto line chart)."""
        if not self.enabled:
            return
        self._counters.append(CounterEvent(
            name, float(value),
            self.now_us() if ts_us is None else float(ts_us),
            process or self.TICK_PROCESS))
        if len(self._counters) + self._extra["counters"] > self.max_counters:
            with self._lock:
                self._trim()

    # -- introspection -------------------------------------------------------

    @property
    def open_spans(self) -> int:
        """Wall spans currently entered but not yet exited."""
        with self._lock:
            return self._open

    def spans(self, name: str | None = None) -> list[SpanEvent]:
        with self._lock:
            self._expand("spans")
            evs = list(self._spans)
        return evs if name is None else [e for e in evs if e.name == name]

    def counters(self, name: str | None = None) -> list[CounterEvent]:
        with self._lock:
            self._expand("counters")
            evs = list(self._counters)
        return evs if name is None else [e for e in evs if e.name == name]

    # -- export --------------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event dicts (``"X"`` spans, ``"C"`` counters,
        ``"M"`` metadata naming each process/track)."""
        with self._lock:
            self._expand("spans")
            self._expand("counters")
            spans = list(self._spans)
            counters = list(self._counters)
        pids: dict[str, int] = {}
        tids: dict[tuple[int, str], int] = {}
        events: list[dict] = []

        def pid_of(process: str) -> int:
            if process not in pids:
                pids[process] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pids[process], "tid": 0,
                               "args": {"name": process}})
            return pids[process]

        def tid_of(pid: int, track: str) -> int:
            key = (pid, track)
            if key not in tids:
                tids[key] = sum(1 for p, _ in tids if p == pid) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tids[key],
                               "args": {"name": track}})
            return tids[key]

        for s in spans:
            pid = pid_of(s.process)
            events.append({
                "ph": "X", "name": s.name, "cat": s.process,
                "ts": s.start_us,
                "dur": s.dur_us if s.dur_us is not None else 0.0,
                "pid": pid, "tid": tid_of(pid, s.track),
                "args": {**s.attrs,
                         **({"unclosed": True} if s.dur_us is None else {})},
            })
        for c in counters:
            events.append({"ph": "C", "name": c.name, "ts": c.ts_us,
                           "pid": pid_of(c.process), "tid": 0,
                           "args": {c.name: c.value}})
        return events

    def export_chrome(self, path: str) -> None:
        """Write a Perfetto-loadable Chrome trace-event JSON file."""
        doc = {"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)


NULL_TRACER = Tracer(enabled=False)

PHASES = ("local", "merge", "eval")

# idle raw CUDA events by device index, lent to PhaseClocks and given back
# once read; made in chunks of EVENT_CHUNK and kept for the process
EVENT_CHUNK = 256
_idle_events: dict[int, list[int]] = {}
_events_lock = threading.Lock()


def _lend_events(index: int) -> list[int]:
    """A chunk of idle timing events on the card ``index``."""
    with _events_lock:
        idle = _idle_events.setdefault(index, [])
        if len(idle) < EVENT_CHUNK:
            from repro_torch.kernels import _build
            made = (ctypes.c_void_p * EVENT_CHUNK)()
            with torch.cuda.device(index):
                _build.check(_build.library().vq_events_create(
                    EVENT_CHUNK, made), "vq_events_create")
            idle.extend(made)
        lent = idle[-EVENT_CHUNK:]
        del idle[-EVENT_CHUNK:]
    return lent


def _give_events(index: int, events: list[int]) -> None:
    with _events_lock:
        _idle_events[index].extend(events)


class PhaseClock:
    """The marks of one run's phases on the device's clock (see the module
    docstring).

    ``before(phase, fn)`` wraps a phase's first call: the wrapper marks the
    phase's start, closing the phase before it, and with ``ranges`` opens
    its profiler range (only a running ``torch.profiler`` records one).
    ``close()`` ends the open phase (a loop's end; again on an error, where
    it is a no-op after a clean end).  ``phases()`` reads the marks once the
    device has run them, and gives the card's events back to the pool:
    ``(phase, step, start_ns, dur_ns)`` from the anchor, each phase from its
    opening mark to the next one, so a phase's interval holds the device's
    idle time inside it.
    """

    def __init__(self, device: torch.device, tracer: Tracer, *,
                 step0: int = 0, ranges: bool = True):
        self._cuda = device.type == "cuda"
        self._ranges = ranges         # profiler ranges (a profiler is on)
        if self._cuda:
            from repro_torch.kernels import _build
            self._index = (torch.cuda.current_device() if device.index is None
                           else device.index)
            self._record = _build.library().vq_event_record
            self._check = _build.check
            self._stream = _build.current_stream(
                torch.device("cuda", self._index))
            self._free: list[int] = []
        self._marks: list = []        # (phase opened or None, step, stamp)
        self._range = None            # the open profiler range
        self.steps = 0                # steps timed: "local" phases opened
        self._step0 = step0
        # the anchor: the tracer's clock, then the anchor's mark
        self.anchor_us = tracer.now_us()
        self._anchor = self._stamp()

    def _stamp(self) -> int:
        """A mark: the host's nanoseconds on the CPU, a recorded raw event
        on the card."""
        if not self._cuda:
            return time.perf_counter_ns()
        if not self._free:
            self._free = _lend_events(self._index)
        ev = self._free.pop()
        self._check(self._record(ev, self._stream), "vq_event_record")
        return ev

    def _mark(self, phase: str | None) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if phase == "local":
            self.steps += 1
        self._marks.append((phase, self._step0 + self.steps - 1,
                            self._stamp()))
        if phase is not None and self._ranges:
            self._range = torch._C._profiler._RecordFunctionFast(
                f"repro_torch.{phase}")
            self._range.__enter__()

    def before(self, phase: str, fn: Callable) -> Callable:
        """``fn`` that first marks the start of ``phase``."""
        def timed(*args, **kwargs):
            self._mark(phase)
            return fn(*args, **kwargs)
        return timed

    def close(self) -> None:
        """End the open phase, if one is open."""
        if self._marks and self._marks[-1][0] is not None:
            self._mark(None)

    def _times_ns(self) -> list[int]:
        """Each mark's nanoseconds from the anchor.  On the card one C call
        reads each mark from the one before it (``csrc/vq_events.cu``),
        so a phase's time is one event interval, not a difference of two
        float milliseconds from the anchor, and gives the events back."""
        stamps = [self._anchor] + [stamp for _, _, stamp in self._marks]
        if not self._cuda:
            return [t - self._anchor for t in stamps[1:]]
        from repro_torch.kernels import _build
        n = len(stamps)
        ms = (ctypes.c_float * n)()
        _build.check(_build.library().vq_event_elapsed(
            (ctypes.c_void_p * n)(*stamps), n, ms), "vq_event_elapsed")
        _give_events(self._index, stamps + self._free)
        self._free = []
        at, out = 0, []
        for t in ms[1:]:
            at += round(t * 1e6)
            out.append(at)
        return out

    def phases(self) -> list[tuple[str, int, int, int]]:
        """``(phase, step, start_ns, dur_ns)`` of every closed phase, the
        times from the anchor; the device must have run every mark."""
        at = self._times_ns()
        return [(phase, step, at[k], at[k + 1] - at[k])
                for k, (phase, step, _) in enumerate(self._marks[:-1])
                if phase is not None]

    def spans(self, phases: list, run: int | None) -> list[SpanEvent]:
        """``phases()`` as ``<phase>_phase`` spans on the tracer's clock."""
        return [SpanEvent(f"{phase}_phase", self.anchor_us + start / 1e3,
                          dur / 1e3, Tracer.DEVICE_PROCESS, "phases",
                          {"step": step, "run": run})
                for phase, step, start, dur in phases]


class ExitFlush:
    """Flush trace/metrics exports even when the run dies early.

    A chaos-killed or Ctrl-C'd training loop never reaches the
    end-of-run ``export_chrome``/``dump_jsonl`` calls, losing exactly
    the artifacts needed to debug why it died.  Constructing an
    ``ExitFlush`` registers an ``atexit`` hook (and, opt-in, a SIGTERM
    hook — the chaos sweep and container runtimes kill with SIGTERM)
    that writes whatever the tracer/metrics hold *now*.  ``flush()`` is
    idempotent: the normal happy-path flush disarms the exit hook, so
    artifacts are written exactly once either way.

    Usable as a context manager for scoped runs::

        with ExitFlush(tracer=tr, trace_path="t.json") as fl:
            executor.run(...)
        # flushed here, and also on KeyboardInterrupt/SystemExit
    """

    def __init__(self, *, tracer=None, trace_path: str | None = None,
                 metrics=None, metrics_path: str | None = None,
                 run: str | None = None, catch_sigterm: bool = False):
        if tracer is None and metrics is None:
            raise ValueError("ExitFlush needs a tracer and/or metrics")
        self.tracer = tracer
        self.trace_path = trace_path
        self.metrics = metrics
        self.metrics_path = metrics_path
        self.run = run
        self._done = False
        self._lock = threading.Lock()
        self._prev_sigterm = None
        atexit.register(self._atexit)
        if catch_sigterm and threading.current_thread() is threading.main_thread():
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)

    def _atexit(self) -> None:
        self.flush()

    def _on_sigterm(self, signum, frame) -> None:
        self.flush()
        # restore and re-deliver so the process still dies with the
        # default SIGTERM semantics (exit code 143, parent sees the signal)
        signal.signal(signum, self._prev_sigterm or signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def flush(self) -> dict[str, str]:
        """Write the pending exports; no-op on every call after the first."""
        with self._lock:
            if self._done:
                return {}
            self._done = True
        atexit.unregister(self._atexit)
        if self._prev_sigterm is not None:
            with contextlib.suppress(ValueError):   # not main thread at exit
                signal.signal(signal.SIGTERM, self._prev_sigterm)
        written: dict[str, str] = {}
        if self.tracer is not None and self.trace_path:
            self.tracer.export_chrome(self.trace_path)
            written["trace"] = self.trace_path
        if self.metrics is not None and self.metrics_path:
            self.metrics.dump_jsonl(self.metrics_path, run=self.run)
            written["metrics"] = self.metrics_path
        return written

    def __enter__(self) -> "ExitFlush":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.flush()
