"""``QuantizeService``: batched nearest-prototype lookup as a service.

Counterpart of ``repro/serve/service.py``.  Queries arrive one vector at a
time; the kernel wants batches.  A micro-batching scheduler coalesces
incoming requests into one lookup call, padded to a multiple of
``batch_align=128`` rows, under a deadline-driven flush:

    submit(z) -> pending queue -> flush when EITHER
                                    * coalesced rows >= max_batch, OR
                                    * oldest request age >= max_delay_s
              -> pad to batch_align -> ShardedLookup.assign(batch, w)
              -> split results back onto per-request futures

Every flush reads ONE immutable ``CodebookStore`` snapshot, so all rows of
a batch are served by the same ``(version, w)`` pair.  The flush thread
launches the assign kernel; a build or launch error reaches that flush's
futures as their exception, and the thread lives on.  ``tracer=`` /
``metrics=`` (``repro_torch.obs``) get the reference's ``flush`` span on
the flush thread's track and, per flush, the ``serve_flush_wall_s`` and
``serve_batch_fill`` histograms, the ``serve_queue_depth`` gauge and the
``serve_flushes``, ``serve_rows`` and ``serve_padded_rows`` counters
(``serve_failed`` for a failed flush).

Over a process group (a ``ShardedLookup(group=)`` of more than one shard)
rank 0 owns the store, the queue, the flush thread and the load, and the
other ranks run ``follow(lookup)``.  For every lookup call, the warm-ups'
included, rank 0 broadcasts a header (kind, padded rows, real rows,
codebook version, kappa, d), then the padded batch, and, when the version
changed since its last call, the codebook; every rank then calls
``lookup.assign`` on the same arguments.  ``stop`` sends a stop header
after the queue drains.  A lookup that raises on any rank raises on every
rank (``ShardedLookup`` carries the failure through its collectives): rank
0's flush fails its futures, a follower counts it in ``failed``, and both
go on to the next call, so no rank waits for one that left.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.serve.codebook_store import CodebookStore
from repro_torch.serve.lookup import ShardedLookup


#: A lookup call's header kinds (over a process group).
FLUSH, WARMUP, STOP = 0, 1, 2
#: The header: kind, padded rows, real rows, codebook version, kappa, d.
HEADER = 6


@dataclasses.dataclass(frozen=True)
class QuantizeRequest:
    """One pending query: ``rows`` vectors awaiting assignment."""

    z: np.ndarray                   # (rows, d) float32
    rows: int
    submitted_at: float             # time.monotonic()
    future: Future = dataclasses.field(repr=False, compare=False,
                                       default_factory=Future)


@dataclasses.dataclass(frozen=True)
class QuantizeResponse:
    """Assignments for one request, stamped with the codebook that served it."""

    assign: np.ndarray              # (rows,) int32 nearest-prototype indices
    mindist: np.ndarray             # (rows,) float32 squared distances
    version: int                    # CodebookStore version served
    latency_s: float                # submit -> response (service-internal)
    batch_rows: int                 # real rows of the coalesced flush batch


@dataclasses.dataclass
class ServiceStats:
    """Counters the flush loop maintains (read them after ``stop``)."""

    requests: int = 0
    rows: int = 0
    flushes: int = 0
    full_flushes: int = 0           # flushed because max_batch filled up
    deadline_flushes: int = 0       # flushed because the deadline expired
    padded_rows: int = 0            # alignment rows added across all flushes
    failed: int = 0
    warmups: int = 0                # lookup calls made by start()'s warm-up

    @property
    def mean_fill(self) -> float:
        """Mean real rows per flush (how well coalescing worked)."""
        return self.rows / self.flushes if self.flushes else 0.0


class QuantizeService:
    """Deadline-driven micro-batching front end over ``ShardedLookup``.

    store:       the ``CodebookStore`` serving reads (hot-swappable).
    lookup:      a ``ShardedLookup`` (default: one on ``cuda``).
    max_batch:   flush as soon as this many rows are pending (default:
                 ``batch_align`` rows per lookup shard).
    max_delay_s: flush a partial batch once the oldest pending request has
                 waited this long.
    batch_align: row alignment of the coalesced batch (the reference's MXU
                 alignment; kept so padded flushes have the same shapes).
    warmup:      run the hot flush shapes once against the current codebook
                 inside ``start()`` (the first launch builds the kernels),
                 so that no request waits for it.
    """

    def __init__(self, store: CodebookStore,
                 lookup: ShardedLookup | None = None, *,
                 max_batch: int | None = None, max_delay_s: float = 2e-3,
                 batch_align: int = 128, warmup: bool = True,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.store = store
        self.lookup = lookup if lookup is not None else ShardedLookup()
        if batch_align < 1:
            raise ValueError(f"batch_align must be >= 1, got {batch_align}")
        if batch_align % self.lookup.batch_multiple():
            raise ValueError(
                f"batch_align={batch_align} must be a multiple of the "
                f"lookup's {self.lookup.batch_multiple()} shards")
        self.batch_align = batch_align
        self.max_batch = max_batch if max_batch is not None else (
            batch_align * self.lookup.n_shards)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.max_delay_s = max_delay_s
        self.warmup = warmup
        # over a process group: the lookup's group, the last codebook
        # version the followers were sent, and whether they were stopped
        self._group = self.lookup.group if self.lookup.n_shards > 1 else None
        if self._group is not None:
            from repro_torch.distributed import process_group
            if process_group.group_rank(self._group) != 0:
                raise ValueError(
                    "over a process group rank 0 runs the service; the other "
                    "ranks run serve.service.follow(lookup)")
        self._sent_version = 0
        self._followers_stopped = False
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.stats = ServiceStats()
        self._cond = threading.Condition()
        self._queue: list[QuantizeRequest] = []
        self._pending_rows = 0
        self._running = False
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "QuantizeService":
        with self._cond:
            if self._running:
                raise RuntimeError("service already running")
            self._running = True
        if self.warmup and self.store.version:
            snap = self.store.latest()
            d = snap.w.shape[1]
            align = self.batch_align
            try:
                for rows in sorted({align,
                                    -(-self.max_batch // align) * align}):
                    _, mind = self._lookup(np.zeros((rows, d), np.float32),
                                           snap, WARMUP, 0)
                    mind.cpu()   # waits for the device
                    self.stats.warmups += 1
            except Exception:
                with self._cond:
                    self._running = False
                self._stop_followers()
                raise
        self._thread = threading.Thread(target=self._flush_loop,
                                        name="quantize-flush", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue (every accepted request gets a response), then
        stop the flush thread."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._cond.notify_all()
        assert self._thread is not None
        self._thread.join()
        self._thread = None
        self._stop_followers()

    # -- over a process group -----------------------------------------------

    def _announce(self, kind: int, rows: int = 0, real: int = 0,
                  snap=None) -> None:
        """Broadcast a lookup call's header to the followers."""
        from repro_torch.distributed import process_group
        kappa, d = snap.w.shape if snap is not None else (0, 0)
        version = snap.version if snap is not None else 0
        head = torch.tensor([kind, rows, real, version, kappa, d],
                            dtype=torch.int64, device=self.lookup.device)
        process_group.broadcast(head, 0, self._group)

    def _stop_followers(self) -> None:
        if self._group is not None and not self._followers_stopped:
            self._announce(STOP)
            self._followers_stopped = True

    def _lookup(self, z: np.ndarray, snap, kind: int, real: int):
        """``lookup.assign(z, snap's codebook)``; over a process group the
        followers get the header, ``z`` and a changed codebook first."""
        if self._group is None:
            return self.lookup.assign(z, snap.w_device)
        from repro_torch.distributed import process_group
        self._announce(kind, z.shape[0], real, snap)
        zt = process_group.broadcast(
            torch.as_tensor(z, device=self.lookup.device), 0, self._group)
        if snap.version != self._sent_version:
            process_group.broadcast(snap.w_device, 0, self._group)
            self._sent_version = snap.version
        return self.lookup.assign(zt, snap.w_device)

    def __enter__(self) -> "QuantizeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path -------------------------------------------------------

    def submit(self, z) -> Future:
        """Queue ``z`` ((d,) or (rows, d)); resolves to ``QuantizeResponse``."""
        arr = np.asarray(z, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[0] < 1:
            raise ValueError(f"query must be (d,) or (rows, d), "
                             f"got shape {np.shape(z)}")
        req = QuantizeRequest(z=arr, rows=arr.shape[0],
                              submitted_at=time.monotonic())
        with self._cond:
            if not self._running:
                raise RuntimeError("service is not running (use start() or "
                                   "the context manager)")
            self._queue.append(req)
            self._pending_rows += req.rows
            self._cond.notify_all()
        return req.future

    def quantize(self, z, timeout: float | None = 30.0) -> QuantizeResponse:
        """Synchronous convenience wrapper around ``submit``."""
        return self.submit(z).result(timeout=timeout)

    # -- flush loop ---------------------------------------------------------

    def _take_batch_locked(self) -> tuple[list[QuantizeRequest], bool]:
        """Pop requests up to ``max_batch`` rows (always at least one)."""
        take: list[QuantizeRequest] = [self._queue[0]]
        rows = take[0].rows
        while (len(take) < len(self._queue)
               and rows + self._queue[len(take)].rows <= self.max_batch):
            rows += self._queue[len(take)].rows
            take.append(self._queue[len(take)])
        del self._queue[:len(take)]
        self._pending_rows -= rows
        return take, rows >= self.max_batch

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and self._running:
                    self._cond.wait()
                if not self._queue:
                    return  # stopped and drained
                deadline = self._queue[0].submitted_at + self.max_delay_s
                while (self._running
                       and self._pending_rows < self.max_batch):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                depth = self._pending_rows      # queue depth at flush time
                batch, full = self._take_batch_locked()
            self._execute(batch, full, depth)

    def _execute(self, batch: list[QuantizeRequest], full: bool,
                 depth: int = 0) -> None:
        # claim every future first: a client may have cancel()ed while the
        # request was queued, and resolving a cancelled future would raise
        # InvalidStateError and kill the flush thread
        batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        rows = sum(r.rows for r in batch)
        t_flush = time.perf_counter()
        try:
            with self.tracer.span("flush", rows=rows, requests=len(batch),
                                  full=full, queue_depth=depth):
                snap = self.store.latest()
                z = (batch[0].z if len(batch) == 1
                     else np.concatenate([r.z for r in batch]))
                pad = (-z.shape[0]) % self.batch_align
                if pad:
                    z = np.concatenate([z, np.zeros((pad, z.shape[1]),
                                                    np.float32)])
                assign, mind = self._lookup(z, snap, FLUSH, rows)
                assign = assign.cpu().numpy()
                mind = mind.cpu().numpy()
        except Exception as e:  # noqa: BLE001 - the fault goes to the callers
            for r in batch:
                r.future.set_exception(e)
            self.stats.failed += len(batch)
            if self.metrics is not None:
                self.metrics.counter("serve_failed").inc(len(batch))
            return
        if self.metrics is not None:
            mt = self.metrics
            mt.histogram("serve_flush_wall_s").observe(
                time.perf_counter() - t_flush)
            mt.histogram("serve_batch_fill").observe(rows / self.max_batch)
            mt.gauge("serve_queue_depth").set(depth)
            mt.counter("serve_flushes",
                       kind="full" if full else "deadline").inc()
            mt.counter("serve_rows").inc(rows)
            mt.counter("serve_padded_rows").inc(pad)
        now = time.monotonic()
        off = 0
        for r in batch:
            r.future.set_result(QuantizeResponse(
                assign=assign[off:off + r.rows],
                mindist=mind[off:off + r.rows],
                version=snap.version,
                latency_s=now - r.submitted_at,
                batch_rows=rows))
            off += r.rows
        self.stats.requests += len(batch)
        self.stats.rows += rows
        self.stats.flushes += 1
        self.stats.padded_rows += pad
        if full:
            self.stats.full_flushes += 1
        else:
            self.stats.deadline_flushes += 1


def follow(lookup: ShardedLookup) -> ServiceStats:
    """A follower rank of a service over ``lookup``'s group: every lookup
    call rank 0's ``QuantizeService`` announces, until its stop header.
    Returns this rank's counts: ``flushes`` and ``warmups`` (its assign
    calls), ``rows`` and ``padded_rows``, and ``failed`` calls."""
    from repro_torch.distributed import process_group
    group, dev = lookup.group, lookup.device
    if lookup.n_shards < 2 or process_group.group_rank(group) == 0:
        raise ValueError("follow runs on ranks 1.. of a sharded lookup's "
                         "group; rank 0 runs the QuantizeService")
    stats = ServiceStats()
    w, version = None, 0
    while True:
        head = process_group.broadcast(
            torch.zeros(HEADER, dtype=torch.int64, device=dev), 0, group)
        kind, rows, real, ver, kappa, d = head.tolist()
        if kind == STOP:
            return stats
        z = process_group.broadcast(
            torch.empty((rows, d), dtype=torch.float32, device=dev), 0,
            group)
        if ver != version:
            w = process_group.broadcast(
                torch.empty((kappa, d), dtype=torch.float32, device=dev), 0,
                group)
            version = ver
        try:
            lookup.assign(z, w)
        except Exception:  # noqa: BLE001 - rank 0 fails the flush's futures
            stats.failed += 1
            continue
        if kind == WARMUP:
            stats.warmups += 1
        else:
            stats.flushes += 1
            stats.rows += real
            stats.padded_rows += rows - real
