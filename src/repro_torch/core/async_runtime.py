"""The real asynchronous VQ runtime: worker threads, a reducer thread and a
versioned store, with no barrier anywhere.  Counterpart of
``repro/core/async_runtime.py`` (the paper's section-4 CloudDALVQ shape:
each worker uploads its displacement and downloads the shared version as
soon as its previous upload and download are done; a dedicated unit keeps
modifying the shared version).

The protocol is the reference's; on the card:

  * ``BlobStore`` holds a device tensor.  ``get()`` returns a clone, and the
    reducer's merge goes through the atomic ``apply``, on the device.
  * A worker's round is one window-kernel launch, ``worker_round``: tau
    eq.-1 steps from the worker's private codebook through
    ``ops.vq_window`` at ``(1, tau, d)`` (its plain version for CPU
    tensors), the counterpart of ``repro.core.vq.window_displacement``.
    The reference runs those steps in numpy on the host.
  * The step schedule.  The reference draws one global step per point
    under a lock; here a worker reserves ``tau`` consecutive global steps
    per round under the same lock and takes ``eps_t`` for ``t = t0+1 ..
    t0+tau``.  At M = 1 this is the reference's sequence exactly; at M > 1
    it is another interleaving the same nondeterministic runtime can give
    (a round's steps consecutive, not interleaved with other workers').
  * Points wrap at ``n``, as the reference's ``data[i, pos % n]``.
  * A straggler sleeps ``tau * 1e-5 * (slow - 1)`` seconds a round, the
    reference's per-point sleep summed over the round.
  * The inbox holds at most ``INBOX_PER_WORKER * M`` deltas (0: no bound,
    as the reference's queue).  Each is a (kappa, d) device tensor, and the
    reducer shares the interpreter lock with the M workers, so unbounded it
    falls behind: at (4096, 128) with M = 8 on an NVIDIA H100 80GB HBM3 at
    700 W the inbox held 2,926 of 4,697 pushes at its deepest in 5 s (6,508
    MiB of device memory), and the shared version the sampler read was
    worse than with the bound (``chip_smoke.py`` T1, PERF.md §6).  A push
    that finds the inbox full waits, as an upload waits for the reducer.
    ``WorkerStats.inbox_peak`` is the deepest inbox a worker's push made.
  * The sampler scores eq. 2 with the plain ``kernels/ref.distortion_ref``
    (the reference's sampler uses its plain ``kref.distortion_ref``) on the
    first ``min(4096, M*n)`` points.
  * Every thread launches on the caller's current stream, the same one.
    Per-worker streams would make each hand-off between threads a hazard:
    a ``get()`` clone could be taken before another stream's ``apply`` has
    landed, and the caching allocator could reuse an inbox delta freed on
    another stream (which needs ``record_stream``).

The reducer merges every pushed delta before the final read (the
reference's may stop with a last push unmerged).  A thread's exception
stops the run and is raised from ``run_async_vq`` once every thread has
joined.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable

import torch

from repro_torch.core import vq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

#: Inbox capacity a worker, 0 for none (see the module docstring).
INBOX_PER_WORKER = 4


class BlobStore:
    """Versioned shared-value store (the Azure-blob stand-in).

    ``put`` installs a new version; ``get`` returns (version, a clone of the
    value).  Reads and writes are atomic but unsynchronized with each other,
    the consistency the paper's reducer/worker protocol needs (a worker may
    read a slightly stale shared version; that IS eq. 9)."""

    def __init__(self, value: torch.Tensor):
        self._lock = threading.Lock()
        self._value = value.clone()
        self._version = 0

    def get(self) -> tuple[int, torch.Tensor]:
        with self._lock:
            return self._version, self._value.clone()

    def put(self, value: torch.Tensor) -> int:
        with self._lock:
            self._value = value
            self._version += 1
            return self._version

    def apply(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> int:
        """Atomic read-modify-write: install ``fn(current)`` as a new version.

        A bare ``get()`` -> ``put()`` pair is NOT atomic: with several
        writers, updates between the two calls are dropped.  The reducer's
        delta merge goes through here."""
        with self._lock:
            self._value = fn(self._value)
            self._version += 1
            return self._version


@dataclasses.dataclass
class WorkerStats:
    points: int = 0
    pushes: int = 0
    stale_reads: int = 0
    inbox_peak: int = 0     # the inbox's depth after a push, at its deepest


def worker_round(w: torch.Tensor, zwin: torch.Tensor, t0: int, *,
                 eps0: float = 0.5, decay: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """tau sequential eq.-1 steps from w (kappa, d) over zwin (tau, d), at
    global steps ``t0+1 .. t0+tau``: one window-kernel launch at (1, tau,
    d).  Returns ``(delta, w_end)``, ``delta = w - w_end`` (paper eq. 7), as
    ``repro.core.vq.window_displacement`` does."""
    tau, d = zwin.shape
    if not ops.window_fits(w.shape[0], d):
        raise ValueError(f"the window kernel does not fit a ({w.shape[0]}, "
                         f"{d}) codebook in the shared-memory budget")
    eps = vq.default_steps(torch.arange(t0 + 1, t0 + tau + 1,
                                        device=w.device),
                           eps0=eps0, decay=decay)
    w_end = ops.vq_window(zwin.unsqueeze(0).contiguous(), w, eps)[0]
    return w - w_end, w_end


def _rows(stream: torch.Tensor, pos: int, tau: int) -> torch.Tensor:
    """Points ``pos .. pos+tau-1`` of one worker's (n, d) stream, wrapping
    at n."""
    n = stream.shape[0]
    p = pos % n
    if p + tau <= n:
        return stream[p:p + tau]
    parts, left = [], tau
    while left:
        take = min(left, n - p)
        parts.append(stream[p:p + take])
        left -= take
        p = 0
    return torch.cat(parts)


def run_async_vq(data: torch.Tensor, w0: torch.Tensor, *, tau: int = 10,
                 duration_s: float = 2.0, eps0: float = 0.5,
                 decay: float = 1.0,
                 comm_delay_s: float | Callable[[int], float] = 0.0,
                 straggler: dict[int, float] | None = None):
    """Run M worker threads + 1 reducer for ``duration_s`` wall seconds.

    data: (M, n, d) f32 per-worker streams; w0: (kappa, d) initial
    prototypes, on data's device.  ``comm_delay_s``: per-round
    communication latency (a float or f(worker)).  ``straggler``:
    {worker_id: compute-slowdown-multiplier}.

    Returns (w_final, per-worker WorkerStats, distortion_trace) where
    distortion_trace is [(t_seconds, distortion-of-shared-version), ...].
    """
    m, n, d = data.shape
    dev = data.device
    store = BlobStore(w0.to(dev, torch.float32))
    inbox: queue.Queue = queue.Queue(maxsize=INBOX_PER_WORKER * m)
    stop = threading.Event()          # the workers' signal
    workers_done = threading.Event()  # the reducer's: drain, then exit
    stats = [WorkerStats() for _ in range(m)]
    global_step = [0]  # drives the shared Robbins-Monro schedule
    step_lock = threading.Lock()
    errors: list[BaseException] = []
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def reserve(k: int) -> int:
        """The global step before ``k`` consecutive ones taken now."""
        with step_lock:
            t0 = global_step[0]
            global_step[0] += k
        return t0

    def delay_of(i: int) -> float:
        return comm_delay_s(i) if callable(comm_delay_s) else comm_delay_s

    def guarded(fn):
        """``fn`` on the caller's stream; an exception stops the run and is
        kept for the caller."""
        def body(*args):
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    fn(*args)
            except Exception as e:  # noqa: BLE001 - raised by the caller
                errors.append(e)
                stop.set()
        return body

    def put(item) -> bool:
        """Push into the inbox, waiting while it is full; False once a
        thread has failed."""
        while not errors:
            try:
                inbox.put(item, timeout=0.01)
                return True
            except queue.Full:
                continue
        return False

    def worker(i: int) -> None:
        version, w = store.get()
        slow = (straggler or {}).get(i, 1.0)
        pos = 0
        while not stop.is_set():
            # --- tau local sequential VQ steps (eq. 1), one launch --------
            zwin = _rows(data[i], pos, tau)
            delta, _ = worker_round(w, zwin, reserve(tau), eps0=eps0,
                                    decay=decay)
            pos += tau
            stats[i].points += tau
            if slow > 1.0:
                time.sleep(tau * 1e-5 * (slow - 1.0))
            # --- push delta, pull shared (no barrier; eq. 9) -------------
            if delay_of(i):
                time.sleep(delay_of(i))
            if not put((i, delta)):
                return
            stats[i].pushes += 1
            stats[i].inbox_peak = max(stats[i].inbox_peak, inbox.qsize())
            new_version, w = store.get()
            if new_version == version:
                stats[i].stale_reads += 1
            version = new_version

    def reducer() -> None:
        while not (workers_done.is_set() and inbox.empty()) and not errors:
            try:
                _, delta = inbox.get(timeout=0.01)
            except queue.Empty:
                continue
            # eq. (9) 4th line, one message at a time, atomically
            store.apply(lambda w_srd: w_srd - delta)

    threads = [threading.Thread(target=guarded(worker), args=(i,),
                                name=f"vq-worker-{i}") for i in range(m)]
    red = threading.Thread(target=guarded(reducer), name="vq-reducer")
    eval_data = data.reshape(-1, d)[: min(4096, m * n)]
    # the t=0 baseline BEFORE any work
    d0 = float(kref.distortion_ref(eval_data, store.get()[1]))
    trace = [(0.0, d0)]
    t0 = time.perf_counter()
    red.start()
    for th in threads:
        th.start()
    try:
        while time.perf_counter() - t0 < duration_s and not stop.is_set():
            time.sleep(duration_s / 20)
            _, w_now = store.get()
            trace.append((time.perf_counter() - t0,
                          float(kref.distortion_ref(eval_data, w_now))))
    finally:
        stop.set()
        for th in threads:
            th.join()
        # every pushed delta is merged before the final read
        workers_done.set()
        red.join()
    if errors:
        raise errors[0]
    _, w_final = store.get()
    return w_final, stats, trace
