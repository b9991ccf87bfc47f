"""``ThreadExecutor``: the real-thread CloudDALVQ runtime as a backend.

Counterpart of ``repro/engine/threads.py``.  It wraps
``core.async_runtime.run_async_vq`` (worker threads, a dedicated reducer
and a versioned store on the card, no barrier anywhere) behind the
Executor API.  Only the asynchronous delta scheme exists here: threads
with a barrier would just be a slow simulation, so 'average' and 'delta'
raise.

Real threads have no tick clock: ``wall_ticks`` in the returned
``SchemeResult`` holds wall-clock SECONDS (float) instead of ticks.
``generator`` and ``lengths`` are accepted and ignored (the threads' own
timing is the network), as the reference ignores ``key``.  ``tracer=`` /
``metrics=`` get the ``run`` span, the distortion samples as a counter
series on the wall timeline, the ``run_wall_s`` and ``distortion``
histograms, ``async_rounds_total`` (the pushes) and ``stale_reads_total``.
"""

from __future__ import annotations

import time

import torch

from repro_torch import device as device_lib
from repro_torch.core import async_runtime
from repro_torch.core.schemes import SchemeResult
from repro_torch.engine import api
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer


class ThreadExecutor:
    """Real worker threads + a reducer thread (async_delta only)."""

    name = "thread"

    def __init__(self, *, duration_s: float = 2.0, comm_delay_s: float = 0.0,
                 straggler: dict[int, float] | None = None,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 device: str | torch.device | None = None):
        self.duration_s = duration_s
        self.comm_delay_s = comm_delay_s
        self.straggler = straggler
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.device = device_lib.resolve(device)
        # per-worker WorkerStats of the last run
        self.last_stats: list[async_runtime.WorkerStats] = []

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        api.validate_scheme(scheme)
        if scheme != "async_delta":
            raise ValueError(
                f"ThreadExecutor only runs 'async_delta' (the thread pool "
                f"has no barrier to express {scheme!r}); use SimExecutor or "
                f"MeshExecutor for the synchronous schemes")
        # the runtime evaluates on its own data slice; its timing is real
        del eval_data, generator, lengths
        t_wall = time.perf_counter()
        with self.tracer.span("run", scheme=scheme, executor=self.name,
                              m=data.shape[0]):
            w, stats, trace = async_runtime.run_async_vq(
                data.to(self.device, torch.float32).contiguous(),
                w0.to(self.device, torch.float32), tau=tau,
                duration_s=self.duration_s, eps0=eps0, decay=decay,
                comm_delay_s=self.comm_delay_s, straggler=self.straggler)
        self.last_stats = stats
        wall_s = time.perf_counter() - t_wall
        if self.metrics is not None:
            mt = self.metrics
            mt.histogram("run_wall_s", executor=self.name,
                         scheme=scheme).observe(wall_s)
            h = mt.histogram("distortion", scheme=scheme)
            for _, c in trace:
                h.observe(float(c))
            mt.counter("async_rounds_total", scheme=scheme).inc(
                sum(s.pushes for s in stats))
            mt.counter("stale_reads_total", scheme=scheme).inc(
                sum(s.stale_reads for s in stats))
        # real wall samples: they land on the wall timeline, in us
        for t, c in trace:
            self.tracer.counter("distortion", float(c), ts_us=t * 1e6,
                                process=self.tracer.WALL_PROCESS)
        return SchemeResult(
            w_shared=w,
            wall_ticks=torch.tensor([t for t, _ in trace],
                                    dtype=torch.float32),
            distortion=torch.tensor([c for _, c in trace],
                                    dtype=torch.float32))
