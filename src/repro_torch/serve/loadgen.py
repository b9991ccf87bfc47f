"""Open-loop load generator for the quantization service.

Counterpart of ``repro/serve/loadgen.py``.  A request's inter-arrival gap
is one communication round of a tau=1 worker under the engine's
``NetworkModel`` (``engine/network.py``): ``GeometricDelayNetwork`` gives
the paper's Section-4 cloud arrivals (1 + Geometric(p) ticks),
``InstantNetwork`` back-to-back saturating load, and ``tick_s`` converts
ticks to seconds.

The generator is OPEN-LOOP: requests are submitted at their scheduled
times whether or not earlier ones completed, and latency is measured from
the *scheduled* arrival, so a backed-up service cannot hide its queueing
delay by slowing the generator down.  Queries are N(0, 1), drawn with the
arrival gaps from one explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.async_vq import seeded
from repro_torch.engine.network import InstantNetwork, NetworkModel
from repro_torch.serve.codebook_store import CodebookStore
from repro_torch.serve.service import QuantizeResponse, QuantizeService


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """What an open-loop run observed."""

    requests: int
    rows: int
    failed: int
    wall_s: float
    qps: float                   # completed requests / wall second
    rows_per_s: float            # completed rows / wall second
    p50_ms: float                # latency percentiles from SCHEDULED arrival
    p99_ms: float
    mean_ms: float
    versions_min: int            # served codebook versions (monotonicity:
    versions_max: int            #   checked in submission order)
    versions_monotonic: bool
    n_versions: int              # distinct versions served
    staleness_max: int           # latest store version at completion - served
    staleness_mean: float
    # the first ``sample`` requests' (query, response) pairs, None where the
    # request failed
    samples: tuple = ()

    def summary(self) -> str:
        return (f"{self.requests} req ({self.rows} rows, "
                f"{self.failed} failed) in {self.wall_s:.2f}s: "
                f"{self.qps:,.0f} q/s {self.rows_per_s:,.0f} rows/s, "
                f"p50 {self.p50_ms:.2f}ms p99 {self.p99_ms:.2f}ms, "
                f"versions {self.versions_min}..{self.versions_max}"
                f" (monotonic={self.versions_monotonic}, "
                f"max staleness {self.staleness_max})")


def arrival_gaps_s(network: NetworkModel, n: int, *, tick_s: float,
                   generator: torch.Generator | None = None) -> np.ndarray:
    """(n,) inter-arrival gaps in seconds from one tau=1 round per request."""
    ticks = network.round_lengths(seeded(generator), 1, n, 1)[0].numpy()
    return ticks.astype(np.float64) * tick_s


def run_load(service: QuantizeService, *, n_requests: int, d: int,
             rows_per_request: int = 1, network: NetworkModel | None = None,
             tick_s: float = 0.0, generator: torch.Generator | None = None,
             store: CodebookStore | None = None, timeout_s: float = 120.0,
             sample: int = 0) -> LoadReport:
    """Drive ``service`` with ``n_requests`` open-loop requests.

    ``tick_s=0`` (or ``InstantNetwork``) submits back-to-back: the
    saturating-throughput configuration.  ``store`` defaults to the
    service's own store and feeds the staleness measurement.  ``sample``
    keeps the first that many (query, response) pairs in the report."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    network = network or InstantNetwork()
    store = store or service.store
    gen = seeded(generator)
    queries = torch.randn((n_requests, rows_per_request, d),
                          generator=gen).numpy()
    gaps = arrival_gaps_s(network, n_requests, tick_s=tick_s, generator=gen)

    futures, scheduled = [], []
    done_at = [0.0] * n_requests
    latest_at_done = [0] * n_requests

    def _mark(i):
        def cb(_fut):
            done_at[i] = time.monotonic()
            latest_at_done[i] = store.version

        return cb

    t0 = time.monotonic()
    next_t = t0
    for i in range(n_requests):
        next_t += gaps[i]
        now = time.monotonic()
        if next_t > now:
            time.sleep(next_t - now)
        scheduled.append(max(next_t, t0))
        fut = service.submit(queries[i])
        fut.add_done_callback(_mark(i))
        futures.append(fut)

    failed = 0
    responses: list[QuantizeResponse | None] = []
    for fut in futures:
        try:
            responses.append(fut.result(timeout=timeout_s))
        except Exception:  # noqa: BLE001 - counted, not raised
            responses.append(None)
            failed += 1
    wall_s = time.monotonic() - t0

    lat_ms, versions, staleness = [], [], []
    for i, resp in enumerate(responses):
        if resp is None:
            continue
        if done_at[i] == 0.0:
            # Future.result() can wake before the done-callback stamped the
            # completion time; stamping now is a tight upper bound
            done_at[i] = time.monotonic()
            latest_at_done[i] = store.version
        lat_ms.append((done_at[i] - scheduled[i]) * 1e3)
        versions.append(resp.version)
        staleness.append(max(0, latest_at_done[i] - resp.version))
    ok = len(lat_ms)
    lat = np.asarray(lat_ms) if ok else np.asarray([0.0])
    versions_arr = np.asarray(versions) if ok else np.asarray([0])
    stale = np.asarray(staleness) if ok else np.asarray([0])
    return LoadReport(
        requests=n_requests,
        rows=n_requests * rows_per_request,
        failed=failed,
        wall_s=wall_s,
        qps=ok / wall_s if wall_s > 0 else 0.0,
        rows_per_s=ok * rows_per_request / wall_s if wall_s > 0 else 0.0,
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        mean_ms=float(np.mean(lat)),
        versions_min=int(versions_arr.min()),
        versions_max=int(versions_arr.max()),
        versions_monotonic=bool(np.all(np.diff(versions_arr) >= 0)),
        n_versions=int(len(np.unique(versions_arr))),
        staleness_max=int(stale.max()),
        staleness_mean=float(stale.mean()),
        samples=tuple(zip(queries[:sample], responses[:sample])),
    )
