"""Counters, gauges, and streaming histograms behind one registry.

The port's own copy of ``repro/obs/metrics.py``, with one addition:
``Histogram.observe_many`` and ``Gauge.set_many`` take a run's values in
one numpy pass (an executor emits tens of thousands after a full-depth
run; one Python call each would cost the run a percent of its wall).

Metric names are dotted strings plus optional labels
(``wire_bytes{tag=merge, tier=1}``).  Three instrument kinds:

* ``Counter`` — monotone accumulator (``inc``): wire bytes, staleness
  windows, resize events.
* ``Gauge`` — last-value-wins with min/max/count: queue depth, fill rate,
  codebook divergence per window.
* ``Histogram`` — streaming log-bucketed distribution with p50/p99.
  Buckets are geometric with ratio ``2**(1/8)`` (~9%/bucket), so
  quantiles carry a bounded ~4.5% relative error at O(1) memory —
  no sample retention, negligible hot-path cost.

Export is an append-only JSONL sink (one object per metric per ``dump``
call, stamped with a run label) that tooling can consume line by line,
plus ``summary_table()`` for the end-of-run report ``launch/train.py`` /
``serve.py`` print.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any

import numpy as np

_BUCKET_LOG = math.log(2.0) / 8.0       # geometric buckets, ratio 2**(1/8)


class Counter:
    """Monotone accumulator."""

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self) -> dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-value-wins sample with range tracking."""

    kind = "gauge"

    def __init__(self):
        self.value = 0.0
        self.n = 0
        self.min = math.inf
        self.max = -math.inf

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.n += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def set_many(self, values) -> None:
        """``set`` of each value in order."""
        v = np.asarray(values, np.float64).ravel()
        if not v.size:
            return
        self.value = float(v[-1])
        self.n += v.size
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))

    def snapshot(self) -> dict[str, Any]:
        return {"value": self.value, "n": self.n,
                "min": self.min if self.n else 0.0,
                "max": self.max if self.n else 0.0}


class Histogram:
    """Streaming log-bucketed histogram (p50/p99 within ~4.5%)."""

    kind = "histogram"

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict[int, int] = {}   # bucket index -> count

    @staticmethod
    def _bucket(v: float) -> int:
        # bucket 0 holds all v <= 0 (and denormal-tiny values)
        if v <= 1e-12:
            return -(10 ** 6)
        return int(math.floor(math.log(v) / _BUCKET_LOG))

    @staticmethod
    def _bucket_value(b: int) -> float:
        if b <= -(10 ** 6):
            return 0.0
        # geometric-mean representative of the bucket
        return math.exp((b + 0.5) * _BUCKET_LOG)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = self._bucket(v)
        self._buckets[b] = self._buckets.get(b, 0) + 1

    def observe_many(self, values) -> None:
        """``observe`` of each value, in one numpy pass: the same count,
        min, max and buckets; the total is numpy's sum, which may differ
        from the sequential one in the last bits."""
        v = np.asarray(values, np.float64).ravel()
        if not v.size:
            return
        self.count += v.size
        self.total += float(v.sum())
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        pos = v > 1e-12
        b = np.full(v.shape, -(10 ** 6), np.int64)
        b[pos] = np.floor(np.log(v[pos]) / _BUCKET_LOG).astype(np.int64)
        for k, c in zip(*np.unique(b, return_counts=True)):
            self._buckets[int(k)] = self._buckets.get(int(k), 0) + int(c)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) from the bucket stream."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if not self.count:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for b in sorted(self._buckets):
            seen += self._buckets[b]
            if seen > rank:
                # clamp the representative to the observed range so
                # single-sample and extreme quantiles are exact-ish
                return min(max(self._bucket_value(b), self.min), self.max)
        return self.max

    def snapshot(self) -> dict[str, Any]:
        return {"count": self.count, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


def _labels_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_metric(name: str, labels: dict[str, Any] | None) -> str:
    if not labels:
        return name
    inner = ", ".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Process-wide named instruments; thread-safe get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Any] = {}

    def _get(self, cls, name: str, labels: dict[str, Any]):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {format_metric(name, labels)} already registered "
                    f"as {type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> list[dict[str, Any]]:
        """One dict per metric: name, labels, kind, and current values."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for (name, lkey), metric in items:
            out.append({"name": name, "labels": dict(lkey),
                        "kind": metric.kind, **metric.snapshot()})
        return out

    def dump_jsonl(self, path: str, *, run: str | None = None,
                   append: bool = True) -> int:
        """Append one JSON line per metric to ``path``; returns line count."""
        rows = self.snapshot()
        with open(path, "a" if append else "w") as f:
            for row in rows:
                if run is not None:
                    row = {"run": run, **row}
                f.write(json.dumps(row) + "\n")
        return len(rows)

    def summary_table(self) -> str:
        """Aligned human-readable table of every registered metric."""
        rows = [("metric", "kind", "value", "p50", "p99", "n")]
        for m in self.snapshot():
            label = format_metric(m["name"], m["labels"])
            if m["kind"] == "histogram":
                rows.append((label, "hist", f"{m['mean']:.6g}",
                             f"{m['p50']:.6g}", f"{m['p99']:.6g}",
                             str(m["count"])))
            elif m["kind"] == "gauge":
                rows.append((label, "gauge", f"{m['value']:.6g}",
                             "-", "-", str(m["n"])))
            else:
                rows.append((label, "count", f"{m['value']:.6g}",
                             "-", "-", "-"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        return "\n".join(lines)


def load_jsonl(path: str) -> list[dict[str, Any]]:
    """Read a metrics JSONL sink back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
