"""Observability: span tracing, a metrics registry, roofline profiling and
their exporters.

The port's own copies of ``repro/obs/{trace,metrics,check,profile,
report}.py``.  ``Tracer`` records wall spans (monotonic clock) and modeled tick-timeline
spans, exporting Chrome trace-event JSON for Perfetto.
``MetricsRegistry`` holds counters, gauges and streaming histograms and
dumps an append-only JSONL sink.  ``check_trace`` validates a trace's
structural invariants.  ``Profiler`` decomposes a mesh run's wall into
compute, memory, collective and host terms per window (``obs.profile``),
and ``python -m repro_torch.obs.report`` renders them with the
``BENCH_*.json`` baselines into one HTML page.
"""

from repro_torch.obs.check import check_trace, load_trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, format_metric,
                                     load_jsonl)
from repro_torch.obs.profile import Profiler
from repro_torch.obs.trace import (NULL_TRACER, CounterEvent, ExitFlush,
                                   SpanEvent, Tracer)

__all__ = [
    "NULL_TRACER",
    "Counter",
    "CounterEvent",
    "ExitFlush",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Profiler",
    "SpanEvent",
    "Tracer",
    "check_trace",
    "format_metric",
    "load_jsonl",
    "load_trace",
]
