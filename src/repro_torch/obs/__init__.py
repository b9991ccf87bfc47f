"""Observability: span tracing, a metrics registry and their exporters.

The port's own copies of ``repro/obs/{trace,metrics,check}.py``.
``Tracer`` records wall spans (monotonic clock) and modeled tick-timeline
spans, exporting Chrome trace-event JSON for Perfetto.
``MetricsRegistry`` holds counters, gauges and streaming histograms and
dumps an append-only JSONL sink.  ``check_trace`` validates a trace's
structural invariants.  The reference's roofline ``Profiler`` is not
ported yet (ROADMAP.md queue 1, item 6b).
"""

from repro_torch.obs.check import check_trace, load_trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, format_metric,
                                     load_jsonl)
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
    "SpanEvent",
    "Tracer",
    "check_trace",
    "format_metric",
    "load_jsonl",
    "load_trace",
]
