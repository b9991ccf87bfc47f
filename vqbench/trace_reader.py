"""Reduces a ``torch.profiler`` Chrome trace to what the per-layer metrics
read: the device's activities inside the traced window, its busy time (the
union of those activities), the kernels by name, and the idle gaps with
what the host was doing in each.

The traced window is the benchmark's own ``record_function`` span around
the traced jobs (``WINDOW_SPAN``).  Device activities are the trace's
kernels, copies and sets; a gap is an interval of the window in which none
of them runs, named by the innermost host event that covers its middle
(an operator, a runtime call such as ``cudaStreamSynchronize``), or
``python`` where none does.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re

WINDOW_SPAN = "vqbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclasses.dataclass
class Trace:
    """The traced window, in microseconds of the trace's clock."""

    start_us: float
    end_us: float
    device: list            # (name, cat, start_us, dur_us), clipped
    gaps: list              # (label, start_us, dur_us)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return _union_us([(s, s + d) for _, _, s, d in self.device]) * 1e-6

    def kernels(self, pattern: str) -> list:
        """(name, start_us, dur_us) of the kernels whose name matches."""
        rx = re.compile(pattern)
        return [(n, s, d) for n, c, s, d in self.device
                if c == "kernel" and rx.search(n)]

    def top_device_ops(self, k: int = 10) -> list:
        """[[short name, seconds], ...]: the device operations that took most
        time, summed by name."""
        by = {}
        for n, _, _, d in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def top_idle_gaps(self, k: int = 10) -> list:
        """[[host activity, seconds], ...]: the idle time of the window summed
        by what the host was doing, longest first."""
        by = {}
        for label, _, d in self.gaps:
            by[label] = by.get(label, 0.0) + d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _cat(ev: dict) -> str:
    return str(ev.get("cat", "")).lower()


def read(path) -> Trace:
    """The traced window of a Chrome trace file written by
    ``torch.profiler.profile.export_chrome_trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and _cat(e) == "user_annotation" and e.get("name") == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device = []
    for e in events:
        if e.get("ph") != "X" or _cat(e) not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s2, e2 = max(s, lo), min(s + d, hi)
        if e2 > s2:
            device.append((str(e.get("name", "")), _cat(e), s2, e2 - s2))
    host = sorted(
        (float(e["ts"]), float(e.get("dur", 0.0)), str(e.get("name", "")))
        for e in events if e.get("ph") == "X" and _cat(e) in HOST_CATS
        and e.get("name") != WINDOW_SPAN)
    busy = _merged([(s, s + d) for _, _, s, d in device])
    gaps, at = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > at:
            gaps.append((at, s - at))
        at = max(at, e)
    starts = [s for s, _, _ in host]
    labelled = [(_host_label(host, starts, s + d / 2), s, d)
                for s, d in gaps]
    return Trace(start_us=lo, end_us=hi, device=device, gaps=labelled)


def _host_label(host: list, starts: list, t: float, *,
                look_back: int = 256) -> str:
    """The innermost of the host events that cover time t among the
    ``look_back`` that started last before it."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, d, name in host[max(0, i - look_back):i]:
        if s + d >= t and (best is None or d < best[0]):
            best = (d, name)
    return best[1] if best else "python"
