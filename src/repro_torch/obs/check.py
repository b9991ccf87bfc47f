"""Trace-invariant checker for exported Chrome trace-event files.

The port's own copy of ``repro/obs/check.py``.

Invariants (the structural contract downstream tooling relies on):

1. the file is valid Chrome trace-event JSON (``traceEvents`` list);
2. spans are *balanced* — every ``"X"`` span was closed (no
   ``unclosed`` marker, non-negative duration);
3. every ``merge`` span carries a ``tier`` attr (``0``/``1``, or
   ``"flat"`` for untiered transports) and an integral
   ``wire_bytes >= 0`` attr;
4. per (pid, tid) track, same-track spans nest properly — a span
   either contains or is disjoint from its successors (Perfetto
   renders overlapping same-track spans misleadingly);
5. metadata names every pid/tid that events reference.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.check out.trace.json \
        [--expect-merge-tiers 0,1] [--expect-counter codebook_divergence] \
        [--expect-span chaos_kill]

Exit 0 = all invariants hold, 1 = violations (listed on stdout).
"""

from __future__ import annotations

import argparse
import json
from typing import Any


def load_trace(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):            # bare-array form is also legal
        return doc
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events


def check_trace(events: list[dict[str, Any]], *,
                expect_merge_tiers: set[str] | None = None,
                expect_counters: list[str] | None = None,
                expect_spans: list[str] | None = None) -> list[str]:
    """Return a list of human-readable violations (empty = clean)."""
    errors: list[str] = []
    named_pids: set[int] = set()
    named_tids: set[tuple[int, int]] = set()
    seen_merge_tiers: set[str] = set()
    seen_counters: set[str] = set()
    seen_spans: set[str] = set()
    by_track: dict[tuple[int, int], list[dict]] = {}

    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            elif ev.get("name") == "thread_name":
                named_tids.add((ev.get("pid"), ev.get("tid")))
            continue
        if ph == "C":
            seen_counters.add(ev.get("name", ""))
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"event {i}: counter {ev.get('name')!r} "
                              f"has no numeric ts")
            continue
        if ph in ("B", "E"):
            errors.append(f"event {i}: begin/end pair event ({ph}) — "
                          f"exporter must emit complete 'X' spans only")
            continue
        if ph != "X":
            continue
        name = ev.get("name", "")
        seen_spans.add(name)
        args = ev.get("args") or {}
        if args.get("unclosed"):
            errors.append(f"event {i}: span {name!r} was never closed")
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or dur < 0:
            errors.append(f"event {i}: span {name!r} has bad dur={dur!r}")
            continue
        if name == "merge":
            tier = args.get("tier")
            if tier is None:
                errors.append(f"event {i}: merge span missing 'tier' attr")
            else:
                seen_merge_tiers.add(str(tier))
            wb = args.get("wire_bytes")
            if not isinstance(wb, (int, float)) or wb < 0:
                errors.append(f"event {i}: merge span has bad "
                              f"wire_bytes={wb!r}")
        by_track.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)

    # referenced pids/tids must be named by metadata
    for (pid, tid), evs in by_track.items():
        if pid not in named_pids:
            errors.append(f"pid {pid} has spans but no process_name metadata")
        if (pid, tid) not in named_tids:
            errors.append(f"pid {pid} tid {tid} has spans but no "
                          f"thread_name metadata")
        # same-track spans must nest or be disjoint (small tolerance for
        # float microsecond rounding)
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        stack: list[tuple[float, float, str]] = []
        for ev in evs:
            s, e = ev["ts"], ev["ts"] + ev["dur"]
            while stack and s >= stack[-1][1] - 1e-6:
                stack.pop()
            if stack and e > stack[-1][1] + 1e-6:
                errors.append(
                    f"track pid={pid} tid={tid}: span {ev['name']!r} "
                    f"[{s:.1f}, {e:.1f}]us straddles enclosing "
                    f"{stack[-1][2]!r} ending at {stack[-1][1]:.1f}us")
                continue
            stack.append((s, e, ev["name"]))

    if expect_merge_tiers is not None:
        missing = expect_merge_tiers - seen_merge_tiers
        if missing:
            errors.append(f"expected merge tiers {sorted(missing)} absent "
                          f"(saw {sorted(seen_merge_tiers) or 'none'})")
    for cname in expect_counters or []:
        if cname not in seen_counters:
            errors.append(f"expected counter series {cname!r} absent "
                          f"(saw {sorted(seen_counters) or 'none'})")
    for sname in expect_spans or []:
        if sname not in seen_spans:
            errors.append(f"expected span {sname!r} absent "
                          f"(saw {sorted(seen_spans) or 'none'})")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace-event JSON file")
    ap.add_argument("--expect-merge-tiers", default=None,
                    help="comma-separated tier attrs that must appear on "
                         "merge spans (e.g. '0,1' or 'flat')")
    ap.add_argument("--expect-counter", action="append", default=[],
                    help="counter series that must be present (repeatable)")
    ap.add_argument("--expect-span", action="append", default=[],
                    help="span names that must be present, e.g. "
                         "'chaos_kill' (repeatable)")
    args = ap.parse_args(argv)

    try:
        events = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"FAIL {args.trace}: unreadable trace: {e}")
        return 1
    tiers = (set(args.expect_merge_tiers.split(","))
             if args.expect_merge_tiers else None)
    errors = check_trace(events, expect_merge_tiers=tiers,
                         expect_counters=args.expect_counter,
                         expect_spans=args.expect_span)
    n_spans = sum(1 for e in events if e.get("ph") == "X")
    n_counters = sum(1 for e in events if e.get("ph") == "C")
    if errors:
        for err in errors:
            print(f"FAIL {err}")
        print(f"{args.trace}: {len(errors)} violation(s) over "
              f"{n_spans} spans")
        return 1
    print(f"OK {args.trace}: {n_spans} spans, {n_counters} counter "
          f"samples, invariants hold")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
