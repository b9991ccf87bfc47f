"""Roofline-attributed profiling: decompose a run's measured wall into cost
terms.  The port's copy of ``repro/obs/profile.py``.

Each run's measured wall is decomposed per window against the three-term
roofline

* ``compute``    — the VQ inner loop's hand-counted FLOPs
  (``VqCell.window_flops``) over the H100's f32 peak,
* ``memory``     — its hand-counted HBM traffic
  (``VqCell.window_hbm_bytes``) over HBM bandwidth,
* ``collective`` — the run's merge and eval bytes from its ``CommRecord``s
  (``distributed.comm_analysis``, the substitute for the reference's HLO
  parse) over the collective bandwidth,

plus an explicit ``host`` residual: the measured wall the modeled terms do
not explain.  The residual is clamped at zero, so attribution can
under-explain the wall, but ``consistency`` rises above 0 when the modeled
terms overshoot it, which is what catches a wrong hand count.  On the card
``host`` is everything the model leaves out, not only host time: it holds
device time the hand counts miss too, such as the eager eval's GEMM and
elementwise passes (ROADMAP queue 3, F2) and the launches' gaps.  The
constants are ``distributed.roofline``'s.

**The terms are per card.**  ``VqCell`` counts one worker.  The reference
runs one worker per device, so a worker's terms are its device's.  The port
stacks M workers on one card, where they share its FLOP and byte rates:
``note_segment(workers_per_device=)`` takes how many workers share the
device (M for stacked workers; for one worker a process the ranks that
share the card, ``process_group.ranks_per_device``), and the
compute, memory and collective terms, ``window_flops`` and
``window_hbm_bytes`` are that many times the per-worker ones.
``collective_bytes_per_window`` stays per worker, the unit of the
``CommLog``.  At one worker a device the arithmetic is the reference's to
the bit.

Wiring: ``MeshExecutor`` (and ``ElasticMeshExecutor``, which shares one
profiler across its per-M segment executors) calls

* ``record_program(key, records, loops)`` on an executor's first run of a
  program key (scheme, route, transport, topology and shapes): the run's
  records before the dynamic merge's re-pricing and its loop structure;
* ``note_segment(...)``                   per executed run or segment;
* ``finish_run(wall_s)``                  once the run's wall is measured,
  ended by a device sync.

``finish_run`` emits ``roofline_efficiency{term=}`` gauges and
``attributed_*_ns`` counters through the shared ``MetricsRegistry`` and
appends an attribution record (exported by ``--profile PROF.json``).  A
program's ``cost_flops`` and ``cost_bytes`` are None, as the reference
records them for a backend without ``cost_analysis``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.distributed import comm_analysis, roofline
from repro_torch.distributed.roofline import VqCell, vq_roofline_terms

TERMS = ("compute", "memory", "collective", "host")


@dataclasses.dataclass
class ProgramCost:
    """Cost facts of one program: its collective bytes and loops."""

    key: str
    collective_bytes: float            # whole run, every window
    bytes_by_kind: dict[str, float]
    loops: list[tuple[str, int]]       # (loop, trip count)
    cost_flops: float | None           # no compiler cost model: None
    cost_bytes: float | None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Profiler:
    """Per-run cost attribution against the three-term roofline.

    Engine-agnostic: holds no tensor, only the programs' collective facts
    and the shapes the engine reports.  Attach the run's
    ``MetricsRegistry`` to also publish gauges and counters.
    """

    def __init__(self, *, metrics=None):
        self.metrics = metrics
        self.programs: dict[str, ProgramCost] = {}
        self.attributions: list[dict] = []
        self._pending: list[dict] = []

    # -- engine-facing hooks -------------------------------------------------

    def record_program(self, key: Any, records, loops) -> ProgramCost:
        """A program's ``CommRecord``s and loops (its first run)."""
        coll = comm_analysis.analyze_collectives(records, loops)
        pc = ProgramCost(
            key=str(key),
            collective_bytes=float(coll["total_bytes"]),
            bytes_by_kind=dict(coll["bytes_by_kind"]),
            loops=list(coll["loops"]),
            cost_flops=None, cost_bytes=None)
        self.programs[pc.key] = pc
        return pc

    def note_segment(self, *, program: Any, scheme: str, transport: str,
                     topology: str, m: int, n_windows: int, d: int,
                     kappa: int, tau: int, n_eval: int = 0,
                     compiled: bool = False,
                     workers_per_device: int = 1) -> None:
        """Report one executed segment's shapes (a whole run for the fixed-M
        executor; one per-M slice for an elastic run), and how many workers
        share its device."""
        self._pending.append(dict(
            program=str(program), scheme=scheme, transport=transport,
            topology=topology, m=int(m), n_windows=max(int(n_windows), 1),
            d=int(d), kappa=int(kappa), tau=int(tau), n_eval=int(n_eval),
            compiled=bool(compiled),
            workers_per_device=int(workers_per_device)))

    def finish_run(self, wall_s: float) -> dict | None:
        """Attribute one run's measured wall across the pending segments.

        Per-window terms from each segment's ``VqCell`` (the collective term
        from that segment's recorded program, the analytic dense merge
        otherwise), times the workers sharing its device, are combined
        weighted by window count; the ``host`` term is the clamped residual,
        so ``sum(terms) == window wall`` exactly unless the model
        overshoots.
        """
        segs, self._pending = self._pending, []
        if not segs or wall_s <= 0:
            return None
        total_windows = sum(s["n_windows"] for s in segs)
        window_wall = wall_s / total_windows

        t = {"compute": 0.0, "memory": 0.0, "collective": 0.0}
        flops = hbm = coll_bytes = 0.0
        for s in segs:
            cell = VqCell(d=s["d"], kappa=s["kappa"], tau=s["tau"],
                          n_eval=s["n_eval"])
            prog = self.programs.get(s["program"])
            coll_per_win = (prog.collective_bytes / s["n_windows"]
                            if prog is not None else None)
            terms = vq_roofline_terms(
                cell, collective_bytes_per_window=coll_per_win)
            w = s["n_windows"] / total_windows
            per_dev = s["workers_per_device"]
            for k in t:
                t[k] += terms[f"t_{k}"] * per_dev * w
            flops += terms["window_flops"] * per_dev * w
            hbm += terms["window_hbm_bytes"] * per_dev * w
            coll_bytes += terms["collective_bytes"] * w

        modeled = sum(t.values())
        t["host"] = max(window_wall - modeled, 0.0)
        attributed = modeled + t["host"]
        consistency = abs(attributed - window_wall) / window_wall
        first = segs[0]
        rec = {
            "scheme": first["scheme"],
            "transport": first["transport"],
            "topology": first["topology"],
            "m": first["m"],
            "segments": len(segs),
            "n_windows": total_windows,
            "tau": first["tau"],
            "d": first["d"],
            "kappa": first["kappa"],
            "wall_s": wall_s,
            "window_wall_s": window_wall,
            **{f"t_{k}_s": v for k, v in t.items()},
            "attributed_window_s": attributed,
            "consistency": consistency,
            "efficiency": {k: (v / window_wall if window_wall > 0 else 0.0)
                           for k, v in t.items()},
            "window_flops": flops,
            "window_hbm_bytes": hbm,
            "collective_bytes_per_window": coll_bytes,
            "compiled_in_run": any(s["compiled"] for s in segs),
            "workers_per_device": first["workers_per_device"],
            "peaks": {"flops": roofline.PEAK_FLOPS,
                      "hbm_bw": roofline.HBM_BW,
                      "collective_bw": roofline.COLLECTIVE_BW},
        }
        self.attributions.append(rec)
        if self.metrics is not None:
            labels = {"scheme": first["scheme"],
                      "transport": first["transport"]}
            for k in TERMS:
                self.metrics.gauge("roofline_efficiency", term=k,
                                   **labels).set(rec["efficiency"][k])
                self.metrics.counter(f"attributed_{k}_ns", **labels).inc(
                    t[k] * total_windows * 1e9)
        return rec

    # -- export --------------------------------------------------------------

    def as_dict(self) -> dict:
        return {
            "attributions": self.attributions,
            "programs": {k: p.as_dict() for k, p in self.programs.items()},
        }

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)

    def summary_table(self) -> str:
        """Aligned per-run attribution table (for ``--profile`` stdout)."""
        if not self.attributions:
            return "(no profiled runs)"
        hdr = (f"{'scheme':<12} {'wall_s':>9} {'win_us':>9} "
               f"{'compute%':>9} {'memory%':>8} {'collective%':>12} "
               f"{'host%':>7} {'consistency':>12}")
        lines = [hdr, "-" * len(hdr)]
        for r in self.attributions:
            eff = r["efficiency"]
            lines.append(
                f"{r['scheme']:<12} {r['wall_s']:>9.4f} "
                f"{r['window_wall_s'] * 1e6:>9.1f} "
                f"{eff['compute'] * 100:>8.3f}% {eff['memory'] * 100:>7.3f}% "
                f"{eff['collective'] * 100:>11.3f}% {eff['host'] * 100:>6.1f}% "
                f"{r['consistency']:>12.4f}")
        return "\n".join(lines)
