"""Self-contained HTML perf-trajectory report over the BENCH family.

The port's own copy of ``repro/obs/report.py``: the same page, byte for
byte, from the same inputs.  Renders every ``BENCH_*.json`` baseline in a
directory plus any ``--profile`` export from a training run
(``obs.profile.Profiler``) into ONE static HTML file: no external
JS/CSS/fonts, every chart is inline SVG, so the file opens identically
offline.

Layout:

* a wall-time overview: every benchmark record that measured a ``wall_s``,
  as one horizontal bar chart grouped by suite;
* a roofline-attribution section (from ``BENCH_profile.json`` /
  ``--profile``): per (scheme x transport) stacked bars of the compute /
  memory / collective / host shares of the measured window wall.  Its
  caption keeps the reference's words; the port's collective bytes come
  from the run's ``CommRecord``s (``distributed.comm_analysis``), not
  from a compiled program;
* one table per suite with the raw records; numeric series (distortion
  curves, wall-sample arrays) render as inline SVG sparklines.

CLI (``--out`` defaults to ``perf_report.html`` in the current
directory)::

    python -m repro_torch.obs.report --dir . --out perf_report.html \
        [--profile PROF.json] [--title "..."]
"""

from __future__ import annotations

import argparse
import glob
import html
import json
import os

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2rem auto; max-width: 72rem; color: #1a1a2e; }
h1 { border-bottom: 3px solid #4c78a8; padding-bottom: .3rem; }
h2 { margin-top: 2.2rem; color: #16324f; }
table { border-collapse: collapse; font-size: .82rem; margin: .8rem 0; }
th, td { border: 1px solid #d7dbe0; padding: .25rem .55rem;
         text-align: right; white-space: nowrap; }
th { background: #eef2f6; position: sticky; top: 0; }
td:first-child, th:first-child { text-align: left; }
.meta { color: #5a6b7b; font-size: .85rem; }
.legend span { display: inline-block; margin-right: 1.1rem;
               font-size: .82rem; }
.swatch { display: inline-block; width: .8rem; height: .8rem;
          margin-right: .3rem; vertical-align: -0.08rem; }
svg { vertical-align: middle; }
.small { font-size: .78rem; color: #5a6b7b; }
"""

TERM_COLORS = {"compute": "#4c78a8", "memory": "#f58518",
               "collective": "#e45756", "host": "#b8c2cc"}
_BAR_COLOR = "#4c78a8"


def _esc(x) -> str:
    return html.escape(str(x))


def _fmt(v) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _is_num_list(v) -> bool:
    return (isinstance(v, list) and len(v) >= 2
            and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in v))


def sparkline(values, *, w: int = 130, h: int = 26) -> str:
    """Inline SVG polyline of a numeric series (no axes — shape only)."""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    n = len(values)
    pts = " ".join(
        f"{2 + i * (w - 4) / max(n - 1, 1):.1f},"
        f"{h - 3 - (v - lo) / span * (h - 6):.1f}"
        for i, v in enumerate(values))
    return (f'<svg width="{w}" height="{h}" role="img">'
            f'<polyline points="{pts}" fill="none" stroke="{_BAR_COLOR}" '
            f'stroke-width="1.3"/></svg>'
            f'<span class="small"> [{_fmt(lo)} .. {_fmt(hi)}]</span>')


def _bar_chart(rows, *, w: int = 640, bar_h: int = 16) -> str:
    """Horizontal labeled bar chart: rows = [(label, value_seconds)]."""
    if not rows:
        return ""
    vmax = max(v for _, v in rows) or 1.0
    gap, label_w = 6, 330
    height = len(rows) * (bar_h + gap) + gap
    parts = [f'<svg width="{w + label_w + 90}" height="{height}" role="img">']
    for i, (label, v) in enumerate(rows):
        y = gap + i * (bar_h + gap)
        bw = max(v / vmax * w, 1.0)
        parts.append(
            f'<text x="{label_w - 6}" y="{y + bar_h - 4}" '
            f'text-anchor="end" font-size="11">{_esc(label)}</text>'
            f'<rect x="{label_w}" y="{y}" width="{bw:.1f}" '
            f'height="{bar_h}" fill="{_BAR_COLOR}"/>'
            f'<text x="{label_w + bw + 5:.1f}" y="{y + bar_h - 4}" '
            f'font-size="11">{v * 1e3:.2f} ms</text>')
    parts.append("</svg>")
    return "".join(parts)


def _stacked_bar(shares: dict[str, float], *, w: int = 420,
                 h: int = 18) -> str:
    """One stacked horizontal bar of term shares (clipped into [0, 1])."""
    parts = [f'<svg width="{w}" height="{h}" role="img">'
             f'<rect x="0" y="0" width="{w}" height="{h}" fill="#f3f5f7"/>']
    x = 0.0
    for term, color in TERM_COLORS.items():
        frac = min(max(shares.get(term, 0.0), 0.0), 1.0)
        bw = frac * w
        if bw > 0.2:
            parts.append(f'<rect x="{x:.1f}" y="0" width="{bw:.1f}" '
                         f'height="{h}" fill="{color}"/>')
        x = min(x + bw, w)
    parts.append("</svg>")
    return "".join(parts)


def _records_table(records: list[dict]) -> str:
    """Union-of-keys table over a suite's result records."""
    cols: list[str] = []
    for r in records:
        for k in r:
            if k not in cols:
                cols.append(k)
    out = ["<table><tr>"]
    out += [f"<th>{_esc(c)}</th>" for c in cols]
    out.append("</tr>")
    for r in records:
        out.append("<tr>")
        for c in cols:
            v = r.get(c, "")
            if _is_num_list(v):
                cell = sparkline(v)
            elif isinstance(v, (dict, list)):
                s = json.dumps(v)
                cell = _esc(s if len(s) <= 60 else s[:57] + "...")
            else:
                cell = _esc(_fmt(v))
            out.append(f"<td>{cell}</td>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _wall_overview(docs: dict[str, dict]) -> str:
    rows = []
    for suite in sorted(docs):
        for r in docs[suite].get("results", []):
            if not isinstance(r, dict):
                continue
            wall = r.get("wall_s")
            if not isinstance(wall, (int, float)) or wall <= 0:
                continue
            bits = [suite]
            for k in ("executor", "kind", "scheme", "transport", "mode",
                      "m", "sparse_frac"):
                if r.get(k) not in (None, ""):
                    bits.append(f"{k}={r[k]}")
            rows.append((" ".join(bits), float(wall)))
    if not rows:
        return ""
    return ("<h2>Wall-time overview</h2>"
            "<p class='meta'>Every benchmark record with a measured "
            "wall_s, across all committed baselines.</p>"
            + _bar_chart(rows))


def _attribution_section(attributions: list[dict], origin: str) -> str:
    if not attributions:
        return ""
    legend = "".join(
        f'<span><span class="swatch" style="background:{c}"></span>'
        f"{t}</span>" for t, c in TERM_COLORS.items())
    out = [f"<h2>Roofline attribution <span class='meta'>({_esc(origin)})"
           "</span></h2>",
           "<p class='meta'>Measured per-window wall decomposed against "
           "the three-term roofline (analytic compute/HBM for the VQ "
           "inner loop, collective bytes from the compiled program's "
           "HLO) plus the host residual.</p>",
           f"<p class='legend'>{legend}</p>", "<table><tr>"]
    for c in ("scheme", "transport", "topology", "m", "n_windows",
              "window_wall_s", "attribution", "consistency",
              "collective_bytes_per_window", "compiled_in_run"):
        out.append(f"<th>{_esc(c)}</th>")
    out.append("</tr>")
    for a in attributions:
        eff = a.get("efficiency", {})
        out.append("<tr>")
        for c in ("scheme", "transport", "topology", "m", "n_windows"):
            out.append(f"<td>{_esc(a.get(c, ''))}</td>")
        out.append(f"<td>{_fmt(a.get('window_wall_s', 0.0))}</td>")
        out.append(f"<td>{_stacked_bar(eff)}</td>")
        out.append(f"<td>{_fmt(a.get('consistency', ''))}</td>")
        out.append(f"<td>{_fmt(a.get('collective_bytes_per_window', ''))}"
                   "</td>")
        out.append(f"<td>{_esc(a.get('compiled_in_run', ''))}</td></tr>")
    out.append("</table>")
    return "".join(out)


def render_report(docs: dict[str, dict], *, title: str = "Perf trajectory",
                  profile_runs: list[tuple[str, list[dict]]] = ()) -> str:
    """Render the full report; ``docs`` maps suite name -> BENCH doc."""
    body = [f"<h1>{_esc(title)}</h1>"]
    metas = {(d.get("devices"), d.get("backend")) for d in docs.values()}
    if metas:
        body.append("<p class='meta'>baselines: "
                    + ", ".join(f"{_esc(s)} (devices={_esc(d.get('devices'))}"
                                f", {_esc(d.get('backend'))})"
                                for s, d in sorted(docs.items())) + "</p>")
    body.append(_wall_overview(docs))
    prof_doc = docs.get("profile")
    if prof_doc:
        attrs = [r.get("attribution", r) for r in prof_doc.get("results", [])]
        attrs = [a for a in attrs if isinstance(a, dict) and "efficiency" in a]
        body.append(_attribution_section(attrs, "BENCH_profile.json"))
    for origin, attrs in profile_runs:
        body.append(_attribution_section(attrs, origin))
    for suite in sorted(docs):
        doc = docs[suite]
        recs = [r for r in doc.get("results", []) if isinstance(r, dict)]
        if not recs:
            continue
        body.append(f"<h2>{_esc(suite)}</h2>")
        body.append(_records_table(recs))
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>{''.join(body)}</body></html>")


def load_bench_dir(path: str) -> dict[str, dict]:
    """All committed ``BENCH_<suite>.json`` files (skips ``*.fresh.json``)."""
    docs: dict[str, dict] = {}
    for p in sorted(glob.glob(os.path.join(path, "BENCH_*.json"))):
        base = os.path.basename(p)
        if base.endswith(".fresh.json"):
            continue
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        docs[doc.get("suite") or base[len("BENCH_"):-len(".json")]] = doc
    return docs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=".", help="directory of BENCH_*.json")
    ap.add_argument("--out", default="perf_report.html")
    ap.add_argument("--title", default="Perf trajectory")
    ap.add_argument("--profile", action="append", default=[],
                    help="additional Profiler export(s) (PROF.json) to "
                         "render alongside the baselines")
    args = ap.parse_args(argv)
    docs = load_bench_dir(args.dir)
    runs = []
    for p in args.profile:
        with open(p) as f:
            doc = json.load(f)
        runs.append((os.path.basename(p), doc.get("attributions", [])))
    html_text = render_report(docs, title=args.title, profile_runs=runs)
    with open(args.out, "w") as f:
        f.write(html_text)
    n_attr = sum(len(a) for _, a in runs)
    print(f"wrote {args.out}: {len(docs)} baseline suites"
          + (f", {n_attr} profiled runs" if n_attr else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
