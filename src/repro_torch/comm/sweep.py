"""Scheme x transport sweeps, counterpart of ``repro/comm/sweep.py``.

Each sweep runs the port's ``MeshExecutor`` over a grid of cells on one
workload and reports, per cell, the measured per-worker merge wire bytes
(from the executor's ``last_comm``), wall seconds and the final
distortion.  The workload is made from ``seed`` through numpy (a mixture
of 10 uniform centres with N(0, 0.05^2) noise, the codebook drawn from the
points), or is the caller's ``inputs=(w0, data, eval_data)``, so a test can
feed the reference's own data and compare trigger counts.  Cells run on
``device`` (the card unless the caller asks for the CPU); on the card each
timed run ends in a device sync.  Writing ``BENCH_*.json`` files and the
regression gates over them are not ported.

  * ``run_comm_cells``: every scheme over the dense, ring and sparse
    transports; ``sparse_reduction`` and ``ring_parity`` read its cells;
  * ``run_hier_cells``: every scheme through the flat executor and a
    hierarchical one with a dense and a sparse tier 1, per-tier bytes, and
    whether the dense-tier-1 run equals the flat one bit for bit;
  * ``run_adapt_cells``, ``run_fixed_tau_legs``, ``adapt_bitmatch``: the
    dynamic merge against fixed-tau merges, with and without a quantized
    wire.
"""

from __future__ import annotations

import time

import torch

from repro_torch.data import synthetic

SCHEMES = ("average", "delta", "async_delta")
TRANSPORTS = ("xla", "ring", "sparse")
HIER_VARIANTS = ("flat", "hier_dense", "hier_sparse")
ADAPT_QUANTS = ("dense", "bf16", "int8")
# the reference's divergence threshold at the bench shape (m=8, n=240, d=8,
# kappa=16, tau=10): 18 of 24 windows trigger on its data
ADAPT_THRESH = 2e-5
ADAPT_TAUS = (5, 10, 20)
N_EVAL = 200


def acceptance_sparse_frac(kappa: int, d: int) -> float:
    """k = kappa/4 entries of the (kappa, d) displacement: frac =
    (kappa // 4) / (kappa * d) of the flattened payload."""
    return (kappa // 4) / (kappa * d)


def make_inputs(m: int, n: int, d: int, kappa: int, seed: int = 0, *,
                device="cpu"):
    """(w0 (kappa, d), data (M, n, d), eval_data (M, min(200, n), d)) f32,
    made with numpy from ``seed`` (``synthetic.numpy_mixture``)."""
    w0, data = synthetic.numpy_mixture(seed, m, n, d, kappa)
    eval_data = data[:, :min(N_EVAL, n)].contiguous()
    return tuple(t.to(device) for t in (w0, data, eval_data))


def _timed(ex, scheme, w0, data, eval_data, *, tau, repeats):
    """(result, compile-and-first-run seconds, best-of-``repeats``
    seconds, the samples).  Each run ends in a device sync."""
    def once():
        t0 = time.perf_counter()
        res = ex.run(scheme, w0, data, eval_data, tau=tau)
        res.distortion.cpu()              # waits for the device
        return res, time.perf_counter() - t0

    res, first = once()
    samples = []
    for _ in range(repeats):
        res, wall = once()
        samples.append(wall)
    return res, first, (min(samples) if samples else first), samples


def _merge(last_comm: dict) -> dict:
    return last_comm["by_tag"].get(
        "merge", {"wire_bytes": 0, "logical_bytes": 0, "calls": 0})


def run_comm_cells(*, m: int = 8, n: int = 240, d: int = 8, kappa: int = 16,
                   tau: int = 10, sparse_frac: float | None = None,
                   repeats: int = 1, seed: int = 0, inputs=None,
                   device=None) -> list[dict]:
    """Every scheme x transport cell: the config, the wall seconds and the
    measured merge wire/logical bytes."""
    from repro_torch import comm, device as device_lib
    from repro_torch.engine import InstantNetwork
    from repro_torch.engine.mesh import MeshExecutor

    dev = device_lib.resolve(device)
    w0, data, eval_data = (inputs if inputs is not None
                           else make_inputs(m, n, d, kappa, seed, device=dev))
    if sparse_frac is None:
        sparse_frac = acceptance_sparse_frac(kappa, d)
    cells = []
    for tname in TRANSPORTS:
        kwargs = {"frac": sparse_frac} if tname == "sparse" else {}
        for scheme in SCHEMES:
            ex = MeshExecutor(InstantNetwork(), device=dev,
                              transport=comm.get_transport(tname, **kwargs))
            res, first, wall, samples = _timed(ex, scheme, w0, data,
                                               eval_data, tau=tau,
                                               repeats=repeats)
            merge = _merge(ex.last_comm)
            cells.append({
                "scheme": scheme, "transport": tname,
                "m": m, "n": n, "d": d, "kappa": kappa, "tau": tau,
                "sparse_frac": sparse_frac if tname == "sparse" else None,
                "compile_s": round(first, 1), "wall_s": wall,
                "wall_samples": samples,
                "merge_wire_bytes": merge["wire_bytes"],
                "merge_logical_bytes": merge["logical_bytes"],
                "collective_calls": ex.last_comm["calls"],
                "final_C": float(res.distortion[-1]),
            })
    return cells


def sparse_reduction(cells: list[dict]) -> float:
    """Min over displacement schemes of dense (xla) wire over sparse wire
    ('average' ships means, which ride dense on every transport)."""
    wire = {(c["scheme"], c["transport"]): c["merge_wire_bytes"]
            for c in cells}
    return min(wire[(s, "xla")] / max(wire[(s, "sparse")], 1)
               for s in SCHEMES if s != "average")


def ring_parity(cells: list[dict]) -> dict[str, float]:
    """Per-scheme ring/xla wall ratios (a gate takes the min over schemes:
    noise hits single legs, a real ring slowdown hits all)."""
    wall = {(c["scheme"], c["transport"]): c["wall_s"] for c in cells}
    return {s: wall[(s, "ring")] / max(wall[(s, "xla")], 1e-12)
            for s in SCHEMES}


def run_hier_cells(*, m: int = 8, hosts: int = 2, n: int = 240, d: int = 8,
                   kappa: int = 16, tau: int = 10,
                   tier1_frac: float | None = None, repeats: int = 1,
                   seed: int = 0, inputs=None, device=None) -> list[dict]:
    """Every scheme through the flat executor and the hierarchical one
    (dense and sparse tier 1, tier 0 dense) on the same data: per-tier
    merge wire bytes, wall seconds, final distortion and, for the
    hierarchical cells, whether the run equals the flat one bit for bit."""
    from repro_torch import comm, device as device_lib
    from repro_torch.engine import InstantNetwork
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.topology import Topology

    dev = device_lib.resolve(device)
    w0, data, eval_data = (inputs if inputs is not None
                           else make_inputs(m, n, d, kappa, seed, device=dev))
    if tier1_frac is None:
        tier1_frac = acceptance_sparse_frac(kappa, d)
    topo = Topology.from_spec(m, hosts=hosts)
    wph = topo.workers_per_host

    def make_ex(variant):
        if variant == "flat":
            return MeshExecutor(InstantNetwork(), device=dev)
        tier1 = ("xla" if variant == "hier_dense"
                 else comm.get_transport("sparse", frac=tier1_frac))
        return MeshExecutor(InstantNetwork(), device=dev,
                            transport=comm.HierarchicalTransport(
                                "xla", tier1, topology=topo))

    cells, flat_final = [], {}
    for variant in HIER_VARIANTS:
        for scheme in SCHEMES:
            ex = make_ex(variant)
            res, first, wall, samples = _timed(ex, scheme, w0, data,
                                               eval_data, tau=tau,
                                               repeats=repeats)
            merge = _merge(ex.last_comm)
            by_tier = merge.get("by_tier", {})
            cell = {
                "scheme": scheme, "variant": variant,
                "hosts": hosts if variant != "flat" else 1,
                "workers_per_host": wph if variant != "flat" else m,
                "m": m, "n": n, "d": d, "kappa": kappa, "tau": tau,
                "tier1_frac": (tier1_frac if variant == "hier_sparse"
                               else None),
                "compile_s": round(first, 1), "wall_s": wall,
                "wall_samples": samples,
                "merge_wire_bytes": merge["wire_bytes"],
                "tier0_wire_bytes": by_tier.get(0, {}).get("wire_bytes", 0),
                "tier1_wire_bytes": by_tier.get(1, {}).get("wire_bytes", 0),
                "final_C": float(res.distortion[-1]),
            }
            if variant == "flat":
                flat_final[scheme] = res
            else:
                ref = flat_final[scheme]
                cell["bitmatch_flat"] = bool(
                    torch.equal(ref.w_shared, res.w_shared)
                    and torch.equal(ref.distortion, res.distortion))
            cells.append(cell)
    return cells


def hier_inter_reduction(cells: list[dict]) -> float:
    """Min over displacement schemes of the dense tier-1 wire over the
    sparse tier-1 wire ('average' ships means, dense everywhere)."""
    wire = {(c["scheme"], c["variant"]): c["tier1_wire_bytes"]
            for c in cells if c["variant"] != "flat"}
    return min(wire[(s, "hier_dense")] / max(wire[(s, "hier_sparse")], 1)
               for s in SCHEMES if s != "average")


def hier_wall_parity(cells: list[dict]) -> dict[str, float]:
    """Per-scheme hier-dense over flat wall ratios."""
    wall = {(c["scheme"], c["variant"]): c["wall_s"] for c in cells}
    return {s: wall[(s, "hier_dense")] / max(wall[(s, "flat")], 1e-12)
            for s in SCHEMES}


def _adapt_transport(quant: str):
    from repro_torch import comm
    if quant == "dense":
        return comm.get_transport("xla")
    return comm.get_transport("quant", inner="xla", mode=quant)


def _adapt_wire(last_comm: dict) -> tuple[int, int, int]:
    """(merge, probe, total) per-worker wire bytes of one run: the dynamic
    merge pays for its probe."""
    by_tag = last_comm["by_tag"]
    merge = by_tag.get("merge", {}).get("wire_bytes", 0)
    probe = by_tag.get("probe", {}).get("wire_bytes", 0)
    return merge, probe, merge + probe


def run_adapt_cells(*, m: int = 8, n: int = 240, d: int = 8,
                    kappa: int = 16, tau: int = 10,
                    thresh: float = ADAPT_THRESH, max_stale: int = 8,
                    repeats: int = 1, seed: int = 0, inputs=None,
                    device=None) -> list[dict]:
    """{fixed, dynamic} x {dense, bf16, int8} delta-merge cells on one
    workload: merge + probe wire bytes, windows triggered, wall seconds and
    the final distortion."""
    from repro_torch import device as device_lib
    from repro_torch.engine import InstantNetwork
    from repro_torch.engine.mesh import MeshExecutor

    dev = device_lib.resolve(device)
    w0, data, eval_data = (inputs if inputs is not None
                           else make_inputs(m, n, d, kappa, seed, device=dev))
    n_windows = n // tau
    cells = []
    for quant in ADAPT_QUANTS:
        for mode in ("fixed", "dynamic"):
            ex_kw = {}
            if mode == "dynamic":
                ex_kw = {"merge": "dynamic", "divergence_thresh": thresh,
                         "max_stale": max_stale}
            ex = MeshExecutor(InstantNetwork(), device=dev,
                              transport=_adapt_transport(quant), **ex_kw)
            res, first, wall, samples = _timed(ex, "delta", w0, data,
                                               eval_data, tau=tau,
                                               repeats=repeats)
            merge_w, probe_w, total_w = _adapt_wire(ex.last_comm)
            n_trig = (_merge(ex.last_comm)["calls"] if mode == "dynamic"
                      else n_windows)
            cells.append({
                "merge": mode, "quant": quant,
                "m": m, "n": n, "d": d, "kappa": kappa, "tau": tau,
                "thresh": thresh if mode == "dynamic" else None,
                "max_stale": max_stale if mode == "dynamic" else None,
                "compile_s": round(first, 1), "wall_s": wall,
                "wall_samples": samples,
                "merge_wire_bytes": merge_w, "probe_wire_bytes": probe_w,
                "total_wire_bytes": total_w,
                "n_windows": n_windows, "n_triggered": n_trig,
                "final_C": float(res.distortion[-1]),
            })
    return cells


def run_fixed_tau_legs(*, taus: tuple = ADAPT_TAUS, m: int = 8,
                       n: int = 240, d: int = 8, kappa: int = 16,
                       seed: int = 0, inputs=None, device=None) -> list[dict]:
    """Plain delta-merge legs across merge periods: the fixed-tau frontier
    the dynamic merge has to beat."""
    from repro_torch import device as device_lib
    from repro_torch.engine import InstantNetwork
    from repro_torch.engine.mesh import MeshExecutor

    dev = device_lib.resolve(device)
    w0, data, eval_data = (inputs if inputs is not None
                           else make_inputs(m, n, d, kappa, seed, device=dev))
    legs = []
    for tau in taus:
        ex = MeshExecutor(InstantNetwork(), device=dev)
        res = ex.run("delta", w0, data, eval_data, tau=tau)
        legs.append({
            "tau": tau, "m": m, "n": n, "d": d, "kappa": kappa,
            "total_wire_bytes": _adapt_wire(ex.last_comm)[2],
            "n_windows": n // tau,
            "final_C": float(res.distortion[-1]),
        })
    return legs


def best_fixed_leg(legs: list[dict]) -> dict:
    """The fixed-tau leg with the lowest final distortion."""
    return min(legs, key=lambda leg: leg["final_C"])


def adapt_dynamic_wire_ok(cells: list[dict]) -> bool:
    """Per quant level, the dynamic cell's total (merge + probe) wire is at
    most its fixed counterpart's: the probe pays for itself."""
    wire = {(c["merge"], c["quant"]): c["total_wire_bytes"] for c in cells}
    return all(wire[("dynamic", q)] <= wire[("fixed", q)]
               for q in ADAPT_QUANTS)


def adapt_bitmatch(*, m: int = 8, n: int = 240, d: int = 8,
                   kappa: int = 16, tau: int = 10, seed: int = 0,
                   inputs=None, device=None) -> bool:
    """The dynamic merge at threshold 0 over the dense wire equals the plain
    fixed-tau delta merge bit for bit."""
    from repro_torch import device as device_lib
    from repro_torch.engine import InstantNetwork
    from repro_torch.engine.mesh import MeshExecutor

    dev = device_lib.resolve(device)
    w0, data, eval_data = (inputs if inputs is not None
                           else make_inputs(m, n, d, kappa, seed, device=dev))
    ref = MeshExecutor(InstantNetwork(), device=dev).run(
        "delta", w0, data, eval_data, tau=tau)
    dyn = MeshExecutor(InstantNetwork(), device=dev, merge="dynamic",
                       divergence_thresh=0.0).run(
        "delta", w0, data, eval_data, tau=tau)
    return bool(torch.equal(ref.distortion, dyn.distortion)
                and torch.equal(ref.w_shared, dyn.w_shared))
