"""The dry run, counterpart of ``repro/launch/dryrun.py``: the comm suite,
the ``paper_vq`` cells and the LM cells.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --comm \\
        [--sparse-frac F] [--device cpu] [--out dryrun_comm.json]

Runs the scheme x transport sweeps of ``comm.sweep`` once each
(``repeats=0``) and reports the wire bytes the executor's ``CommRecord``
stream measured (shape arithmetic, not a model) in three tables:

  * COMM: every scheme over the dense, ring and sparse transports; the
    sparse wire must be at least 4x under dense for the displacement
    schemes;
  * HIER: every scheme over two host groups of four workers, a dense and a
    sparse tier 1; the sparse tier 1 must cut the inter-host wire at least
    4x;
  * ADPT: the fixed and the dynamic delta merge over the dense, bf16 and
    int8 wires; the dynamic merge's total wire (merge + probe) must stay at
    or under the fixed one's at every width.

It exits 0 when all three bars hold, 1 otherwise.  The COMM and HIER cells
run at n=200 points a worker, the cells ``BENCH_comm.json`` and
``BENCH_hier.json`` hold (the reference's dry run takes the sweeps' default
n=240), so their bytes equal those files'; the ADPT cells at n=240, as
``BENCH_adapt.json``'s.  The records go to ``--out`` (default
``dryrun_comm.json`` in the current directory), merged by key into what
the file already holds.  Cells run on ``--device`` (the card by default).

``--arch paper_vq --shape vq_stream|vq_batch`` runs one step of each
``core/dvq.py`` step at the reference's cell shape (its ``dryrun.py:
174-197``: kappa 16,384, d 512, tau 10; ``vq_batch`` at this world's share
of 2^20 points, ``--model K`` splitting the codebook over K ranks) over the
world it is started in: one process, or a torchrun world (one worker a
process, ``distributed.process_group``).  Each rank runs its step once to
warm up and once timed, between two ``device.synchronize`` calls, and rank
0 prints the step's wall, the peak device memory
(``torch.cuda.max_memory_allocated`` over what the process held before
the cell: its inputs and the step; "not measured" on the CPU), the
``CommRecord`` bytes and ``VqCell``'s compute, memory and collective terms
for each rank.  The reference lowers and compiles these cells; eager
PyTorch runs them.

The LM cells (the reference's ``build_cell`` and ``run_cell``, its lines
47-172 and 211-321)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe_1b_7b \
        --shape train_4k [--multi-pod] [--merge delta --tau 10] \
        [--quantized] [--out dryrun_lm.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 80 cells

price each (arch x shape) cell on the production layout
(``topology.production_grid``: (data, model) = (16, 16), or (pod, data,
model) = (2, 16, 16) with ``--multi-pod``; ``--both-meshes`` and ``--all``
take both), where the reference lowers and compiles on 256 / 512
placeholder devices.  Nothing is allocated: the arguments are tensors on
the ``meta`` device.  ``cell_applicable`` skips the cells the
reference skips (long_500k on full attention).  A train cell places its
state by ``sharding.param_specs`` (FSDP where ``registry.uses_fsdp``), its
optimizer state by ``opt_specs_like`` and its batch by ``batch_specs``;
with ``--merge`` on the multi-pod layout it is the reference's window
step, whose batch takes a leading tau dim and whose state the merge's
extra leaves (``delta_prev``, ``residual``).  A prefill cell also gives
its decode cache's specs, and a decode cell places the cache, the tokens
and, with ``--quantized``, the int8 weights' replicated scales.  Each
record holds the reference's keys: ``arch``, ``shape``, ``mesh``,
``merge``, ``status``, ``reason`` (a skip's), ``roofline``
(``distributed.roofline.roofline_terms`` at the H100's rates) and
``memory.argument_bytes`` (``sharding.device_bytes`` of the cell's
arguments, exact shape arithmetic) and ``collectives``: the cell's step
lowered by ``distributed.hlo_analysis.lower_cell``, the placed program
(tensor, sequence and FSDP parallelism, ``models.common.Placed``) run once
on ``meta`` shard shapes over a layout that only records, each stack cut
to one layer and its records multiplied by its layer count, in the place
of the reference's compiled HLO.  Its total over ``per_step_divisor``
(tau for a window) is the collective term (``roofline.collective_note``
"lowered"), priced at ``NVLINK_BW``.  A ``--quantized`` decode cell lowers
the bf16 step: the int8 leaves are dequantized a layer at a time on each
rank and move no other bytes.  Records merge by key into ``--out``
(default ``dryrun_lm.json``); the run exits 1 if a cell errs.
``--device`` does not matter to these cells: they touch no device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import comm
from repro_torch import device as device_lib
from repro_torch.comm import sweep
from repro_torch.configs import registry

#: points a worker of the COMM and HIER cells: ``BENCH_comm.json``'s and
#: ``BENCH_hier.json``'s
N_COMM = 200
#: The reference's ``paper_vq`` cell: codebook rows, width, window, and the
#: ``vq_batch`` step's points over the whole world.
VQ_KAPPA, VQ_D, VQ_TAU, VQ_BATCH = 16384, 512, 10, 1 << 20
VQ_SHAPES = ("vq_stream", "vq_batch")


def run_vq_cell(shape: str, *, dev: torch.device, groups=None,
                seed: int = 0) -> dict:
    """One ``core.dvq`` step of the ``paper_vq`` cell ``shape`` on this
    rank (``groups``: ``Topology.make_groups`` of the world, or None for
    one process); returns this rank's record."""
    from repro_torch.core import dvq
    from repro_torch.distributed import process_group
    from repro_torch.distributed.roofline import (COLLECTIVE_BW, HBM_BW,
                                                  PEAK_FLOPS, VqCell,
                                                  vq_roofline_terms)
    kappa, d, tau = VQ_KAPPA, VQ_D, VQ_TAU
    # the cell's own memory: what the process held before it is left out
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((kappa, d), generator=gen, device=dev)
    world = 1 if groups is None else process_group.current().world_size
    cell = VqCell(d=d, kappa=kappa, tau=tau)
    if shape == "vq_stream":
        step = dvq.make_window_vq_step(
            tau=tau, group=None if groups is None else groups.groups[0])
        z = torch.randn((1, tau, d), generator=gen, device=dev)
        batch = tau
        mesh = f"{world}"
    else:
        model = 1 if groups is None else groups.size("model")
        data_group = None if groups is None else groups.group("data")
        model_group = (groups.group("model")
                       if groups is not None and model > 1 else None)
        if kappa % model:
            raise ValueError(f"--model {model} must divide kappa={kappa}")
        if model_group is not None:
            k_local = kappa // model
            r = groups.index("model")
            w = w[r * k_local:(r + 1) * k_local].contiguous()
        step = dvq.make_minibatch_vq_step(data_group=data_group,
                                          model_group=model_group)
        batch = VQ_BATCH // (world // model)
        z = torch.randn((batch, d), generator=gen, device=dev)
        mesh = f"{world // model}x{model}"
    step(w, 0, z)                                   # warm-up
    mark = step.transport.log.mark()
    device_lib.synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(w, 0, z)
    device_lib.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base
            if dev.type == "cuda" else None)
    summ = comm.CommLog.summarize(step.transport.log.since(mark))
    if shape == "vq_stream":
        terms = vq_roofline_terms(cell, summ["wire_bytes"])
        terms = {k: terms[k] for k in ("t_compute", "t_memory",
                                        "t_collective", "dominant")}
    else:
        terms = {"t_compute": cell.delta_flops(batch) / PEAK_FLOPS,
                 "t_memory": cell.delta_hbm_bytes(batch) / HBM_BW,
                 "t_collective": summ["wire_bytes"] / COLLECTIVE_BW}
        terms["dominant"] = max(terms, key=terms.get)[2:]
    return {"arch": "paper_vq", "shape": shape, "mesh": mesh,
            "status": "ok", "kappa": kappa, "d": d, "tau": tau,
            "points": batch, "wall_s": wall, "peak_bytes": peak,
            "wire_bytes": summ["wire_bytes"],
            "logical_bytes": summ["logical_bytes"],
            "calls": summ["calls"], "terms": terms}


def run_vq_cells(shape: str, *, device=None, model: int = 1) -> int:
    """``run_vq_cell`` over the world this process was started in (one
    process, or torchrun's); rank 0 prints every rank's record.  Returns
    the exit code."""
    from repro_torch.distributed import process_group
    from repro_torch.launch.train import in_torchrun_world
    from repro_torch.topology import Topology
    shapes = VQ_SHAPES if shape is None else (shape,)
    own = in_torchrun_world() and not process_group.in_world()
    if own:
        process_group.init(device=device)
    try:
        dev = (process_group.current().device if process_group.in_world()
               else device_lib.resolve(device))
        rank = process_group.current().rank if process_group.in_world() else 0
        for sh in shapes:
            groups = None
            if process_group.in_world():
                world = process_group.current().world_size
                groups = Topology.flat(world).make_groups(
                    model=model if sh == "vq_batch" else None)
            rec = run_vq_cell(sh, dev=dev, groups=groups)
            recs = (process_group.all_gather_object(rec)
                    if groups is not None else [rec])
            if rank == 0:
                for r, x in enumerate(recs):
                    peak = ("not measured" if x["peak_bytes"] is None
                            else f"{x['peak_bytes']:,} B")
                    print(f"OK   paper_vq x {sh} [{x['mesh']}] rank {r}: "
                          f"step wall {x['wall_s'] * 1e3:.3f} ms, peak "
                          f"device memory {peak}, comm wire "
                          f"{x['wire_bytes']:,} B / logical "
                          f"{x['logical_bytes']:,} B ({x['calls']} calls), "
                          f"VqCell terms " + json.dumps(x["terms"]),
                          flush=True)
    finally:
        if own:
            process_group.destroy()
    return 0


# ---------------------------------------------------------------------------
# the LM cells: spec arithmetic on the production layout
# ---------------------------------------------------------------------------

#: the reference's ``--merge`` choices
MERGES = ("none", "allreduce", "average", "delta", "async_delta",
          "delta_sparse")


def production_sizes(multi_pod: bool) -> dict:
    """``{axis: size}`` of the production layout."""
    from repro_torch.topology import production_grid
    grid, axes = production_grid(multi_pod=multi_pod)
    return dict(zip(axes, grid.shape))


def cell_arguments(cfg, cell, sizes: dict, *, use_fsdp: bool,
                   window: bool = False, merge: str = "none", tau: int = 10,
                   quantized: bool = False) -> dict:
    """``{name: (tree, specs)}`` of the cell's step arguments, shapes on
    the ``meta`` device, placed on a layout of ``sizes``; a prefill cell
    adds its output cache as ``"cache_out"``."""
    from repro_torch.distributed import sharding
    from repro_torch.models import quantization
    from repro_torch.models.api import get_api
    from repro_torch.optim import optimizers
    from repro_torch.optim.optimizers import tree_map
    pspecs = sharding.param_specs(cfg, sizes, use_fsdp=use_fsdp)
    params = get_api(cfg).init(0, device="meta")
    meta = torch.device("meta")
    if cell.kind == "train":
        opt = optimizers.adamw(optimizers.cosine_schedule(3e-4))
        state = {"params": params, "opt_state": opt.init(params),
                 "step": torch.empty((), dtype=torch.int32, device=meta)}
        specs = {"params": pspecs,
                 "opt_state": sharding.opt_specs_like(pspecs,
                                                      state["opt_state"]),
                 "step": sharding.P()}
        if window:
            extra = {"async_delta": "delta_prev",
                     "delta_sparse": "residual"}.get(merge)
            if extra is not None:   # the merge's f32 params-shaped state
                state[extra] = tree_map(
                    lambda p: torch.empty(p.shape, dtype=torch.float32,
                                          device=meta), params)
                specs[extra] = pspecs
            batch = registry.input_specs(cfg, cell, tau=tau)
            bspecs = {k: sharding.P(None, *sharding.batch_specs(
                cfg, sizes, {"x": v[0]})["x"]) for k, v in batch.items()}
        else:
            batch = registry.input_specs(cfg, cell)
            bspecs = sharding.batch_specs(cfg, sizes, batch)
        return {"state": (state, specs), "batch": (batch, bspecs)}
    if cell.kind == "prefill":
        batch = registry.input_specs(cfg, cell)
        cache = registry.cache_shapes(cfg, registry.ShapeCell(
            cell.name, "decode", cell.seq_len, cell.global_batch))
        return {"params": (params, pspecs),
                "batch": (batch, sharding.batch_specs(cfg, sizes, batch)),
                "cache_out": (cache, sharding.cache_specs(cfg, sizes,
                                                          cache))}
    tokens = registry.input_specs(cfg, cell)["tokens"]
    cache = registry.cache_shapes(cfg, cell)
    if quantized:
        params = quantization.quantize_tree(params)

        def place(leaf, spec):
            if isinstance(leaf, quantization.QuantizedLeaf):
                return quantization.QuantizedLeaf(
                    q=spec, scale=sharding.P(*([None] * leaf.scale.dim())),
                    dtype=leaf.dtype)
            return spec

        pspecs = tree_map(place, params, pspecs)
    return {"params": (params, pspecs),
            "cache": (cache, sharding.cache_specs(cfg, sizes, cache)),
            "tokens": (tokens, sharding.batch_specs(
                cfg, sizes, {"tokens": tokens})["tokens"])}


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             merge: str = "none", tau: int = 10, verbose: bool = True,
             quantized: bool = False) -> dict:
    """One LM cell's record (the reference's ``run_cell`` keys)."""
    from repro_torch.distributed import hlo_analysis, roofline, sharding
    rec: dict = {"arch": arch_id, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "merge": merge}
    if quantized:
        rec["quantized"] = True
    cfg = registry.get_config(arch_id)
    cell = next(s for s in registry.SHAPES if s.name == shape_name)
    ok, why = registry.cell_applicable(cfg, cell)
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"SKIP {arch_id} x {shape_name}: {why}")
        return rec
    t0 = time.perf_counter()
    try:
        sizes = production_sizes(multi_pod)
        window = merge != "none" and multi_pod and cell.kind == "train"
        args = cell_arguments(
            cfg, cell, sizes,
            use_fsdp=registry.uses_fsdp(arch_id) and cell.kind == "train",
            window=window, merge=merge, tau=tau,
            quantized=quantized and cell.kind == "decode")
        per = {k: sharding.device_bytes(t, s, sizes)
               for k, (t, s) in args.items()}
        coll = hlo_analysis.lower_cell(
            cfg, cell, sizes,
            use_fsdp=registry.uses_fsdp(arch_id) and cell.kind == "train",
            merge=merge if window else "none", tau=tau)
        # a window lowers tau local steps and its merge: per step, as the
        # reference normalizes it
        div = tau if window else 1
        terms = roofline.roofline_terms(cfg, cell,
                                        roofline.mesh_shape(multi_pod),
                                        coll["total_bytes"] / div)
        rec.update({
            "status": "ok", "reason": "",
            "build_s": round(time.perf_counter() - t0, 3),
            "per_step_divisor": div,
            "collectives": coll,
            "roofline": terms,
            "memory": {"argument_bytes": sum(
                v for k, v in per.items() if k != "cache_out"),
                "argument_detail": {k: v for k, v in per.items()
                                    if k != "cache_out"}},
        })
        if "cache_out" in per:
            rec["memory"]["output_cache_bytes"] = per["cache_out"]
            rec["cache_specs"] = {k: list(v) for k, v in
                                  args["cache_out"][1].items()}
        if verbose:
            gb = rec["memory"]["argument_bytes"] / 2**30
            print(f"OK   {arch_id} x {shape_name} [{rec['mesh']}, "
                  f"merge={merge}] build={rec['build_s']}s "
                  f"args={gb:.3f}GiB/dev coll={coll['total_bytes']:.3e}B "
                  f"dom={terms['dominant']} t=({terms['t_compute']:.4f},"
                  f"{terms['t_memory']:.4f},{terms['t_collective']:.4f})s "
                  f"mfu<={terms['mfu_bound']:.2f}")
    except Exception as e:  # noqa: BLE001 -- report, do not end the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        if verbose:
            print(f"FAIL {arch_id} x {shape_name} [{rec['mesh']}]: "
                  f"{rec['error'][:300]}")
    return rec


def _merge_into(path: str, results: list[dict]) -> None:
    """``results`` merged by key into the JSON list at ``path``."""
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)

    def keyf(r):
        return (r["arch"], r["shape"], r["mesh"], r.get("merge", "none"),
                r.get("quantized", False), r.get("transport", "none"))

    merged = {keyf(r): r for r in existing}
    for r in results:
        merged[keyf(r)] = r
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(list(merged.values()), f, indent=1)


def run_lm_cells(args) -> int:
    """The LM cells the flags name; returns the exit code."""
    if args.all:
        cells = [(a, c.name) for a in registry.ARCH_IDS
                 for c in registry.SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        print("error: need --arch and --shape (or --all)")
        return 2
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    results = [run_cell(arch, shape, multi_pod=mp, merge=args.merge,
                        tau=args.tau, quantized=args.quantized)
               for arch, shape in cells for mp in meshes]
    out = args.out or "dryrun_lm.json"
    _merge_into(out, results)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} failed; records -> {out}")
    return 1 if bad else 0


def run_comm_suite(*, sparse_frac: float | None = None, device=None,
                   verbose: bool = True) -> list[dict]:
    """The COMM, HIER and ADPT records, as the reference's
    ``run_comm_suite`` builds them."""
    cells = sweep.run_comm_cells(n=N_COMM, sparse_frac=sparse_frac,
                                 repeats=0, device=device)
    dense_wire = {c["scheme"]: c["merge_wire_bytes"] for c in cells
                  if c["transport"] == "xla"}
    records: list[dict] = []
    for c in cells:
        rec = {"arch": "comm", "shape": c["scheme"],
               "mesh": f"{c['m']}x1", "merge": c["scheme"],
               "transport": c["transport"], "status": "ok", **{
                   k: c[k] for k in (
                       "m", "n", "d", "kappa", "tau", "compile_s",
                       "merge_wire_bytes", "merge_logical_bytes",
                       "collective_calls", "final_C")}}
        if c["transport"] == "sparse":
            rec["sparse_frac"] = c["sparse_frac"]
            rec["wire_reduction_vs_dense"] = (
                dense_wire.get(c["scheme"], 0) / c["merge_wire_bytes"]
                if c["merge_wire_bytes"] else float("inf"))
        records.append(rec)
        if verbose:
            extra = (f" reduction={rec['wire_reduction_vs_dense']:.2f}x"
                     if c["transport"] == "sparse" else "")
            print(f"COMM {c['scheme']:<12s} x {c['transport']:<6s} "
                  f"wire={c['merge_wire_bytes']:>10,}B "
                  f"logical={c['merge_logical_bytes']:>10,}B{extra}")

    hier = sweep.run_hier_cells(n=N_COMM, tier1_frac=sparse_frac, repeats=0,
                                device=device)
    dense_inter = {c["scheme"]: c["tier1_wire_bytes"] for c in hier
                   if c["variant"] == "hier_dense"}
    for c in hier:
        if c["variant"] == "flat":
            continue
        rec = {"arch": "comm_hier", "shape": c["scheme"],
               "mesh": f"{c['hosts']}x{c['workers_per_host']}",
               "merge": c["scheme"], "transport": c["variant"],
               "status": "ok", **{k: c[k] for k in (
                   "m", "n", "d", "kappa", "tau", "compile_s", "hosts",
                   "workers_per_host", "merge_wire_bytes",
                   "tier0_wire_bytes", "tier1_wire_bytes", "final_C",
                   "bitmatch_flat")}}
        if c["variant"] == "hier_sparse":
            rec["tier1_frac"] = c["tier1_frac"]
            rec["inter_reduction_vs_dense"] = (
                dense_inter.get(c["scheme"], 0) / c["tier1_wire_bytes"]
                if c["tier1_wire_bytes"] else float("inf"))
        records.append(rec)
        if verbose:
            extra = (f" inter_reduction="
                     f"{rec['inter_reduction_vs_dense']:.2f}x"
                     if c["variant"] == "hier_sparse" else
                     f" bitmatch_flat={c['bitmatch_flat']}")
            print(f"HIER {c['scheme']:<12s} x {c['variant']:<12s} "
                  f"[{rec['mesh']}] intra={c['tier0_wire_bytes']:>9,}B "
                  f"inter={c['tier1_wire_bytes']:>9,}B{extra}")

    # the dynamic merge must hold its total (merge + probe) wire at or under
    # the fixed merge's at every quant level, or the probe does not pay
    adapt = sweep.run_adapt_cells(repeats=0, device=device)
    fixed_wire = {c["quant"]: c["total_wire_bytes"] for c in adapt
                  if c["merge"] == "fixed"}
    for c in adapt:
        rec = {"arch": "comm_adapt", "shape": "delta",
               "mesh": f"{c['m']}x1", "merge": c["merge"],
               "transport": c["quant"], "status": "ok", **{
                   k: c[k] for k in (
                       "m", "n", "d", "kappa", "tau", "quant", "thresh",
                       "compile_s", "merge_wire_bytes", "probe_wire_bytes",
                       "total_wire_bytes", "n_windows", "n_triggered",
                       "final_C")}}
        if c["merge"] == "dynamic":
            rec["wire_vs_fixed"] = (c["total_wire_bytes"]
                                    / max(fixed_wire[c["quant"]], 1))
        records.append(rec)
        if verbose:
            extra = (f" vs_fixed={rec['wire_vs_fixed']:.2f}x"
                     if c["merge"] == "dynamic" else "")
            print(f"ADPT {c['merge']:<8s} x {c['quant']:<6s} "
                  f"wire={c['total_wire_bytes']:>8,}B "
                  f"(merge {c['merge_wire_bytes']:,}B + probe "
                  f"{c['probe_wire_bytes']:,}B) "
                  f"trig={c['n_triggered']}/{c['n_windows']}{extra}")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="The dry run on the PyTorch port: the LM cells' spec "
                    "arithmetic, the comm suite's measured wire bytes, the "
                    "paper_vq cells.")
    ap.add_argument("--arch", choices=registry.ARCH_IDS + ["paper_vq"],
                    help="an LM arch, or paper_vq")
    ap.add_argument("--shape",
                    choices=[s.name for s in registry.SHAPES]
                    + list(VQ_SHAPES),
                    help="an LM shape, or vq_stream / vq_batch with --arch "
                         "paper_vq")
    ap.add_argument("--all", action="store_true",
                    help="every LM (arch x shape) cell on both layouts")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) layout")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both layouts")
    ap.add_argument("--merge", default="none", choices=MERGES,
                    help="train cells on the multi-pod layout: the window "
                         "step of this merge")
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--quantized", action="store_true",
                    help="int8 weight-only decode (decode cells only)")
    ap.add_argument("--comm", action="store_true",
                    help="the comm suite: measured wire bytes per scheme x "
                         "transport (8 stacked workers)")
    ap.add_argument("--sparse-frac", type=float, default=None,
                    help="--comm: sparse transport keep-fraction "
                         "(default: k/kappa = 0.25, the acceptance point)")
    ap.add_argument("--model", type=int, default=1,
                    help="--shape vq_batch: ranks the codebook's rows are "
                         "split over (a divisor of the world size)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="",
                    help="records file (default dryrun_comm.json with "
                         "--comm, dryrun_lm.json for the LM cells)")
    args = ap.parse_args(argv)

    if args.comm:
        return run_comm(args)
    if args.arch == "paper_vq" and not args.all:
        if args.multi_pod or args.both_meshes:
            print("error: the paper_vq cells run over the world they are "
                  "started in; --multi-pod/--both-meshes place the LM "
                  "cells")
            return 2
        if args.shape not in (None, *VQ_SHAPES):
            print(f"error: the paper_vq cells are {VQ_SHAPES}, got "
                  f"--shape {args.shape}")
            return 2
        device_lib.pin_full_f32()
        try:
            return run_vq_cells(args.shape, device=args.device,
                                model=args.model)
        except ValueError as e:
            print(f"error: {e}")
            return 2
    if args.shape in VQ_SHAPES:
        print(f"error: --shape {args.shape} is a paper_vq cell; give "
              f"--arch paper_vq")
        return 2
    if not (args.all or args.arch or args.shape):
        print("error: need --comm, --all, or --arch and --shape")
        return 2
    return run_lm_cells(args)


def run_comm(args) -> int:
    """The comm suite and its three bars; returns the exit code."""
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    results = run_comm_suite(sparse_frac=args.sparse_frac, device=dev)
    out = args.out or "dryrun_comm.json"
    _merge_into(out, results)
    # compression applies to displacement merges; 'average' ships means,
    # which ride dense on every transport
    worst = min((r["wire_reduction_vs_dense"] for r in results
                 if r.get("transport") == "sparse"
                 and r["merge"] != "average"), default=0.0)
    worst_inter = min((r["inter_reduction_vs_dense"] for r in results
                       if r.get("transport") == "hier_sparse"
                       and r["merge"] != "average"), default=0.0)
    worst_adapt = max((r["wire_vs_fixed"] for r in results
                       if r["arch"] == "comm_adapt"
                       and r["merge"] == "dynamic"), default=0.0)
    print(f"\n{len(results)} comm cells on {dev}; sparse-vs-dense merge-wire "
          f"reduction (min over displacement schemes) = {worst:.2f}x, "
          f"inter-host tier-1 reduction = {worst_inter:.2f}x "
          f"(acceptance bars: both >= 4x at k/kappa <= 0.25); "
          f"dynamic-vs-fixed wire (max over quant levels) = "
          f"{worst_adapt:.2f}x (bar: <= 1.0); records -> {out}")
    return 0 if (worst >= 4.0 and worst_inter >= 4.0
                 and 0.0 < worst_adapt <= 1.0) else 1


if __name__ == "__main__":
    raise SystemExit(main())
