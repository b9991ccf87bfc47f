"""Collective bytes of a cell's step, counterpart of
``repro/distributed/hlo_analysis.py``.

The reference compiles each dry-run cell with XLA, parses the HLO text and
counts every collective's RESULT bytes per device (its ``_shape_bytes``),
multiplying the body of the layer ``while`` loop by its trip count.  The
port has no HLO: it reads the collectives its own placed program records
(``process_group.CollectiveLog``) in place of HLO text.  ``lower_cell``
runs the cell's step once on ``meta`` tensors of one rank's shard shapes
over a ``process_group.RecordingLayout`` (sizes and coords; no byte moves,
nothing is computed), with each layer stack cut to ONE layer: a record
made inside a stack's ``collective_scope`` is multiplied by that stack's
layer count (the counterpart of the reference's trip-count weighting, and
``loops`` lists ``(stack, count)``).  The train step's gradient sync and
clip run on the full-depth gradient shapes.

``analyze_collectives`` keeps the reference's keys.  The reference also
reports ``tpu_adjusted_bytes``, which halves the f32 all-reduces that
XLA:CPU promoted from bf16; the port promotes nothing behind the program's
back (its reductions are f32 by choice, and recorded so), so the key is
left out.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import process_group

#: the stacks of each family and the config field that counts their layers
_STACKS = {"encdec": (("enc_blocks", "encoder_layers"),
                      ("dec_blocks", "n_layers"))}


def stacks(cfg) -> tuple:
    """``((stack, layer count), ...)`` of ``cfg``."""
    fields = _STACKS.get(cfg.family, (("blocks", "n_layers"),))
    return tuple((name, getattr(cfg, f)) for name, f in fields)


def analyze_collectives(log: process_group.CollectiveLog,
                        loops: dict | None = None, *,
                        repeat: int = 1) -> dict:
    """Collective bytes per device, layer-count weighted: each record's
    result bytes times ``loops[its scope]`` (1 outside a stack) times
    ``repeat`` (a window's tau steps).

    Returns {'total_bytes', 'bytes_by_kind', 'count_by_kind', 'loops',
    'in_loop_bytes', 'top_ops'}, the reference's keys."""
    loops = dict(loops or {})
    bytes_by_kind: dict = {}
    count_by_kind: dict = {}
    in_loop = 0
    ops: dict = {}
    for r in log.records:
        m = loops.get(r.scope, 1) * repeat
        b = r.nbytes * m
        bytes_by_kind[r.kind] = bytes_by_kind.get(r.kind, 0) + b
        count_by_kind[r.kind] = count_by_kind.get(r.kind, 0) + m
        if r.scope:
            in_loop += b
        key = (r.kind, r.scope or "step", r.axis)
        ops[key] = ops.get(key, 0) + b
    top = sorted(((b, *k) for k, b in ops.items()), reverse=True)[:8]
    return {
        "total_bytes": sum(bytes_by_kind.values()),
        "bytes_by_kind": bytes_by_kind,
        "count_by_kind": count_by_kind,
        "loops": sorted(loops.items()),
        "in_loop_bytes": in_loop,
        "top_ops": [(f"{b:.3e}", kind, f"{scope} over {axis}")
                    for b, kind, scope, axis in top],
    }


def _cut(cfg):
    """``cfg`` with each layer stack cut to one layer."""
    return dataclasses.replace(
        cfg, n_layers=1,
        encoder_layers=1 if cfg.encoder_layers else 0)


def _local_params(cfg, sizes: dict, use_fsdp: bool) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.models.api import get_api
    whole = get_api(cfg).init(0, device="meta")
    return sharding.local_meta(
        whole, sharding.param_specs(cfg, sizes, use_fsdp=use_fsdp), sizes)


def _local_batch(cfg, batch: dict, sizes: dict) -> dict:
    from repro_torch.distributed import sharding
    return sharding.local_meta(batch, sharding.batch_specs(cfg, sizes, batch),
                               sizes)


def lower_cell(cfg, cell, sizes: dict, *, use_fsdp: bool,
               merge: str = "none", tau: int = 10,
               coords: dict | None = None) -> dict:
    """The collectives of one step of ``cell`` on a layout of ``sizes``
    (``analyze_collectives``' dict): a train cell's loss, backward,
    gradient sync and clip (with ``merge`` on a layout with 'pod', the
    window step's: tau local steps over ('data', 'model') with sequence
    parallelism off, as the reference lowers it, and the merge over 'pod'
    from its ``CommRecord``s); a prefill cell's forward and cache fill; a
    decode cell's step over its cache.  ``coords``: the recording rank's
    (all 0 by default)."""
    from repro_torch.configs import registry
    from repro_torch.models import common, transformer
    from repro_torch.models.api import get_api
    from repro_torch.training import steps
    window = merge != "none" and "pod" in sizes and cell.kind == "train"
    inner = ({a: n for a, n in sizes.items() if a != "pod"} if window
             else dict(sizes))
    layout = process_group.RecordingLayout.of(inner, coords)
    cut = _cut(cfg)
    api = get_api(cut)
    saved = dataclasses.replace(common.get_run_options())
    common.set_run_options(layout=layout, fsdp=use_fsdp,
                           seq_parallel=saved.seq_parallel and not window)
    try:
        with process_group.record_collectives() as log, torch.no_grad():
            if cell.kind == "train":
                batch = registry.input_specs(cut, cell)
                local = _local_batch(cut, batch, sizes)
                loss, _ = steps.loss_and_grads(
                    api.loss_fn, _local_params(cut, inner, use_fsdp), local)
                pl = common.placement(cfg)
                grads = _local_params(cfg, inner, use_fsdp)
                _, grads = steps.sync_grads(pl, loss, grads)
                steps.clip_placed(pl, grads, 1.0)
            elif cell.kind == "prefill":
                batch = _local_batch(cut, registry.input_specs(cut, cell),
                                     sizes)
                api.prefill(_local_params(cut, inner, use_fsdp), batch,
                            cell.seq_len)
            else:
                params = _local_params(cut, inner, use_fsdp)
                whole = registry.cache_shapes(cut, cell)
                pl = common.placement(cut)
                cache = transformer.placed_cache(cut, whole, pl, "meta")
                cache["cur_len"] = cell.seq_len - 1
                tokens = _local_batch(cut, registry.input_specs(cut, cell),
                                      sizes)["tokens"]
                api.decode_step(params, cache, tokens)
    finally:
        common.set_run_options(**dataclasses.asdict(saved))
    loops = dict(stacks(cfg))
    out = analyze_collectives(log, loops, repeat=tau if window else 1)
    if window:
        out = _with_merge(out, merge_records(cfg, sizes, merge, tau,
                                             use_fsdp))
    return out


def merge_records(cfg, sizes: dict, merge: str, tau: int,
                  use_fsdp: bool) -> list:
    """The ``CommRecord``s of one window's merge over 'pod' of this rank's
    shards (``training.steps.merge_phase`` on ``meta`` leaves; the sparse
    selection by its plain version, which runs there): every
    (pod,) x shard leaf stacked."""
    from repro_torch import comm
    from repro_torch.optim import optimizers
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.training import steps
    m = sizes["pod"]
    params = _local_params(cfg, sizes, use_fsdp)
    kind = steps.Merge(merge)
    tsp = comm.get_transport("sparse" if kind is steps.Merge.DELTA_SPARSE
                             else "xla", **({"frac": 0.01} if kind is
                                            steps.Merge.DELTA_SPARSE else {}))
    if isinstance(tsp, comm.SparseTransport):
        tsp = tsp.plain()
    tsp.log.mark()
    if kind is steps.Merge.ALLREDUCE:
        grads = tuple(torch.empty((m, *p.shape), dtype=p.dtype,
                                  device="meta") for p in tree_leaves(params))
        tsp.all_reduce(grads, op="mean", calls=tau)
        return list(tsp.log.since(0))
    opt = optimizers.adamw(optimizers.cosine_schedule(3e-4))
    state = steps._expanded({"params": params,
                             "opt_state": opt.init(params)}, m)

    def f32_like():
        return optimizers.tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device="meta"), params)

    if kind is steps.Merge.ASYNC_DELTA:
        state["delta_prev"] = steps._expanded(f32_like(), m)
    if kind is steps.Merge.DELTA_SPARSE:
        state["residual"] = steps._expanded(f32_like(), m)
    stacked = [tuple(torch.empty(x.shape, dtype=x.dtype, device="meta")
                     for x in tree_leaves(state[k]))
               for k in ("params", "opt_state")]
    steps.merge_phase(kind, steps.make_strategy(kind, tsp), tsp, state,
                      stacked[0], stacked[1], m)
    return list(tsp.log.since(0))


def _with_merge(out: dict, records: list) -> dict:
    """``out`` with a window's merge records added (their wire bytes times
    their calls: at 2 participants a dense all-reduce's wire is its
    payload, the result's bytes; the sparse merge's gather moves its
    pairs)."""
    out = dict(out)
    by_kind = dict(out["bytes_by_kind"])
    count = dict(out["count_by_kind"])
    top = list(out["top_ops"])
    for r in records:
        kind = "all-gather" if r.transport.startswith("sparse") and \
            r.op == "sum" else "all-reduce"
        b = r.wire_bytes * r.calls
        by_kind[kind] = by_kind.get(kind, 0) + b
        count[kind] = count.get(kind, 0) + r.calls
        top.append((f"{b:.3e}", kind, f"merge[{r.op}] over pod"))
    out.update(bytes_by_kind=by_kind, count_by_kind=count,
               total_bytes=sum(by_kind.values()),
               top_ops=sorted(top, key=lambda t: -float(t[0]))[:8])
    return out
