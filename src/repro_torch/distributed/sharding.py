"""Placement specs for every param / optimizer / batch / cache leaf,
counterpart of ``repro/distributed/sharding.py`` (its lines 32-202).

Policy, the reference's:
  * TP ('model' axis): attention head dims (only where the head counts
    divide the axis: starcoder2's 36 heads or hymba's 25 keep attention
    replicated and shard the MLP instead), d_ff / d_inner, the expert count,
    the vocabulary;
  * FSDP ('data' axis, when asked for): one more non-TP dim of each weight
    leaf;
  * DP ('pod', 'data'): the batch dim of the inputs;
  * decode caches: the batch over DP where it divides, the sequence over
    'model' (and over the DP axes too where the batch cannot shard: the
    long_500k b = 1 cell).

A layout is an ordered mapping of axis name to size or a
``topology.Groups`` (``models.common.layout_sizes``).  A spec is a ``P``:
one entry per dim, each ``None`` (whole), an axis name, or a tuple of axis
names (the dim split over their product, the first axis outermost), as
the reference's ``PartitionSpec``.  ``param_specs``, ``batch_specs``,
``cache_specs`` and ``opt_specs_like`` return the reference's entries for
the same shapes and layout.

In the place of the reference's ``named`` (a ``NamedSharding`` for GSPMD),
three functions act on the specs:
  * ``local_shard``: this rank's slice of a whole leaf;
  * ``gather_shards``: the whole leaf again, one ``all_gather`` per axis;
  * ``device_bytes``: the bytes a device holds of a tree of shapes (the dry
    run's argument bytes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import api as model_api
from repro_torch.models.common import (ModelConfig, ShardingRules,
                                       layout_sizes, make_rules)
from repro_torch.optim.optimizers import tree_map


def _entry(entry):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a tuple
    of one axis is that axis, an empty one ``None``."""
    if isinstance(entry, (tuple, list)):
        if len(entry) == 0:
            return None
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class P(tuple):
    """A placement spec: ``P(None, "model")``, ``P(("pod", "data"), None)``;
    ``P()`` places a 0-d leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _is_quantized(x) -> bool:
    return hasattr(x, "q") and hasattr(x, "scale")


def spec_leaves(specs) -> list:
    """The specs of a spec tree in the checkpoint's and the optimizer's
    flatten order (dict keys sorted, tuples in order, ``None`` empty); a
    ``P`` is a leaf, and a quantized leaf's spec gives its q's and its
    scale's."""
    if specs is None:
        return []
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if _is_quantized(specs):
        return [specs.q, specs.scale]
    if isinstance(specs, (tuple, list)):
        return [x for item in specs for x in spec_leaves(item)]
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _wspec(r: ShardingRules, shape: tuple[int, ...], tp_dim: int | None,
           *, has_layer_dim: bool = True) -> P:
    """Spec of a weight leaf: TP on ``tp_dim`` (already validated), FSDP on
    the first other (non-layer) dim the fsdp axis divides."""
    spec: list = [None] * len(shape)
    if tp_dim is not None:
        spec[tp_dim] = r.tp
    start = 1 if has_layer_dim else 0
    if r.fsdp:
        for i in range(start, len(shape)):
            if (i != tp_dim and shape[i] % r.fsdp_size == 0
                    and shape[i] >= r.fsdp_size):
                spec[i] = r.fsdp
                break
    return P(*spec)


def _block_specs(cfg: ModelConfig, r: ShardingRules, blk: dict) -> dict:
    """Specs of one stacked-L block dict, keyed by leaf name."""
    hq_ok = r.heads(cfg.n_heads) is not None
    hkv_ok = r.heads(cfg.n_kv_heads) is not None if cfg.n_kv_heads else False
    di_ok = r.dim(cfg.d_inner) is not None
    ff_ok = r.dim(cfg.d_ff) is not None if cfg.d_ff else False
    e_ok = r.dim(cfg.n_experts) is not None if cfg.n_experts else False
    h_ok = r.dim(cfg.ssm_heads) is not None if cfg.ssm_state else False

    out = {}
    for name, leaf in blk.items():
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in ("wq", "cwq", "cwk", "cwv"):
            out[name] = _wspec(r, shape, 2 if hq_ok else None)
        elif name in ("wk", "wv"):
            out[name] = _wspec(r, shape, 2 if hkv_ok else None)
        elif name in ("wo", "cwo"):
            out[name] = _wspec(r, shape, 1 if hq_ok else None)
        elif name in ("w_gate", "w_up"):
            # dense: (L, D, F) TP on F; moe: (L, E, D, F) TP on E
            tp = (1 if e_ok else None) if nd == 4 else (2 if ff_ok else None)
            out[name] = _wspec(r, shape, tp)
        elif name == "w_down":
            tp = (1 if e_ok else None) if nd == 4 else (1 if ff_ok else None)
            out[name] = _wspec(r, shape, tp)
        elif name == "router":
            out[name] = _wspec(r, shape, 2 if e_ok else None)
        elif name in ("in_z", "in_x"):
            out[name] = _wspec(r, shape, 2 if di_ok else None)
        elif name == "out_proj":
            out[name] = _wspec(r, shape, 1 if di_ok else None)
        elif name == "conv_x":
            out[name] = _wspec(r, shape, 2 if di_ok else None)
        elif name == "in_dt":
            out[name] = _wspec(r, shape, 2 if h_ok else None)
        elif name in ("in_bc", "conv_bc"):
            out[name] = _wspec(r, shape, None)
        elif name in ("A_log", "D", "dt_bias"):
            out[name] = P(None, r.tp) if h_ok else P(None, None)
        else:  # norms and anything small: replicated
            out[name] = P(*([None] * nd))
    return out


def param_specs(cfg: ModelConfig, layout, *, use_fsdp: bool) -> dict:
    """A spec tree shaped like ``api.init(cfg)``'s params (shapes from the
    ``meta`` device: nothing is allocated)."""
    r = make_rules(layout, use_fsdp=use_fsdp)
    shapes = model_api.get_api(cfg).init(0, device="meta")

    v_ok = r.dim(cfg.vocab) is not None
    d_ok = r.dim(cfg.d_model) is not None
    embed_spec = _wspec(
        r, (cfg.vocab, cfg.d_model), 0 if v_ok else (1 if d_ok else None),
        has_layer_dim=False)

    specs: dict = {}
    for key, sub in shapes.items():
        if key == "embed":
            specs[key] = embed_spec
        elif key == "lm_head":
            specs[key] = _wspec(r, (cfg.d_model, cfg.vocab),
                                1 if v_ok else None, has_layer_dim=False)
        elif key in ("blocks", "enc_blocks", "dec_blocks"):
            specs[key] = _block_specs(cfg, r, sub)
        else:  # final_norm, enc_norm, ...
            specs[key] = P(*([None] * len(sub.shape)))
    return specs


# ---------------------------------------------------------------------------
# batch / cache / optimizer specs
# ---------------------------------------------------------------------------

def _dp(sizes: dict) -> tuple[tuple[str, ...], int]:
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    return dp, math.prod(sizes[a] for a in dp)


def batch_specs(cfg: ModelConfig, layout, batch: dict) -> dict:
    """Specs of a train / prefill batch: the batch dim over the DP axes
    where they divide it."""
    dp, dp_size = _dp(layout_sizes(layout))

    def spec_for(leaf):
        first = dp if dp_size and leaf.shape[0] % dp_size == 0 else ()
        return P(first if first else None, *([None] * (leaf.dim() - 1)))

    return tree_map(spec_for, batch)


def cache_specs(cfg: ModelConfig, layout, cache: dict) -> dict:
    """Decode-cache specs.  Leaves carry a leading L dim; a host-int
    ``cur_len`` is a 0-d leaf."""
    sizes = layout_sizes(layout)
    dp, dp_size = _dp(sizes)
    tp_size = sizes.get("model", 1)

    def kv_spec(leaf):  # (L, B, S, Hkv, Dh)
        _, b, s = leaf.shape[:3]
        b_axes = dp if b % max(dp_size, 1) == 0 and dp_size > 1 else ()
        s_axes = ["model"] if "model" in sizes else []
        if not b_axes:  # long-context b=1: fold DP axes into the seq shard
            s_axes = list(dp) + s_axes
        s_total = math.prod(sizes[a] for a in s_axes) if s_axes else 1
        if s_total == 0 or s % max(s_total, 1) != 0:
            s_axes = []
        return P(None, b_axes if b_axes else None,
                 tuple(s_axes) if s_axes else None, None, None)

    def b_axis(leaf):
        return (dp if leaf.shape[1] % max(dp_size, 1) == 0 and dp_size > 1
                else None)

    def generic(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return P()
        if (leaf.dim() >= 3 and leaf.shape[1] % max(dp_size, 1) == 0
                and dp_size > 1):
            return P(None, dp, *([None] * (leaf.dim() - 2)))
        return P(*([None] * leaf.dim()))

    specs = {}
    for name, leaf in cache.items():
        if name in ("k", "v", "ck", "cv"):
            specs[name] = kv_spec(leaf)
        elif name == "ssm":  # (L, B, H, P, N)
            h_ax = ("model" if leaf.shape[2] % tp_size == 0 and tp_size > 1
                    else None)
            specs[name] = P(None, b_axis(leaf), h_ax, None, None)
        elif name in ("conv_x", "conv_bc"):  # (L, B, W-1, C)
            c_ax = ("model" if leaf.shape[3] % tp_size == 0 and tp_size > 1
                    else None)
            specs[name] = P(None, b_axis(leaf), None, c_ax)
        else:
            specs[name] = generic(leaf)
    return specs


def opt_specs_like(param_specs_tree, opt_state):
    """Specs of an ``AdamState`` / ``SGDState``: the moments mirror their
    param's spec."""
    from repro_torch.optim.optimizers import AdamState, SGDState
    if isinstance(opt_state, AdamState):
        return AdamState(mu=param_specs_tree, nu=param_specs_tree, count=P())
    if isinstance(opt_state, SGDState):
        mom = param_specs_tree if opt_state.momentum is not None else None
        return SGDState(momentum=mom, count=P())
    raise TypeError(type(opt_state))


# ---------------------------------------------------------------------------
# acting on the specs
# ---------------------------------------------------------------------------

def layout_coords(groups) -> dict[str, int]:
    """``{axis: this rank's index}`` of a ``topology.Groups``."""
    return dict(zip(groups.axes, groups.coords))


def _shard(dim_size: int, entry, sizes: dict, coords: dict | None
           ) -> tuple[int, int]:
    """(the shard's length, its index along the dim) of ``entry``; the
    index is row-major over the entry's axes, the first outermost."""
    n = math.prod(sizes[a] for a in _axes(entry))
    if dim_size % n:
        raise ValueError(f"a dim of {dim_size} does not split over "
                         f"{_axes(entry)} ({n} shards)")
    idx = 0
    for a in _axes(entry):
        idx = idx * sizes[a] + (coords[a] if coords is not None else 0)
    return dim_size // n, idx


def local_shape(shape: tuple, spec: P, sizes: dict) -> tuple:
    """The shape of a rank's slice of a leaf of ``shape`` under ``spec``."""
    return tuple(_shard(n, entry, sizes, None)[0] if _axes(entry) else n
                 for n, entry in zip(shape, spec))


def local_meta(tree, specs, sizes: dict):
    """``tree``'s leaves as ``meta`` tensors of a rank's slice shapes."""
    return tree_map(lambda leaf, spec: torch.empty(
        local_shape(tuple(leaf.shape), spec, sizes), dtype=leaf.dtype,
        device="meta"), tree, specs)


def local_shard(leaf: torch.Tensor, spec: P, sizes: dict, coords: dict
                ) -> torch.Tensor:
    """This rank's slice of the whole ``leaf`` under ``spec``, at
    ``coords`` ({axis: index}) of a layout of ``sizes``; a sliced leaf is a
    copy of its own (the whole one can be freed), an unsliced one the leaf
    itself.  Raises on a dim the axes do not divide."""
    if len(spec) != leaf.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries, the leaf "
                         f"{tuple(leaf.shape)} {leaf.dim()} dims")
    out = leaf
    for d, entry in enumerate(spec):
        if not _axes(entry):
            continue
        length, idx = _shard(leaf.shape[d], entry, sizes, coords)
        out = out.narrow(d, idx * length, length)
    return out if out is leaf else out.clone()


def local_tree(tree, specs, sizes: dict, coords: dict):
    """``local_shard`` over nested dicts of leaves and their specs."""
    return tree_map(lambda leaf, spec: local_shard(leaf, spec, sizes, coords),
                tree, specs)


def gather_shards(local: torch.Tensor, spec: P, groups) -> torch.Tensor:
    """The whole leaf from every rank's ``local`` slice under ``spec``: one
    ``process_group.all_gather`` over each sharded axis's group, the
    innermost axis of a dim first.  Every rank of ``groups`` calls it in
    the same order."""
    from repro_torch.distributed import process_group
    out = local
    for d, entry in enumerate(spec):
        for axis in reversed(_axes(entry)):
            stacked = process_group.all_gather(out, groups.group(axis))
            out = torch.cat(tuple(stacked), dim=d)
    return out


def device_bytes(tree, specs, sizes: dict) -> int:
    """The bytes one device holds of ``tree`` (tensors, shapes on the
    ``meta`` device or live; a quantized leaf's q and scale; a host int as
    a 4-byte scalar) placed by ``specs`` on a layout of ``sizes``: each
    sharded dim is cut into its shard, rounded up as a compiler pads it."""
    def one(leaf, spec) -> int:
        if not isinstance(leaf, torch.Tensor):
            return 4
        n = 1
        for size, entry in zip(leaf.shape, spec):
            parts = math.prod(sizes[a] for a in _axes(entry))
            n *= -(-size // parts)
        return n * leaf.element_size()

    def walk(t, s) -> int:
        if t is None:
            return 0
        if isinstance(t, dict):
            return sum(walk(t[k], s[k]) for k in t)
        if _is_quantized(t):
            return one(t.q, s.q) + one(t.scale, s.scale)
        if isinstance(t, (tuple, list)) and not isinstance(s, P):
            return sum(walk(a, b) for a, b in zip(t, s))
        return one(t, s)

    return walk(tree, specs)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where this rank's slices of a tree lie: the tree's ``specs`` on a
    layout of ``sizes``, at ``coords``.  ``Checkpointer.restore(...,
    placement=)`` keeps a rank's slices of the whole stored leaves."""

    specs: Any
    sizes: dict
    coords: dict

    def spec_leaves(self) -> list:
        return spec_leaves(self.specs)

    def local(self, leaf: torch.Tensor, spec: P) -> torch.Tensor:
        return local_shard(leaf, spec, self.sizes, self.coords)


def moe_ep_params(cfg: ModelConfig, params: dict, groups) -> dict:
    """``params`` with each MoE expert leaf (``w_gate``, ``w_up``,
    ``w_down``) cut to this rank's ``n_experts / |model|`` experts, its
    slice under ``param_specs`` on ``groups``' layout; every other leaf as
    it is (expert parallelism splits only the experts)."""
    specs = param_specs(cfg, groups, use_fsdp=False)["blocks"]
    sizes, coords = layout_sizes(groups), layout_coords(groups)
    blk = dict(params["blocks"])
    for name in ("w_gate", "w_up", "w_down"):
        blk[name] = local_shard(blk[name], specs[name], sizes, coords)
    return {**params, "blocks": blk}
