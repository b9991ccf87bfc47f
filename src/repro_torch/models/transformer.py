"""Decoder-only LM covering the dense / moe / ssm / hybrid / vlm families,
counterpart of ``repro/models/transformer.py``.

Layer stacks keep the reference's stacked leading ``L`` axis; the port
loops over it in Python where the reference scans.

Public API:
  init(cfg, seed, device=)                -> params (nested dict)
  forward(cfg, params, batch)             -> logits (B, T, V)
  loss_fn(cfg, params, batch)             -> scalar CE (+ MoE aux)
  init_cache(cfg, batch_size, max_len)    -> decode cache (dict)
  prefill(cfg, params, batch, max_len)    -> (last logits (B, V), cache)
  decode_step(cfg, params, cache, tokens) -> (logits (B, 1, V), cache)

The decode cache holds ``cur_len`` as a host ``int`` (a device scalar would
make every slice wait on the card) and its tensors are written in place: a
decode step returns a new dict over the same, updated tensors.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import blocks, common
from repro_torch.models.common import ModelConfig, rms_norm

_ATTN = ("dense", "moe", "vlm", "hybrid")
_MLP = ("dense", "vlm", "hybrid")
_MLP_KEYS = ("w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full).  Hybrid (hymba) schedules a few
    global layers (first / middle / last) among sliding-window layers."""
    if cfg.family != "hybrid" or cfg.window <= 0:
        return [0] * cfg.n_layers
    w = [cfg.window] * cfg.n_layers
    for i in (0, cfg.n_layers // 2, cfg.n_layers - 1):
        w[i] = 0
    return w


def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random params from a generator on ``device`` seeded by ``seed``
    (the card unless the caller asks for the CPU; ``meta`` allocates shapes
    only).  Leaf names, stacked shapes and dtypes are the reference's; the
    random streams are not."""
    dev = common.init_device(device)
    gen = common.make_generator(seed, dev)
    L, d, v = cfg.n_layers, cfg.d_model, cfg.vocab

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    blk: dict = {}
    if cfg.family in _ATTN:
        blk.update(blocks.init_attention(cfg, gen, L, device=dev))
        blk["attn_norm"] = ones(L, d)
    if cfg.family in ("ssm", "hybrid"):
        blk.update(blocks.init_mamba(cfg, gen, L, device=dev))
        blk["ssm_norm"] = ones(L, d)
    if cfg.family == "moe":
        blk.update(blocks.init_moe(cfg, gen, L, device=dev))
        blk["mlp_norm"] = ones(L, d)
    elif cfg.family in _MLP:
        blk.update(blocks.init_swiglu(cfg, gen, L, device=dev))
        blk["mlp_norm"] = ones(L, d)
    params = {
        "embed": common.init_dense(gen, (v, d), cfg.dtype, scale=1.0,
                                   device=dev),
        "blocks": blk,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.init_dense(gen, (d, v), cfg.dtype,
                                              device=dev)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
# One body an entry point, for the whole model and under a layout alike
# (``common.placed``): ``params`` are this rank's shards and ``batch`` its
# rows (the whole model with no layout).  The stream enters each sub-block
# through ``Placed.enter`` and leaves through ``Placed.leave``, the
# reference's ``shard_seq`` at the block's start made the Megatron pair;
# with one rank on 'model' both are identities.

def _stream_in(cfg: ModelConfig, params: dict, batch: dict, pl
               ) -> tuple[torch.Tensor, bool]:
    """The embedded inputs as the stream holds them and whether it is split
    over the sequence.  VLM prepends stub patch embeddings (precomputed by
    the frontend stub, see ``configs.registry.input_specs``); they join a
    vocabulary-parallel lookup's partial on the group's first rank only."""
    rows, partial = pl.embed(pl.top(params, "embed"), batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        patches = batch["patch_embeds"].to(rows.dtype)
        if partial and pl.tp_rank != 0:
            patches = torch.zeros_like(patches)
        rows = torch.cat([patches, rows], dim=1)
    sp = pl.seq_sharded(rows.shape[1])
    return pl.leave(rows, sp, partial=partial, dtype=rows.dtype), sp


def _mixer(cfg: ModelConfig, p: dict, x: torch.Tensor, window: int,
           state: bool, sp: bool, pl):
    """The attention / SSM half of a layer over the stream: returns the new
    stream and, with ``state``, the decode-cache leaves it leaves (K/V,
    conv tails, SSM state)."""
    outs: dict = {}
    if cfg.family in ("dense", "moe", "vlm"):
        h = pl.enter(rms_norm(x, p["attn_norm"], cfg.norm_eps), sp)
        a, part = blocks.attention_placed(cfg, p, h, pl, return_kv=state)
        if state:
            a, outs["k"], outs["v"] = a
        x = x + pl.leave(a, sp, partial=part, dtype=x.dtype)
    elif cfg.family == "ssm":
        h = pl.enter(rms_norm(x, p["ssm_norm"], cfg.norm_eps), sp)
        s, part = blocks.mamba_placed(cfg, p, h, pl, return_state=state)
        if state:
            s, outs["conv_x"], outs["conv_bc"], outs["ssm"] = s
        x = x + pl.leave(s, sp, partial=part, dtype=x.dtype)
    elif cfg.family == "hybrid":
        # hymba: attention and SSM heads run in PARALLEL on the same input,
        # outputs are averaged (normalized fusion).
        h = pl.enter(rms_norm(x, p["attn_norm"], cfg.norm_eps), sp)
        a, pa = blocks.attention_placed(cfg, p, h, pl, window=window,
                                        return_kv=state)
        s, ps = blocks.mamba_placed(cfg, p, h, pl, return_state=state)
        if state:
            a, outs["k"], outs["v"] = a
            s, outs["conv_x"], outs["conv_bc"], outs["ssm"] = s
        x = x + 0.5 * (pl.leave(a, sp, partial=pa, dtype=x.dtype)
                       + pl.leave(s, sp, partial=ps, dtype=x.dtype))
    return x, outs


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, sp: bool, pl
         ) -> torch.Tensor:
    if cfg.family == "moe":
        h = pl.enter(rms_norm(x, p["mlp_norm"], cfg.norm_eps), sp)
        y, part = blocks.moe_placed(cfg, p, h, pl)
    elif cfg.family in _MLP:
        h = pl.enter(rms_norm(x, p["mlp_norm"], cfg.norm_eps), sp)
        y, part = blocks.mlp_placed(cfg, {k: p[k] for k in _MLP_KEYS}, h,
                                    pl)
    else:
        return x
    return x + pl.leave(y, sp, partial=part, dtype=x.dtype)


def block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """One layer (its leaves ``p``) over the (B, T, D) residual stream,
    whole on this rank."""
    pl = common.placed(cfg)
    x, _ = _mixer(cfg, p, x, window, False, False, pl)
    return _mlp(cfg, p, x, False, pl)


def _run_layers(cfg: ModelConfig, params: dict, x: torch.Tensor, sp: bool,
                pl, cache: dict | None = None) -> torch.Tensor:
    """The layer stack over the stream; with ``cache``, each layer's decode
    state written into this rank's share of it (a prefill)."""
    from repro_torch.distributed import process_group
    # one layer's leaves at a time: a quantized leaf dequantizes lazily
    raw = common.layers(params["blocks"], cfg.n_layers)
    for i, (w, r) in enumerate(zip(_layer_windows(cfg), raw)):
        with process_group.collective_scope("blocks"):
            p = pl.unshard_layer(r, "blocks")
            x, outs = _mixer(cfg, p, x, w, cache is not None, sp, pl)
            x = _mlp(cfg, p, x, sp, pl)
            if cache is not None:
                _fill_cache(cache, i, outs, x.shape[1] * (
                    pl.tp if sp else 1), pl)
    return x


def _logits(cfg: ModelConfig, params: dict, batch: dict, pl
            ) -> torch.Tensor:
    """This rank's vocabulary columns of the logits (B, T, V / |model|),
    or the whole logits where the vocabulary does not split."""
    x, sp = _stream_in(cfg, params, batch, pl)
    x = _run_layers(cfg, params, x, sp, pl)
    x = rms_norm(x, pl.top(params, "final_norm"), cfg.norm_eps)
    return pl.enter(x, sp) @ pl.head(params)


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    pl = common.placed(cfg)
    return pl.whole_logits(_logits(cfg, params, batch, pl))


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            *, aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token CE in f32 (+ Switch-style load-balance loss for MoE, on
    the first layer's router, as the reference).

    VLM: patch positions carry no labels; the loss is computed on the token
    suffix only.
    """
    pl = common.placed(cfg)
    logits = _logits(cfg, params, batch, pl).float()
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    labels = batch["labels"]
    ce = pl.cross_entropy(logits[:, : labels.shape[1]], labels)
    if cfg.family == "moe":
        x, _ = _stream_in(cfg, params, batch, pl)
        p0 = common.layer_slice(params["blocks"], 0)
        router = pl.unshard_layer({"router": p0["router"]}, "blocks")
        ce = ce + aux_weight * blocks.moe_aux_loss(cfg, router["router"], x,
                                                   pl)
    return ce


# ---------------------------------------------------------------------------
# decode path (KV / SSM-state caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Decode cache (leaves with a leading L axis; ``cur_len`` a host
    int).  ``device``: the card unless the caller asks for the CPU or
    ``meta``."""
    dev = common.init_device(device)
    L = cfg.n_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: dict = {"cur_len": 0}
    if cfg.family in _ATTN:
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        cache["k"] = zeros((L, batch, max_len, hkv, dh), cfg.dtype)
        cache["v"] = zeros((L, batch, max_len, hkv, dh), cfg.dtype)
    if cfg.family in ("ssm", "hybrid"):
        di, n = cfg.d_inner, cfg.ssm_state
        cache["conv_x"] = zeros((L, batch, cfg.ssm_conv - 1, di), cfg.dtype)
        cache["conv_bc"] = zeros((L, batch, cfg.ssm_conv - 1, 2 * n),
                                 cfg.dtype)
        cache["ssm"] = zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_headdim, n), torch.float32)
    return cache


def placed_cache(cfg: ModelConfig, whole: dict, pl, device) -> dict:
    """This rank's share of a decode cache shaped like ``whole`` (any
    device; ``meta`` is enough) under ``sharding.cache_specs``: zeros of
    the local shapes and ``cur_len`` 0; under a layout also ``seq_axes``,
    each K/V leaf's axes of its sequence split (a host value, as
    ``cur_len``).  With no layout, zeros of ``whole``'s shapes."""
    from repro_torch.distributed import sharding
    cache: dict = {"cur_len": 0}
    specs = None
    if pl.layout is not None:
        specs = sharding.cache_specs(cfg, pl.sizes, whole)
        cache["seq_axes"] = {}
    for name, leaf in whole.items():
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            continue
        shape = (tuple(leaf.shape) if specs is None else
                 sharding.local_shape(tuple(leaf.shape), specs[name],
                                      pl.sizes))
        cache[name] = torch.zeros(shape, dtype=leaf.dtype, device=device)
        if specs is not None and name in ("k", "v", "ck", "cv"):
            entry = specs[name][2]
            cache["seq_axes"][name] = (() if entry is None else entry
                                       if isinstance(entry, tuple)
                                       else (entry,))
    return cache


def seq_axes(cache: dict, name: str) -> tuple:
    """The axes a cache leaf's positions split over (none with no
    layout)."""
    return cache.get("seq_axes", {}).get(name, ())


def check_room(cache: dict, pl) -> None:
    """A decode step's guard: ``cur_len`` must be a position of the whole
    cache (this rank's positions times its shards over ``seq_axes``); past
    it no rank would hold the new token's K/V."""
    if cache.get("k") is None:
        return
    n = cache["k"].shape[2] * math.prod(pl.sizes[a]
                                        for a in seq_axes(cache, "k"))
    if cache["cur_len"] >= n:
        raise ValueError(f"the cache holds {n} positions; cur_len is "
                         f"{cache['cur_len']}")


def _fill_cache(cache: dict, i: int, outs: dict, t: int, pl) -> None:
    """Layer i's prefill state into this rank's share of the cache: the
    K/V of every head (gathered over 'model' where the heads split) at
    this rank's positions of the prompt's ``t``; conv and SSM states cut
    to this rank's channels or heads where the cache splits them."""
    from repro_torch.distributed import process_group
    if "k" in outs:
        s_loc = cache["k"].shape[2]
        lo = pl.seq_index(seq_axes(cache, "k")) * s_loc
        n = max(0, min(s_loc, t - lo))
        for name in ("k", "v"):
            kv = outs[name]
            if kv.shape[2] != cache[name].shape[3]:
                kv = process_group.gather_along(kv.contiguous(), 2,
                                                pl.tp_group)
            if n:
                cache[name][i, :, :n] = kv[:, lo:lo + n]
    for name, dim in (("conv_x", 2), ("conv_bc", 2), ("ssm", 1)):
        if name in outs:
            st = outs[name]
            if st.shape[dim] != cache[name].shape[dim + 1]:
                st = pl.own(st, dim)
            cache[name][i] = st


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Process the whole prompt in one forward pass AND fill the decode
    cache (per-layer K/V written at [0, T); SSM conv tails + final state).

    Returns (last-position logits (B, V), cache with cur_len = T).  Under
    a layout the cache is this rank's share (``placed_cache``)."""
    pl = common.placed(cfg)
    x, sp = _stream_in(cfg, params, batch, pl)
    b, t = x.shape[0], x.shape[1] * (pl.tp if sp else 1)
    if t > max_len:
        raise ValueError(f"prompt of {t} tokens is past max_len {max_len}")
    whole = init_cache(cfg, b * pl.dp_size(), max_len, device="meta")
    cache = placed_cache(cfg, whole, pl, x.device)
    x = _run_layers(cfg, params, x, sp, pl, cache)
    x = rms_norm(x, pl.top(params, "final_norm"), cfg.norm_eps)
    logits = pl.enter(x, sp)[:, -1] @ pl.head(params)
    cache["cur_len"] = t
    return pl.whole_logits(logits), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) and the cache
    at cur_len + 1 (its tensors updated in place)."""
    from repro_torch.distributed import process_group
    pl = common.placed(cfg)
    check_room(cache, pl)
    cur_len = cache["cur_len"]
    rows, partial = pl.embed(pl.top(params, "embed"), tokens)
    x = pl.leave(rows, False, partial=partial, dtype=rows.dtype)
    raw = common.layers(params["blocks"], cfg.n_layers)
    axes = seq_axes(cache, "k")
    for i, (w, r) in enumerate(zip(_layer_windows(cfg), raw)):
        with process_group.collective_scope("blocks"):
            p = pl.unshard_layer(r, "blocks")

            def attn(xin):
                a, part = blocks.attention_decode_placed(
                    cfg, p, xin, cache["k"][i], cache["v"][i], cur_len, pl,
                    axes, window=w)
                return pl.leave(a, False, partial=part, dtype=x.dtype)

            def ssm(xin):
                y, cx, cbc, st, part = blocks.mamba_decode_placed(
                    cfg, p, xin, cache["conv_x"][i], cache["conv_bc"][i],
                    cache["ssm"][i], pl)
                cache["conv_x"][i] = cx
                cache["conv_bc"][i] = cbc
                cache["ssm"][i] = st
                return pl.leave(y, False, partial=part, dtype=x.dtype)

            if cfg.family in ("dense", "moe", "vlm"):
                x = x + attn(rms_norm(x, p["attn_norm"], cfg.norm_eps))
            elif cfg.family == "ssm":
                x = x + ssm(rms_norm(x, p["ssm_norm"], cfg.norm_eps))
            elif cfg.family == "hybrid":
                xin = rms_norm(x, p["attn_norm"], cfg.norm_eps)
                x = x + 0.5 * (attn(xin) + ssm(xin))
            x = _mlp(cfg, p, x, False, pl)
    x = rms_norm(x, pl.top(params, "final_norm"), cfg.norm_eps)
    logits = pl.whole_logits(x @ pl.head(params))
    return logits, {**cache, "cur_len": cur_len + 1}
