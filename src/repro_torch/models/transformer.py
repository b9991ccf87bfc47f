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

import torch
import torch.nn.functional as F

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

def _mixer(cfg: ModelConfig, p: dict, x: torch.Tensor, window: int,
           state: bool):
    """The attention / SSM half of a layer over (B, T, D): returns the new
    residual stream and, with ``state``, the decode-cache leaves it leaves
    (K/V, conv tails, SSM state)."""
    outs: dict = {}
    if cfg.family in ("dense", "moe", "vlm"):
        a = blocks.attention_train(
            cfg, p, rms_norm(x, p["attn_norm"], cfg.norm_eps),
            return_kv=state)
        if state:
            a, outs["k"], outs["v"] = a
        x = x + a
    elif cfg.family == "ssm":
        s = blocks.mamba_train(
            cfg, p, rms_norm(x, p["ssm_norm"], cfg.norm_eps),
            return_state=state)
        if state:
            s, outs["conv_x"], outs["conv_bc"], outs["ssm"] = s
        x = x + s
    elif cfg.family == "hybrid":
        # hymba: attention and SSM heads run in PARALLEL on the same input,
        # outputs are averaged (normalized fusion).
        xin = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        a = blocks.attention_train(cfg, p, xin, window=window,
                                   return_kv=state)
        s = blocks.mamba_train(cfg, p, xin, return_state=state)
        if state:
            a, outs["k"], outs["v"] = a
            s, outs["conv_x"], outs["conv_bc"], outs["ssm"] = s
        x = x + 0.5 * (a + s)
    return x, outs


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.family == "moe":
        return x + blocks.moe_apply(
            cfg, p, rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    if cfg.family in _MLP:
        return x + blocks.swiglu(
            {k: p[k] for k in _MLP_KEYS},
            rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    return x


def _embed_inputs(cfg: ModelConfig, params: dict,
                  batch: dict) -> torch.Tensor:
    """Token embeddings; VLM prepends stub patch embeddings (precomputed by
    the frontend stub, see ``configs.registry.input_specs``)."""
    # F.embedding's backward sums a repeated token's rows in a fixed order
    # on the card; params["embed"][tokens] backs through an atomic
    # accumulate
    emb = F.embedding(batch["tokens"], params["embed"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        emb = torch.cat([batch["patch_embeds"].to(emb.dtype), emb], dim=1)
    return emb


def _head(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """One layer (its leaves ``p``) over the (B, T, D) residual stream."""
    x, _ = _mixer(cfg, p, x, window, state=False)
    return _mlp(cfg, p, x)


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    x = _embed_inputs(cfg, params, batch)
    for w, p in zip(_layer_windows(cfg),
                    common.layers(params["blocks"], cfg.n_layers)):
        x = block_apply(cfg, p, x, w)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(cfg, params)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            *, aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token CE in f32 (+ Switch-style load-balance loss for MoE, on
    the first layer's router, as the reference).

    VLM: patch positions carry no labels; the loss is computed on the token
    suffix only.
    """
    logits = forward(cfg, params, batch).float()
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    labels = batch["labels"]
    ce = common.cross_entropy(logits[:, : labels.shape[1]], labels)
    if cfg.family == "moe":
        x = _embed_inputs(cfg, params, batch)
        aux = blocks.moe_aux_loss(
            cfg, common.layer_slice(params["blocks"], 0), x)
        ce = ce + aux_weight * aux
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


def _block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  i: int, cur_len: int, window: int) -> torch.Tensor:
    """Layer ``i`` of one decode step; writes its cache leaves in place."""

    def ssm(xin):
        s, cx, cbc, st = blocks.mamba_decode(
            cfg, p, xin, cache["conv_x"][i], cache["conv_bc"][i],
            cache["ssm"][i])
        cache["conv_x"][i] = cx
        cache["conv_bc"][i] = cbc
        cache["ssm"][i] = st
        return s

    if cfg.family in ("dense", "moe", "vlm"):
        x = x + blocks.attention_decode(
            cfg, p, rms_norm(x, p["attn_norm"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], cur_len)
    elif cfg.family == "ssm":
        x = x + ssm(rms_norm(x, p["ssm_norm"], cfg.norm_eps))
    elif cfg.family == "hybrid":
        xin = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        a = blocks.attention_decode(cfg, p, xin, cache["k"][i],
                                    cache["v"][i], cur_len, window=window)
        s = ssm(xin)
        x = x + 0.5 * (a + s)
    return _mlp(cfg, p, x)


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Process the whole prompt in one forward pass AND fill the decode
    cache (per-layer K/V written at [0, T); SSM conv tails + final state).

    Returns (last-position logits (B, V), cache with cur_len = T)."""
    x = _embed_inputs(cfg, params, batch)
    b, t, _ = x.shape
    if t > max_len:
        raise ValueError(f"prompt of {t} tokens is past max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, w in enumerate(_layer_windows(cfg)):
        p = common.layer_slice(params["blocks"], i)
        x, outs = _mixer(cfg, p, x, w, state=True)
        x = _mlp(cfg, p, x)
        if "k" in outs:
            cache["k"][i, :, :t] = outs["k"]
            cache["v"][i, :, :t] = outs["v"]
        for name in ("conv_x", "conv_bc", "ssm"):
            if name in outs:
                cache[name][i] = outs[name]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1] @ _head(cfg, params)
    cache["cur_len"] = t
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) and the cache
    at cur_len + 1 (its tensors updated in place)."""
    cur_len = cache["cur_len"]
    if cache.get("k") is not None and cur_len >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions; "
                         f"cur_len is {cur_len}")
    x = params["embed"][tokens]
    for i, w in enumerate(_layer_windows(cfg)):
        p = common.layer_slice(params["blocks"], i)
        x = _block_decode(cfg, p, x, cache, i, cur_len, w)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _head(cfg, params)
    return logits, {**cache, "cur_len": cur_len + 1}

