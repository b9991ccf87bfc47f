"""Encoder-decoder transformer (whisper-family backbone), counterpart of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: ``batch["frames"]``
are precomputed frame embeddings (B, F, d_model).  Encoder: non-causal
self-attention + GELU MLP.  Decoder: causal self-attention +
cross-attention + GELU MLP.  RoPE stands in for whisper's positions, as in
the reference.  Whisper ties its embeddings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import blocks, common
from repro_torch.models.common import ModelConfig, rms_norm


def _init_mlp(cfg: ModelConfig, gen, L: int, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_up": common.init_dense(gen, (L, d, f), cfg.dtype, device=device),
        "w_down": common.init_dense(gen, (L, f, d), cfg.dtype,
                                    device=device),
    }


def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random params from a generator on ``device`` seeded by ``seed`` (the
    card unless the caller asks for the CPU; ``meta``: shapes only), with
    the reference's leaf names, shapes and dtypes."""
    dev = common.init_device(device)
    gen = common.make_generator(seed, dev)
    Le, Ld, d = cfg.encoder_layers, cfg.n_layers, cfg.d_model
    h, dh = cfg.n_heads, cfg.head_dim

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def dense(shape):
        return common.init_dense(gen, shape, cfg.dtype, device=dev)

    enc = {
        **blocks.init_attention(cfg, gen, Le, device=dev),
        **_init_mlp(cfg, gen, Le, dev),
        "attn_norm": ones(Le, d),
        "mlp_norm": ones(Le, d),
    }
    dec = {
        **blocks.init_attention(cfg, gen, Ld, device=dev),
        **_init_mlp(cfg, gen, Ld, dev),
        "attn_norm": ones(Ld, d),
        "mlp_norm": ones(Ld, d),
        "cross_norm": ones(Ld, d),
        "cwq": dense((Ld, d, h * dh)),
        "cwk": dense((Ld, d, h * dh)),
        "cwv": dense((Ld, d, h * dh)),
        "cwo": dense((Ld, h * dh, d)),
    }
    return {
        "enc_blocks": enc,
        "dec_blocks": dec,
        "embed": common.init_dense(gen, (cfg.vocab, d), cfg.dtype,
                                   scale=1.0, device=dev),
        "enc_norm": ones(d),
        "final_norm": ones(d),
    }


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) queries; ck/cv: (B, F, H, Dh) precomputed from the
    encoder."""
    b, t, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["cwq"]).reshape(b, t, h, dh)
    scores = torch.einsum("bthd,bfhd->bhtf", q, ck).float()
    probs = torch.softmax(scores / blocks.sqrt_f32(dh), dim=-1).to(x.dtype)
    out = torch.einsum("bhtf,bfhd->bthd", probs, cv).reshape(b, t, h * dh)
    return out @ p["cwo"]


def _cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    b, f, _ = enc_out.shape
    h, dh = cfg.n_heads, cfg.head_dim
    ck = (enc_out @ p["cwk"]).reshape(b, f, h, dh)
    cv = (enc_out @ p["cwv"]).reshape(b, f, h, dh)
    return ck, cv


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    x = frames.to(cfg.dtype)
    for p in common.layers(params["enc_blocks"], cfg.encoder_layers):
        x = x + blocks.attention_train(
            cfg, p, rms_norm(x, p["attn_norm"], cfg.norm_eps), causal=False)
        x = x + blocks.gelu_mlp(p, rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"])
    x = F.embedding(batch["tokens"], params["embed"])  # a fixed-order backward
    for p in common.layers(params["dec_blocks"], cfg.n_layers):
        x = x + blocks.attention_train(
            cfg, p, rms_norm(x, p["attn_norm"], cfg.norm_eps))
        ck, cv = _cross_kv(cfg, p, enc_out)
        x = x + _cross_attention(
            cfg, p, rms_norm(x, p["cross_norm"], cfg.norm_eps), ck, cv)
        x = x + blocks.gelu_mlp(p, rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T  # whisper ties embeddings


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    return common.cross_entropy(forward(cfg, params, batch).float(),
                                batch["labels"])


def init_cache(cfg: ModelConfig, params: dict, frames: torch.Tensor,
               max_len: int) -> dict:
    """Run the encoder once, precompute per-layer cross K/V, allocate the
    decoder self-attention cache (``cur_len`` a host int)."""
    enc_out = encode(cfg, params, frames)
    kv = [_cross_kv(cfg, common.layer_slice(params["dec_blocks"], i),
                    enc_out) for i in range(cfg.n_layers)]
    L, b = cfg.n_layers, frames.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    zeros = lambda: torch.zeros((L, b, max_len, hkv, dh),  # noqa: E731
                                dtype=cfg.dtype, device=frames.device)
    return {
        "cur_len": 0,
        "k": zeros(),
        "v": zeros(),
        "ck": torch.stack([c for c, _ in kv]),   # (L, B, F, H, Dh)
        "cv": torch.stack([c for _, c in kv]),
    }


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step; the self-attention cache is written in place."""
    cur_len = cache["cur_len"]
    if cur_len >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions; "
                         f"cur_len is {cur_len}")
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        p = common.layer_slice(params["dec_blocks"], i)
        x = x + blocks.attention_decode(
            cfg, p, rms_norm(x, p["attn_norm"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], cur_len)
        x = x + _cross_attention(
            cfg, p, rms_norm(x, p["cross_norm"], cfg.norm_eps),
            cache["ck"][i], cache["cv"][i])
        x = x + blocks.gelu_mlp(p, rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["embed"].T
    return logits, {**cache, "cur_len": cur_len + 1}
