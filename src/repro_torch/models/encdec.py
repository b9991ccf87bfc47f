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
    """x: (B, T, D) queries; ck/cv: (B, F, H, Dh) from the encoder, H this
    rank's heads (its shards of ``cwq`` / ``cwo``)."""
    b, t, _ = x.shape
    h, dh = ck.shape[2], cfg.head_dim
    q = (x @ p["cwq"]).reshape(b, t, h, dh)
    scores = torch.einsum("bthd,bfhd->bhtf", q, ck).float()
    probs = torch.softmax(scores / blocks.sqrt_f32(dh), dim=-1).to(x.dtype)
    out = torch.einsum("bhtf,bfhd->bthd", probs, cv).reshape(b, t, h * dh)
    return out @ p["cwo"]


# One body an entry point, for the whole model and under a layout alike
# (``common.placed``): ``transformer``'s forms for the decoder, the
# encoder's stream split by the same rule.

def _self_attn(cfg: ModelConfig, p: dict, x: torch.Tensor, sp: bool, pl, *,
               causal: bool) -> torch.Tensor:
    h = pl.enter(rms_norm(x, p["attn_norm"], cfg.norm_eps), sp)
    a, part = blocks.attention_placed(cfg, p, h, pl, causal=causal)
    return x + pl.leave(a, sp, partial=part, dtype=x.dtype)


def _gelu(cfg: ModelConfig, p: dict, x: torch.Tensor, sp: bool, pl
          ) -> torch.Tensor:
    h = pl.enter(rms_norm(x, p["mlp_norm"], cfg.norm_eps), sp)
    y, part = blocks.mlp_placed(cfg, p, h, pl, gelu=True)
    return x + pl.leave(y, sp, partial=part, dtype=x.dtype)


def _encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            pl) -> torch.Tensor:
    """The encoder's output, whole on every rank of 'model' (gathered once
    where its stream is split; each decoder layer's cross K/V read it)."""
    from repro_torch.distributed import process_group
    x = frames.to(cfg.dtype)
    sp = pl.seq_sharded(x.shape[1])
    x = pl.leave(x, sp, partial=False, dtype=x.dtype)
    for r in common.layers(params["enc_blocks"], cfg.encoder_layers):
        with process_group.collective_scope("enc_blocks"):
            p = pl.unshard_layer(r, "enc_blocks")
            x = _self_attn(cfg, p, x, sp, pl, causal=False)
            x = _gelu(cfg, p, x, sp, pl)
    x = rms_norm(x, pl.top(params, "enc_norm"), cfg.norm_eps)
    return pl.enter(x, sp)


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    return _encode(cfg, params, frames, common.placed(cfg))


def _cross_kv(cfg: ModelConfig, p: dict, enc: torch.Tensor, pl
              ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Cross K/V of this rank's heads (every head where they do not split
    over 'model') and whether they split."""
    b, f, _ = enc.shape
    dh = cfg.head_dim
    ck = (enc @ p["cwk"]).reshape(b, f, -1, dh)
    cv = (enc @ p["cwv"]).reshape(b, f, -1, dh)
    return ck, cv, blocks._tp_ok(pl, cfg.n_heads)


def _logits(cfg: ModelConfig, params: dict, batch: dict, pl
            ) -> torch.Tensor:
    """This rank's vocabulary columns of the logits, or the whole logits
    where the vocabulary does not split."""
    from repro_torch.distributed import process_group
    enc = _encode(cfg, params, batch["frames"], pl)
    rows, partial = pl.embed(pl.top(params, "embed"), batch["tokens"])
    sp = pl.seq_sharded(rows.shape[1])
    x = pl.leave(rows, sp, partial=partial, dtype=rows.dtype)
    for r in common.layers(params["dec_blocks"], cfg.n_layers):
        with process_group.collective_scope("dec_blocks"):
            p = pl.unshard_layer(r, "dec_blocks")
            x = _self_attn(cfg, p, x, sp, pl, causal=True)
            ck, cv, part = _cross_kv(cfg, p, enc, pl)
            h = pl.enter(rms_norm(x, p["cross_norm"], cfg.norm_eps), sp)
            c = _cross_attention(cfg, p, h, ck, cv)
            x = x + pl.leave(c, sp, partial=part, dtype=x.dtype)
            x = _gelu(cfg, p, x, sp, pl)
    x = rms_norm(x, pl.top(params, "final_norm"), cfg.norm_eps)
    return pl.enter(x, sp) @ pl.head(params)  # whisper ties embeddings


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    pl = common.placed(cfg)
    return pl.whole_logits(_logits(cfg, params, batch, pl))


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    pl = common.placed(cfg)
    return pl.cross_entropy(_logits(cfg, params, batch, pl).float(),
                            batch["labels"])


def init_cache(cfg: ModelConfig, params: dict, frames: torch.Tensor,
               max_len: int) -> dict:
    """Run the encoder once, precompute per-layer cross K/V, allocate the
    decoder self-attention cache (``cur_len`` a host int).  Under a
    layout, this rank's share: the self-attention cache zeros of its
    positions, and the cross K/V of every head (gathered over 'model'
    where the heads split) at its frames."""
    from repro_torch.distributed import process_group
    from repro_torch.models import transformer
    from repro_torch.configs.registry import ShapeCell, cache_shapes
    pl = common.placed(cfg)
    b = frames.shape[0]
    enc = _encode(cfg, params, frames, pl)
    whole = cache_shapes(cfg, ShapeCell("cache", "decode", max_len,
                                        b * pl.dp_size()))
    cache = transformer.placed_cache(cfg, whole, pl, frames.device)
    f_loc = cache["ck"].shape[2]
    lo = pl.seq_index(transformer.seq_axes(cache, "ck")) * f_loc
    for i in range(cfg.n_layers):
        with process_group.collective_scope("dec_blocks"):
            p = pl.unshard_layer(common.layer_slice(params["dec_blocks"], i),
                                 "dec_blocks")
            ck, cv, part = _cross_kv(cfg, p, enc, pl)
            for name, kv in (("ck", ck), ("cv", cv)):
                if part:
                    kv = process_group.gather_along(kv.contiguous(), 2,
                                                    pl.tp_group)
                cache[name][i] = kv[:, lo:lo + f_loc]
    return cache


def _cross_decode(cfg: ModelConfig, p: dict, h: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, pl, axes: tuple
                  ) -> tuple[torch.Tensor, bool]:
    """One token's cross-attention over this rank's frames of the cached
    cross K/V (every head), ``(out, partial)``.  Where neither the heads
    nor the frames split it is ``_cross_attention``; else the new token's
    query heads are gathered over 'model', ``blocks.split_attend`` combines
    the ranks' softmax (f32 partials, as the ranks' sum needs) and each
    rank's own heads' columns go through its ``cwo`` rows."""
    from repro_torch.distributed import process_group
    part = blocks._tp_ok(pl, cfg.n_heads)
    if not part and not blocks.seq_split(pl, axes):
        return _cross_attention(cfg, p, h, ck, cv), False
    dh = cfg.head_dim
    q = (h @ p["cwq"]).reshape(h.shape[0], 1, -1, dh)
    if part:
        q = process_group.gather_along(q, 2, pl.tp_group)
    lo = pl.seq_index(axes) * ck.shape[1]
    c = blocks.split_attend(q, ck, cv, lo, None, 0, pl, axes).to(h.dtype)
    if part:
        c = blocks._mine(c, pl, cfg.n_heads, dh)
    return c @ p["cwo"], part


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step; the self-attention cache is written in place."""
    from repro_torch.distributed import process_group
    from repro_torch.models import transformer
    pl = common.placed(cfg)
    transformer.check_room(cache, pl)
    cur_len = cache["cur_len"]
    rows, partial = pl.embed(pl.top(params, "embed"), tokens)
    x = pl.leave(rows, False, partial=partial, dtype=rows.dtype)
    for i in range(cfg.n_layers):
        with process_group.collective_scope("dec_blocks"):
            p = pl.unshard_layer(common.layer_slice(params["dec_blocks"], i),
                                 "dec_blocks")
            a, part = blocks.attention_decode_placed(
                cfg, p, rms_norm(x, p["attn_norm"], cfg.norm_eps),
                cache["k"][i], cache["v"][i], cur_len, pl,
                transformer.seq_axes(cache, "k"))
            x = x + pl.leave(a, False, partial=part, dtype=x.dtype)
            c, part = _cross_decode(
                cfg, p, rms_norm(x, p["cross_norm"], cfg.norm_eps),
                cache["ck"][i], cache["cv"][i], pl,
                transformer.seq_axes(cache, "ck"))
            x = x + pl.leave(c, False, partial=part, dtype=x.dtype)
            x = _gelu(cfg, p, x, False, pl)
    x = rms_norm(x, pl.top(params, "final_norm"), cfg.norm_eps)
    logits = pl.whole_logits(x @ pl.head(params))
    return logits, {**cache, "cur_len": cur_len + 1}
