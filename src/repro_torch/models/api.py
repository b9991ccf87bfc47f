"""Family dispatcher, counterpart of ``repro/models/api.py``: one uniform
API over all model families."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import encdec, transformer
from repro_torch.models.common import ModelConfig


class ModelAPI(NamedTuple):
    init: Callable             # (seed=0, device=None) -> params
    forward: Callable
    loss_fn: Callable
    init_cache: Callable
    decode_step: Callable
    prefill: Callable          # (params, batch, max_len) -> (logits, cache)


def _encdec_prefill(cfg, params, batch, max_len):
    cache = encdec.init_cache(cfg, params, batch["frames"], max_len)
    logits = encdec.forward(cfg, params, batch)[:, -1]
    # as in the reference: the teacher-forced prompt positions are left to
    # the caller's decode loop, and the decoder self-cache starts empty at
    # cur_len = 0 (whisper prompts are short)
    return logits, cache


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "encdec":
        return ModelAPI(
            init=lambda seed=0, device=None: encdec.init(
                cfg, seed, device=device),
            forward=lambda params, batch: encdec.forward(cfg, params, batch),
            loss_fn=lambda params, batch: encdec.loss_fn(cfg, params, batch),
            init_cache=lambda params, batch, max_len: encdec.init_cache(
                cfg, params, batch["frames"], max_len),
            decode_step=lambda params, cache, tokens: encdec.decode_step(
                cfg, params, cache, tokens),
            prefill=lambda params, batch, max_len: _encdec_prefill(
                cfg, params, batch, max_len),
        )
    return ModelAPI(
        init=lambda seed=0, device=None: transformer.init(
            cfg, seed, device=device),
        forward=lambda params, batch: transformer.forward(cfg, params, batch),
        loss_fn=lambda params, batch: transformer.loss_fn(cfg, params, batch),
        init_cache=lambda params, batch, max_len: transformer.init_cache(
            cfg, batch["tokens"].shape[0], max_len,
            device=batch["tokens"].device),
        decode_step=lambda params, cache, tokens: transformer.decode_step(
            cfg, params, cache, tokens),
        prefill=lambda params, batch, max_len: transformer.prefill(
            cfg, params, batch, max_len),
    )
