"""Serve and prefill step factories, the serving half of
``repro/training/steps.py`` (its lines 213-240).

  * ``make_serve_step``   -- one decode step over the cache; with
    ``quantized=True`` over the int8 tree of
    ``models.quantization.quantize_tree``.
  * ``make_prefill_step`` -- one forward over the prompt that also fills the
    decode cache.

The train and window steps (the paper's merge strategies over an LM) are
ROADMAP queue 1, item 8b.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import quantization
from repro_torch.models.api import get_api
from repro_torch.models.common import ModelConfig

_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def make_serve_step(cfg: ModelConfig, *, quantized: bool = False
                    ) -> Callable:
    """Decode step ``(params, cache, tokens) -> (logits, cache)``.

    With ``quantized=True`` the params argument is the int8 tree.  The
    reference dequantizes the whole tree inside its jitted step, where XLA
    fuses the multiply into the matmuls.  Here the embedding, head and
    norms outside the layer stacks are dequantized whole at each step, and
    each layer's leaves as the layer loop reaches them
    (``QuantizedLeaf.layer``): the same function, with one layer's weights
    at full precision at a time."""
    api = get_api(cfg)

    def serve_step(params: dict, cache: dict, tokens: torch.Tensor):
        if quantized:
            params = {k: (v if k in _STACKS
                          else quantization.dequantize_tree(v))
                      for k, v in params.items()}
        return api.decode_step(params, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, max_len: int | None = None
                      ) -> Callable:
    """Prefill = one forward over the prompt that ALSO fills the decode
    cache (per-layer K/V at [0, T); SSM conv tails + final state).
    Returns (last-position logits, cache ready for decode at cur_len=T)."""
    api = get_api(cfg)

    def prefill_step(params: dict, batch: dict):
        t = batch["tokens"].shape[1]
        return api.prefill(params, batch, max_len or t)

    return prefill_step
