"""The synthetic, step-indexed LM data pipeline, counterpart of
``repro/data/pipeline.py``.

Batch ``i`` is a pure function of ``(seed, step)``: a restart from a
checkpoint replays the exact stream with no stored iterator state.  Each
batch is drawn on the CPU from a ``torch.Generator`` seeded from ``(seed,
step)`` and then moved to the device, so the card and the CPU see the same
tokens.  The draws are not the reference's (its are JAX's PRNG): the
distribution and the structure are.

Tokens follow a Zipfian unigram distribution with a Markov kick: with
p = 0.5 a position takes the previous position's base token plus 1, mod V,
a bigram structure the loss can learn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, step)``: the pair hashed to the
    32 bits the CPU generator's Mersenne twister keeps of a seed."""
    (mixed,) = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    return torch.Generator().manual_seed(int(mixed))


def _zipf_probs(vocab: int) -> torch.Tensor:
    return 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)


def lm_batch(cfg: DataConfig, step: int, *, device=None) -> dict:
    """One ``{"tokens", "labels"}`` batch of (global_batch, seq_len) int32
    on ``device`` (the card unless the caller asks for the CPU); labels are
    the next tokens."""
    gen = step_generator(cfg.seed, step)
    shape = (cfg.global_batch, cfg.seq_len + 1)
    base = torch.multinomial(_zipf_probs(cfg.vocab), shape[0] * shape[1],
                             replacement=True, generator=gen).view(shape)
    flip = torch.rand(shape, generator=gen) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    stream = torch.where(flip, (shifted + 1) % cfg.vocab, base).to(
        torch.int32)
    dev = device_lib.resolve(device)
    return {"tokens": stream[:, :-1].contiguous().to(dev),
            "labels": stream[:, 1:].contiguous().to(dev)}


def vq_batch(cfg: DataConfig, step: int, *, d: int, n_centers: int = 10,
             noise: float = 0.05, device=None) -> torch.Tensor:
    """(global_batch, d) f32 samples of a mixture of ``n_centers`` uniform
    centres (drawn from ``seed + 7919``) with Gaussian noise, on
    ``device``."""
    centers = torch.rand((n_centers, d),
                         generator=step_generator(cfg.seed + 7919, 0))
    gen = step_generator(cfg.seed, step)
    assign = torch.randint(0, n_centers, (cfg.global_batch,), generator=gen)
    out = centers[assign] + noise * torch.randn((cfg.global_batch, d),
                                                generator=gen)
    return out.to(device_lib.resolve(device))
