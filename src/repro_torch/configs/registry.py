"""Architecture registry, counterpart of ``repro/configs/registry.py``:
``get_config(arch_id)``, the shape cells and the input specs.

Every architecture is a module ``configs/<id>.py`` exposing ``CONFIG`` (the
published dims) and ``smoke_config()`` (a reduced config of the same family
for CPU tests), the reference's own copies with torch dtypes.  The specs
are tensors on the ``meta`` device, the counterpart of the reference's
``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "granite_34b", "granite_8b", "starcoder2_7b", "command_r_35b",
    "whisper_tiny", "moonshot_v1_16b_a3b", "olmoe_1b_7b", "mamba2_2p7b",
    "internvl2_76b", "hymba_1p5b",
]

# archs whose params + optimizer state the reference shards ZeRO-3 style
# over its 'data' axis to fit a v5e chip (its registry's note)
FSDP_ARCHS = {"granite_34b", "command_r_35b", "internvl2_76b",
              "moonshot_v1_16b_a3b", "starcoder2_7b"}

_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = [
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
]

# long_500k needs sub-quadratic decode state: run only for SSM/hybrid
LONG_OK_FAMILIES = {"ssm", "hybrid"}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.smoke_config()


def uses_fsdp(arch_id: str) -> bool:
    return arch_id in FSDP_ARCHS


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) pair."""
    if cell.name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, "full quadratic attention at 524k context (DESIGN.md §4)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, cell: ShapeCell, *, tau: int | None = None
                ) -> dict:
    """Meta tensors standing in for every model input of this cell.

    ``tau``: if given (window step), a leading tau dim is added to each leaf.
    """
    b, t = cell.global_batch, cell.seq_len

    def tok(shape):
        return _spec(shape, torch.int32)

    if cell.kind in ("train", "prefill"):
        t_text = t
        batch: dict = {}
        if cfg.family == "vlm":
            t_text = t - cfg.img_tokens
            batch["patch_embeds"] = _spec(
                (b, cfg.img_tokens, cfg.d_model), cfg.dtype)
        if cfg.family == "encdec":
            batch["frames"] = _spec(
                (b, cfg.encoder_frames, cfg.d_model), cfg.dtype)
        batch["tokens"] = tok((b, t_text))
        if cell.kind == "train":
            batch["labels"] = tok((b, t_text))
        if tau is not None:
            batch = {k: _spec((tau, *s.shape), s.dtype)
                     for k, s in batch.items()}
        return batch
    # decode: one new token against a cache of length seq_len
    return {"tokens": tok((b, 1))}


def cache_shapes(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta tensors of the decode cache for a decode cell.  ``cur_len``, a
    host int in a live cache, is a () int32 here, as in the reference."""
    from repro_torch.models import transformer

    cur_len = _spec((), torch.int32)
    if cfg.family == "encdec":
        L, b = cfg.n_layers, cell.global_batch
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        h = cfg.n_heads
        return {
            "cur_len": cur_len,
            "k": _spec((L, b, cell.seq_len, hkv, dh), cfg.dtype),
            "v": _spec((L, b, cell.seq_len, hkv, dh), cfg.dtype),
            "ck": _spec((L, b, cfg.encoder_frames, h, dh), cfg.dtype),
            "cv": _spec((L, b, cfg.encoder_frames, h, dh), cfg.dtype),
        }
    cache = transformer.init_cache(cfg, cell.global_batch, cell.seq_len,
                                   device=_META)
    return {**cache, "cur_len": cur_len}
