"""internvl2-76b — InternVL2 76B backbone (InternLM2/Llama3-70B-style LLM)
[arXiv:2404.16821; unverified].

The InternViT frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 256, d_model) prepended to the token sequence.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
    img_tokens=256, rope_theta=500000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=448, vocab=512, img_tokens=8,
        dtype=torch.float32)
