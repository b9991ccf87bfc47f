"""mamba2-2.7b — Mamba-2 SSD 2.7B [arXiv:2405.21060; unverified].

Attention-free; state-space duality with d_state=128, headdim=64, expand=2.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    tie_embeddings=True, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=128,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=512, ssm_state=16,
        ssm_expand=2, ssm_headdim=32, ssm_conv=4, tie_embeddings=True,
        dtype=torch.float32)
