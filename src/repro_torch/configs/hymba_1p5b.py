"""hymba-1.5b — NVIDIA Hymba 1.5B [arXiv:2411.13676; hf].

Hybrid: attention and Mamba heads run in PARALLEL in every layer; most
layers use sliding-window attention (window 1024) with 3 global layers
(first / middle / last).  25 q-heads don't divide TP=16, so attention is
replicated on 'model'; the SSM inner dim (3200) and MLP carry the TP shard.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    window=1024, rope_theta=10000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid", n_layers=3, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, ssm_state=8,
        ssm_expand=2, ssm_headdim=32, ssm_conv=4, window=8,
        dtype=torch.float32)
