"""moonshot-v1-16b-a3b — Moonshot Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf].

MoE: 64 experts, top-6, per-expert d_ff 1408.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, rope_theta=50000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=96, vocab=512, n_experts=8, top_k=2,
        dtype=torch.float32)
