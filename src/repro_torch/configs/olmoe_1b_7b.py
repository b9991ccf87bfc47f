"""olmoe-1b-7b — AllenAI OLMoE-1B-7B [arXiv:2409.02060; hf].

MoE: 64 experts, top-8, per-expert d_ff 1024.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, rope_theta=10000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=512, n_experts=8, top_k=2,
        dtype=torch.float32)
