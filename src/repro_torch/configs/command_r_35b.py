"""command-r-35b — Cohere Command-R v01 [hf:CohereForAI/c4ai-command-r-v01; unverified].

GQA (8 KV heads), no biases, 256k vocab.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000,
    rope_theta=8000000.0, use_bias=False, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=352, vocab=1000, dtype=torch.float32)
