"""granite-34b — IBM Granite Code 34B [arXiv:2405.04324; hf].

Llama-arch dense decoder, MQA (1 KV head), code vocab 49152.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152,
    rope_theta=10000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=1, d_ff=512, vocab=512, dtype=torch.float32)
