"""granite-8b — IBM Granite Code 8B [arXiv:2405.04324; hf]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152,
    rope_theta=10000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=384, vocab=512, dtype=torch.float32)
