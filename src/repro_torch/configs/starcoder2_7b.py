"""starcoder2-7b — BigCode StarCoder2 7B [arXiv:2402.19173; hf].

GQA (4 KV heads), RoPE.  36 q-heads do NOT divide the 16-way TP axis, so
attention runs replicated on 'model' and the MLP carries the TP sharding
(the policy of ``distributed/sharding.py``, the reference's and the
port's).
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152,
    rope_theta=1000000.0, dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense", n_layers=2, d_model=144,
        n_heads=6, n_kv_heads=2, d_ff=512, vocab=512, dtype=torch.float32)
