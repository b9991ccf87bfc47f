"""whisper-tiny — OpenAI Whisper tiny [arXiv:2212.04356; unverified].

Encoder-decoder; conv/mel frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, 1500, 384).
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    encoder_layers=4, encoder_frames=1500, tie_embeddings=True,
    dtype=torch.bfloat16,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, encoder_layers=2,
        encoder_frames=16, tie_embeddings=True, dtype=torch.float32)
