"""The LM families, counterpart of ``repro/models``: dense, MoE, Mamba2
(SSM), Hymba (hybrid), InternVL2's backbone (VLM) and Whisper (enc-dec),
with int8 weight-only quantization for serving.  ``api.get_api(cfg)`` is
the one entry."""
