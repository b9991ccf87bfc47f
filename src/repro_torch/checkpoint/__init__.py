from repro_torch.checkpoint.checkpointing import Checkpointer  # noqa: F401
