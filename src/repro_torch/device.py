"""Where the port runs: ``cuda`` unless the caller asks for the CPU.

Entry points take ``device=None`` (meaning ``cuda``) or an explicit
``"cpu"``.  Asking for CUDA on a machine without a card raises; nothing
quietly carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
