"""Where the port runs: ``cuda`` unless the caller asks for the CPU.

Entry points take ``device=None`` (meaning ``cuda``) or an explicit
``"cpu"``.  Asking for CUDA on a machine without a card raises; nothing
quietly carries on on the CPU.  The launchers also pin f32 products to full
f32 (``pin_full_f32``).  ``synchronize`` ends a timed region on the card.
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


def pin_full_f32() -> None:
    """Run f32 matrix products and convolutions in full f32 for the rest of
    the process, whatever the caller set before: TF32 keeps about three
    decimal digits and would flip near-tie assignments against the f32
    reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(dev: torch.device) -> None:
    """Wait until ``dev`` has run everything queued on it: a host clock read
    after this call sees the device's work done.  A no-op on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
