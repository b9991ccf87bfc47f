"""Plain PyTorch oracles for the kernels, counterpart of ``repro/kernels/ref.py``.

Each takes optional leading dimensions: z (..., batch, d), w (..., kappa, d).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def vq_assign_ref(z: torch.Tensor, w: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-prototype assignment: (assign int32, mindist f32), each
    (..., batch)."""
    z32 = z.to(torch.float32)
    w32 = w.to(torch.float32)
    z2 = torch.sum(z32 * z32, dim=-1, keepdim=True)
    w2 = torch.sum(w32 * w32, dim=-1)
    d2 = z2 - 2.0 * (z32 @ w32.transpose(-1, -2)) + w2.unsqueeze(-2)
    return torch.argmin(d2, dim=-1).to(torch.int32), torch.min(d2, dim=-1).values


def vq_delta_ref(z: torch.Tensor, w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minibatch VQ displacement statistics ``(counts (..., kappa),
    zsum (..., kappa, d))``; the displacement is ``counts * w - zsum``."""
    assign, _ = vq_assign_ref(z, w)
    onehot = F.one_hot(assign.long(), w.shape[-2]).to(torch.float32)
    counts = torch.sum(onehot, dim=-2)
    zsum = onehot.transpose(-1, -2) @ z.to(torch.float32)
    return counts, zsum


def distortion_ref(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of min_l ||z - w_l||^2 (paper eq. 2 per worker)."""
    _, mind = vq_assign_ref(z, w)
    return torch.mean(mind, dim=-1)
