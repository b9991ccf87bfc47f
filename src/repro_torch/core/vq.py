"""Sequential stochastic VQ (online k-means), paper eqs. (1), (2), (4), (5).

Counterpart of ``repro/core/vq.py``.  The functions take optional leading
dimensions: ``z (..., d)`` / ``w (..., kappa, d)``, so M stacked workers are
one call (the reference ``vmap``s instead).  ``w`` may lack the leading
dimensions, in which case it is shared by every worker.

Distances are spelled exactly as the reference spells them,
``||z||^2 - 2 z.w^T + ||w||^2``; assignments come back as int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class VQState(NamedTuple):
    """Carried state of a sequential VQ run."""

    w: torch.Tensor  # (..., kappa, d) prototypes
    t: int           # step counter (drives the step schedule)


def squared_distances(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``(..., batch, kappa)`` by the matmul
    expansion; z: (..., batch, d), w: (..., kappa, d)."""
    z2 = torch.sum(z * z, dim=-1, keepdim=True)      # (..., batch, 1)
    w2 = torch.sum(w * w, dim=-1)                    # (..., kappa)
    cross = z @ w.transpose(-1, -2)                  # (..., batch, kappa)
    return z2 - 2.0 * cross + w2.unsqueeze(-2)


def nearest(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmin_l ||z - w_l||^2 per row of ``z`` (first index on ties), int32."""
    return torch.argmin(squared_distances(z, w), dim=-1).to(torch.int32)


def H(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Paper eq. (4): z (..., d), w (..., kappa, d) -> (..., kappa, d),
    nonzero only on the winning row."""
    idx = nearest(z.unsqueeze(-2), w)[..., 0]
    onehot = F.one_hot(idx.long(), w.shape[-2]).to(w.dtype)   # (..., kappa)
    return onehot.unsqueeze(-1) * (w - z.unsqueeze(-2))


def H_batch(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum of ``H(z_b, w)`` over a minibatch z (..., batch, d) as a one-hot
    matmul: ``counts * w - zsum``."""
    idx = nearest(z, w)
    onehot = F.one_hot(idx.long(), w.shape[-2]).to(w.dtype)   # (..., b, kappa)
    counts = torch.sum(onehot, dim=-2)
    zsum = onehot.transpose(-1, -2) @ z
    return counts.unsqueeze(-1) * w - zsum


def distortion(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Paper eq. (2) per worker: mean_t min_l ||z_t - w_l||^2 over the
    second-to-last dimension of z (..., n, d)."""
    return torch.mean(torch.min(squared_distances(z, w), dim=-1).values,
                      dim=-1)


def distortion_multi(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eq. (2) over M workers: z is (M, n, d); normalizes by n*M."""
    return torch.mean(distortion(z, w))


def default_steps(t: torch.Tensor, *, eps0: float = 0.5,
                  decay: float = 1.0) -> torch.Tensor:
    """The Robbins-Monro schedule ``eps_t = eps0 / (1 + decay * t)`` in f32.

    The numerator is a tensor on purpose: ``float / tensor`` in torch is
    ``reciprocal(t) * float``, which rounds differently from the division
    the reference does."""
    t = torch.as_tensor(t)
    den = 1.0 + decay * t.to(torch.float32)
    return torch.full_like(den, eps0) / den


def vq_step(state: VQState, z: torch.Tensor, *, eps0: float = 0.5,
            decay: float = 1.0) -> VQState:
    """One sequential VQ iteration, paper eq. (1)."""
    eps = default_steps(torch.tensor(state.t + 1, device=z.device),
                        eps0=eps0, decay=decay)
    return VQState(w=state.w - eps * H(z, state.w), t=state.t + 1)


def vq_run(w0: torch.Tensor, data: torch.Tensor, *, t0: int = 0,
           eps0: float = 0.5, decay: float = 1.0) -> VQState:
    """Sequential VQ over ``data`` (..., n, d) in order (eq. 5 unrolled).

    A shared ``w0`` (kappa, d) is expanded to one codebook per leading
    stream, so every step sees the same shapes."""
    w = w0.expand(*data.shape[:-2], *w0.shape[-2:]).clone()
    state = VQState(w=w, t=int(t0))
    for i in range(data.shape[-2]):
        state = vq_step(state, data[..., i, :], eps0=eps0, decay=decay)
    return state


def window_displacement(w0: torch.Tensor, data: torch.Tensor, t0: int, *,
                        eps0: float = 0.5, decay: float = 1.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Delta over tau sequential steps from ``w0`` at global step ``t0``
    (paper eq. 7).  Returns ``(delta, w_final)`` with
    ``w_final = w0 - delta``."""
    final = vq_run(w0, data, t0=t0, eps0=eps0, decay=decay)
    return w0 - final.w, final.w
