"""Synthetic data, counterpart of ``repro/data/synthetic.py``.

The same family as the reference (an isotropic Gaussian mixture over
uniform random centers in ``[0, 1]^d``, the paper's experiments), drawn from
an explicit ``torch.Generator`` on the generator's device, so a full-size
stream is made where it is used.  The numbers differ from the reference's
JAX draws for the same seed; tests that compare the two packages make their
inputs with numpy instead.  ``numpy_mixture`` draws the same family with
numpy from an integer seed, on the host: the comm sweeps, the dry run and the
examples take their inputs from it.
"""

from __future__ import annotations

import numpy as np
import torch


def mixture_data(gen: torch.Generator, *, n: int, d: int,
                 n_centers: int = 10, noise: float = 0.05) -> torch.Tensor:
    """(n, d) f32 samples from a uniform-center isotropic Gaussian mixture."""
    dev = gen.device
    centers = torch.rand((n_centers, d), generator=gen, device=dev)
    assign = torch.randint(0, n_centers, (n,), generator=gen, device=dev)
    eps = noise * torch.randn((n, d), generator=gen, device=dev)
    return centers[assign] + eps


def split_workers(data: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n // m, d): disjoint per-worker streams."""
    n = data.shape[0] // m * m
    return data[:n].reshape(m, -1, data.shape[-1])


def replicate_stream(gen: torch.Generator, m: int, *, n: int, d: int,
                     n_centers: int = 10, noise: float = 0.05
                     ) -> torch.Tensor:
    """(m, n, d): m i.i.d. streams of length n from one mixture (every
    worker owns n local points, as in the paper's speed-up runs)."""
    dev = gen.device
    centers = torch.rand((n_centers, d), generator=gen, device=dev)
    assign = torch.randint(0, n_centers, (m, n), generator=gen, device=dev)
    eps = noise * torch.randn((m, n, d), generator=gen, device=dev)
    return centers[assign] + eps


def kmeanspp_init(gen: torch.Generator, data: torch.Tensor,
                  kappa: int) -> torch.Tensor:
    """w(0): kappa distinct points of ``data`` (n, d) drawn at random, as the
    reference's ``kmeanspp_init`` does."""
    if kappa > data.shape[0]:
        raise ValueError(f"kappa={kappa} > {data.shape[0]} points")
    idx = torch.randperm(data.shape[0], generator=gen, device=gen.device)
    return data[idx[:kappa].to(data.device)].clone()


def numpy_mixture(seed: int, m: int, n: int, d: int, kappa: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(w0 (kappa, d), data (m, n, d))`` f32 CPU tensors drawn with numpy
    from ``seed``: m streams of n points from a mixture of 10 uniform
    centers with N(0, 0.05^2) noise, and w0 kappa distinct points of them."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, d))).astype(np.float32)
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)]
    return torch.from_numpy(np.ascontiguousarray(w0)), torch.from_numpy(data)
