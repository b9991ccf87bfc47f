"""Synchronous parallelization schemes, paper Sections 2 and 3: the oracles.

Counterpart of ``repro/core/schemes.py``.  M workers run tau sequential VQ
steps from the shared codebook (one stacked ``(M, kappa, d)`` tensor where
the reference ``vmap``s), then synchronize:

  * ``scheme_average`` (eq. 3): ``w_srd = mean_i w^i(tau)``, the scheme the
    paper shows does NOT speed up convergence;
  * ``scheme_delta`` (eq. 8): ``w_srd <- w_srd - sum_i Delta^i``.

One window costs ``tau`` wall ticks (instant communication); the returned
curves are indexed by wall tick.  These are plain PyTorch loops and the
yardstick the port's executors are held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import vq


class SchemeResult(NamedTuple):
    w_shared: torch.Tensor    # (kappa, d) final shared prototypes
    wall_ticks: torch.Tensor  # (n_windows,) int32 wall time at each sync
    distortion: torch.Tensor  # (n_windows,) eq. (2) of w_srd at each sync


def _windows(data: torch.Tensor, tau: int) -> torch.Tensor:
    """(M, n, d) -> (n_windows, M, tau, d), dropping the ragged tail."""
    m, n, d = data.shape
    n_windows = n // tau
    usable = data[:, : n_windows * tau, :]
    return usable.reshape(m, n_windows, tau, d).transpose(0, 1)


def _run(merge, w0, data, eval_data, *, tau, eps0, decay) -> SchemeResult:
    w_srd, t0 = w0, 0
    ticks, curve = [], []
    for zwin in _windows(data, tau):
        deltas, w_fin = vq.window_displacement(w_srd, zwin, t0, eps0=eps0,
                                               decay=decay)
        w_srd = merge(w_srd, deltas, w_fin)
        t0 += tau
        ticks.append(t0)
        curve.append(vq.distortion_multi(eval_data, w_srd))
    return SchemeResult(
        w_shared=w_srd,
        wall_ticks=torch.tensor(ticks, dtype=torch.int32),
        distortion=torch.stack(curve) if curve else torch.zeros(0))


def scheme_average(w0: torch.Tensor, data: torch.Tensor,
                   eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
                   decay: float = 1.0) -> SchemeResult:
    """Paper Section 2 (eq. 3): synchronize by AVERAGING worker versions.

    data: (M, n, d) worker streams; eval_data: (M, n_eval, d)."""
    return _run(lambda w, deltas, w_fin: torch.mean(w_fin, dim=0),
                w0, data, eval_data, tau=tau, eps0=eps0, decay=decay)


def scheme_delta(w0: torch.Tensor, data: torch.Tensor,
                 eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
                 decay: float = 1.0) -> SchemeResult:
    """Paper Section 3 (eq. 8): merge by applying the SUM of displacements."""
    return _run(lambda w, deltas, w_fin: w - torch.sum(deltas, dim=0),
                w0, data, eval_data, tau=tau, eps0=eps0, decay=decay)


def scheme_sequential(w0: torch.Tensor, data: torch.Tensor,
                      eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
                      decay: float = 1.0) -> SchemeResult:
    """M=1 baseline with the same evaluation cadence (every tau points).

    data: (n, d) single stream (or (1, n, d))."""
    stream = data[None] if data.dim() == 2 else data
    if stream.shape[0] != 1:
        raise ValueError("the sequential baseline takes a single stream")
    return scheme_delta(w0, stream, eval_data, tau=tau, eps0=eps0,
                        decay=decay)
