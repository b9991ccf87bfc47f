"""Asynchronous delta merging with random round delays, paper Section 4,
eq. (9): the tick-by-tick oracle.

Counterpart of ``repro/core/async_vq.py``, in plain PyTorch on stacked
workers (one ``(M, kappa, d)`` tensor where the reference ``vmap``s):

  * every wall tick, every worker processes one data point;
  * each worker runs communication rounds back to back; round r of worker
    i takes ``lengths[i, r]`` ticks (>= tau), a ``NetworkModel`` draw;
  * when worker i's round completes at tick t, the displacement it uploaded
    during that round lands on the shared version (4th line of eq. 9), and
    it adopts the shared version it downloaded at its previous completion
    with its displacement since then replayed on top (3rd line); the others
    keep their plain step (2nd line).

No barrier anywhere.  The shared version is scored by eq. 2 every
``eval_every`` ticks, as the loop passes those ticks.  Every per-tick
decision stays on the tensors' device: which workers complete at which
tick is one (n, M) mask made from ``lengths`` before the loop
(``done_mask``), so the loop never waits on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import vq


class AsyncResult(NamedTuple):
    w_shared: torch.Tensor    # (kappa, d) final shared version
    wall_ticks: torch.Tensor  # (n_evals,) int32
    distortion: torch.Tensor  # (n_evals,) eq. (2) of w_shared over wall time


def geometric_extra(u: torch.Tensor, p_delay: float) -> torch.Tensor:
    """Geometric(p_delay) extra ticks from uniforms u in (0, 1), int32:
    ``max(0, floor(log u / log1p(-p)))`` in f32, the reference's formula
    (``_round_lengths``).  ``log1p(-p)`` is rounded to f32 once from
    double."""
    den = torch.tensor(math.log1p(-p_delay) if p_delay < 1.0 else -math.inf,
                       dtype=torch.float32)
    geom = torch.floor(torch.log(u) / den).to(torch.int32)
    return torch.clamp(geom, min=0)


def round_lengths(generator: torch.Generator, shape: tuple[int, int], *,
                  tau: int, p_delay: float) -> torch.Tensor:
    """tau + Geometric(p_delay) extra ticks per round, a host int32 tensor;
    u is uniform on [1e-7, 1) in f32, spelled as ``jax.random.uniform``
    spells it.  The numbers are not the reference's (another generator);
    the formula is."""
    u01 = torch.rand(shape, generator=generator, dtype=torch.float32)
    lo = torch.tensor(1e-7, dtype=torch.float32)
    u = torch.maximum(lo, u01 * (1.0 - lo) + lo)
    return tau + geometric_extra(u, p_delay)


def eval_ticks(n: int, eval_every: int) -> torch.Tensor:
    """The 0-based ticks after which the shared version is scored."""
    return torch.arange(eval_every - 1, n, eval_every)


def seeded(generator: torch.Generator | None) -> torch.Generator:
    """The caller's generator, or a CPU one seeded 0 (the reference's
    entry points default to ``PRNGKey(0)``)."""
    return generator if generator is not None else (
        torch.Generator().manual_seed(0))


def done_mask(lengths: torch.Tensor, m: int, n: int, tau: int,
              device: torch.device) -> torch.Tensor:
    """(n, M) bool on ``device``: row t marks the workers whose round
    completes at 0-based tick t, the cumulative sums of their round lengths.
    Made once, after checking ``lengths`` is the (M, n // tau + 2) draw of
    rounds >= tau; a tick reads its row, a view, with no launch."""
    want = (m, n // tau + 2)
    if tuple(lengths.shape) != want:
        raise ValueError(f"lengths must be (M, n // tau + 2) = {want}, got "
                         f"{tuple(lengths.shape)}")
    if bool((lengths < tau).any()):
        raise ValueError(f"every round lasts at least tau={tau} ticks")
    done_at = torch.cumsum(lengths.to("cpu", torch.int64), dim=1)
    worker = torch.arange(m)[:, None].expand_as(done_at)
    hit = done_at < n
    mask = torch.zeros((n, m), dtype=torch.bool)
    mask[done_at[hit], worker[hit]] = True
    return mask.to(device)


def scheme_async(w0: torch.Tensor, data: torch.Tensor,
                 eval_data: torch.Tensor, *, tau: int,
                 lengths: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 p_delay: float = 0.5, eps0: float = 0.5, decay: float = 1.0,
                 eval_every: int = 10) -> AsyncResult:
    """Run eq. (9) for n wall ticks (n = data.shape[1]).

    data: (M, n, d); eval_data: (M, n_eval, d).  ``lengths``: the
    (M, n // tau + 2) per-round durations (a ``NetworkModel.round_lengths``
    draw, or the reference's through ``interop.lengths_from_reference``);
    when absent, ``generator`` (default: ``seeded``) and ``p_delay`` draw
    them with ``round_lengths``."""
    m, n, _ = data.shape
    if lengths is None:
        lengths = round_lengths(seeded(generator), (m, n // tau + 2),
                                tau=tau, p_delay=p_delay)
    dones = done_mask(lengths, m, n, tau, data.device)
    eps_all = vq.default_steps(torch.arange(1, n + 1, device=data.device),
                               eps0=eps0, decay=decay)
    kappa, d = w0.shape
    w = w0.expand(m, kappa, d).clone()
    w_shared = w0.clone()
    snapshot = w.clone()
    delta_cur = torch.zeros_like(w)
    delta_inflight = torch.zeros_like(w)
    curve = []
    for t in range(n):
        # local VQ step on every worker (1st line of eq. 9)
        step = eps_all[t] * vq.H(data[:, t], w)
        w_temp = w - step
        delta_cur = delta_cur + step
        done = dones[t]
        donef = done.to(w.dtype)[:, None, None]
        # uploaded deltas land on the shared version (4th line)
        w_shared = w_shared - torch.sum(donef * delta_inflight, dim=0)
        # completed workers adopt the snapshot plus their replayed delta
        # (3rd line); the others keep the plain step (2nd line)
        mask = done[:, None, None]
        w = torch.where(mask, snapshot - delta_cur, w_temp)
        snapshot = torch.where(mask, w_shared, snapshot)
        delta_inflight = torch.where(mask, delta_cur, delta_inflight)
        delta_cur = delta_cur.masked_fill(mask, 0.0)
        if (t + 1) % eval_every == 0:
            curve.append(vq.distortion_multi(eval_data, w_shared))
    ticks = eval_ticks(n, eval_every)
    return AsyncResult(
        w_shared=w_shared, wall_ticks=(ticks + 1).to(torch.int32),
        distortion=torch.stack(curve) if curve else torch.zeros(0))
