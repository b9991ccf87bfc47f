"""The benchmark's fixed arithmetic: the H100's peaks, the operations and
bytes of each kernel call and of a whole job, counted from the shapes.

Nothing here reads the program: a change to the program cannot move it.
Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity).  The program runs every product of the training path in f32
outside the tensor cores (TF32 pinned off), so its compute peak is the
f32 rate.

A kernel's bound counts each input byte read once and each output byte
written once, whatever the kernel reads again, and the least time is the
larger of bytes over the HBM rate and operations over the f32 rate.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12        # FLOP/s, f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12     # B/s, HBM3
F32 = 4                       # bytes


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time of a call: bytes at the HBM rate or operations at the
    f32 rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def distance_flops(points: int, kappa: int, d: int) -> int:
    """Squared distances of ``points`` points to ``kappa`` prototypes by
    ``||z||^2 - 2 z.w + ||w||^2`` and their argmin: 2d operations a pair
    for the product and the norms' share, three to combine and compare."""
    return points * kappa * (2 * d + 3)


def window_bytes(m: int, tau: int, kappa: int, d: int) -> int:
    """The window kernel (``csrc/vq_window.cu``): reads the window's points
    (m, tau, d), the shared codebook (kappa, d) and tau step sizes; writes
    every worker's codebook (m, kappa, d)."""
    return F32 * (m * tau * d + kappa * d + tau + m * kappa * d)


def window_flops(m: int, tau: int, kappa: int, d: int) -> int:
    """tau sequential eq.-1 steps for each of m workers."""
    return tau * distance_flops(m, kappa, d)


def window_bound_s(m: int, tau: int, kappa: int, d: int) -> float:
    return bound_s(window_bytes(m, tau, kappa, d),
                   window_flops(m, tau, kappa, d))


def delta_bytes(m: int, b: int, kappa: int, d: int) -> int:
    """The per-step statistics of ``b`` points a worker (the delta kernel,
    ``csrc/vq_delta.cu``, and the blocked kernel, ``csrc/vq_blocked.cu``):
    reads the points (m, b, d) and the codebooks (m, kappa, d); writes the
    counts (m, kappa), the sums (m, kappa, d) and each point's min distance
    and winner (m, b) twice over."""
    n_in = m * b * d + m * kappa * d
    n_out = m * kappa + m * kappa * d + 2 * m * b
    return F32 * (n_in + n_out)


def delta_flops(m: int, b: int, kappa: int, d: int) -> int:
    """The distances and argmins, and each point added to its winner's
    sum."""
    return distance_flops(m * b, kappa, d) + m * b * d


def delta_bound_s(m: int, b: int, kappa: int, d: int) -> float:
    return bound_s(delta_bytes(m, b, kappa, d), delta_flops(m, b, kappa, d))


def eval_flops(m: int, n_eval: int, kappa: int, d: int) -> int:
    """Eq. 2 of the shared codebook on m workers' n_eval points each."""
    return distance_flops(m * n_eval, kappa, d)


def sync_window_flops(m: int, tau: int, kappa: int, d: int,
                      n_eval: int) -> int:
    """One eq.-8 window: the workers' tau steps (distances, argmins and the
    winner's update, 3d a step), the merge (each worker's displacement, its
    sum over the workers, the shared codebook's update) and the eval."""
    steps = window_flops(m, tau, kappa, d) + tau * m * 3 * d
    merge = (2 * m + 1) * kappa * d
    return steps + merge + eval_flops(m, n_eval, kappa, d)


def async_tick_flops(m: int, kappa: int, d: int) -> int:
    """One eq.-9 tick without its eval: each worker's step (distances,
    argmin, the winner's update and its running displacement, 4d) and the
    masked sum of the workers' in-flight displacements."""
    return distance_flops(m, kappa, d) + m * 4 * d + m * kappa * d


def job_flops(step: str, *, m: int, kappa: int, d: int, tau: int,
              points: int, n_eval: int, eval_every: int) -> int:
    """The operations of one job of ``points`` points a worker, whose step
    is a ``"window"`` (eq. 8: tau steps a worker, the merge, an eval every
    ``eval_every`` windows) or a ``"tick"`` (eq. 9: one step a worker, the
    masked merge, an eval every ``eval_every`` ticks)."""
    if step == "tick":
        return (points * async_tick_flops(m, kappa, d)
                + (points // eval_every) * eval_flops(m, n_eval, kappa, d))
    windows = points // tau
    return (windows * (sync_window_flops(m, tau, kappa, d, n_eval)
                       - eval_flops(m, n_eval, kappa, d))
            + (windows // eval_every) * eval_flops(m, n_eval, kappa, d))
