"""The paper's training schemes in plain PyTorch: the yardstick that decides
whether a benchmark run is correct.

It follows the paper's equations and imports nothing but ``torch``: no
kernel, no executor, no transport of the program under test.

  * eq. (1): one step of a worker, ``w_l <- w_l - eps_t (w_l - z)`` on the
    prototype ``l`` nearest to ``z`` (H is zero on every other row), with
    ``eps_t = eps0 / (1 + decay t)`` in f32, ``t`` counted from 1;
  * eq. (2): the distortion ``mean_z min_l ||z - w_l||^2`` of each worker's
    eval points, averaged over the workers;
  * eq. (8): every ``tau`` steps each worker's displacement from the shared
    codebook is summed over the workers and taken off it, and every worker
    starts the next window from the result; the curve scores every window;
  * eq. (9): every tick each worker takes one step; worker ``i``'s rounds
    last ``lengths[i, r]`` ticks and its ``r``-th round completes at the
    0-based tick ``lengths[i, 0] + ... + lengths[i, r]``; at a completion
    the displacement it uploaded in the round before lands on the shared
    codebook, and it adopts the shared codebook it downloaded then with its
    steps since replayed on top; the curve scores every ``eval_every``
    ticks.

A step's winner is the argmin of ``sum_j (w_lj - z_j)^2``, the squared
distance summed from the differences (no cancellation), ties to the lowest
index.  The eval's distances are ``||z||^2 - 2 z.w + ||w||^2``, the one
spelling a (points x prototypes) product affords.  ``precision="tf32"`` is
the control: every squared distance takes the expansion, and the products
``z.w`` take their operands rounded to TF32 (10 mantissa bits, to nearest
even) and accumulate in f32, as a card's tensor cores do with TF32 on.
``precision="tf32_steps"`` does so in the steps alone, the eval in f32, so
that what a step in TF32 does to the trajectory is read apart from the
eval.  ``precision="f32_expansion"`` is a witness: a step's winner from
the f32 expansion, which cancels ``||z||^2`` against ``2 z.w`` and so
picks another winner at some near ties.

Every scheme's function takes the same arguments, ``(w0, data, eval_data,
*, lengths, tau, eps0, decay, eval_every, precision)``, and returns the
final shared codebook and the eval curve; a traffic mix names its function
(``"vq_plain.run_sync"``) and the benchmark calls it by that name.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "tf32_steps", "f32_expansion")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even (the
    values here are finite)."""
    bits = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    rounded = torch.bitwise_and(bits + 0x0FFF + lsb, -0x2000)
    return rounded.view(torch.float32)


def _cross(z: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """z (..., B, d) times w (..., K, d) transposed: (..., B, K)."""
    if precision == "tf32":
        z, w = round_tf32(z), round_tf32(w)
    return z @ w.transpose(-1, -2)


def sq_distances(z: torch.Tensor, w: torch.Tensor, *,
                 precision: str = "f32") -> torch.Tensor:
    """(..., B, K) squared distances of z (..., B, d) to w (..., K, d)."""
    z2 = torch.sum(z * z, dim=-1, keepdim=True)
    w2 = torch.sum(w * w, dim=-1).unsqueeze(-2)
    return z2 - 2.0 * _cross(z, w, precision) + w2


def distortion(eval_data: torch.Tensor, w: torch.Tensor, *,
               precision: str = "f32") -> torch.Tensor:
    """Eq. (2): each worker's mean min distance of eval_data (M, n, d) to the
    shared w (K, d), averaged over the M workers; a 0-d tensor of the
    inputs' type ("tf32" rounds the products' operands)."""
    per_worker = torch.mean(
        torch.min(sq_distances(eval_data, w, precision=precision),
                  dim=-1).values, dim=-1)
    return torch.mean(per_worker)


def step_sizes(n: int, *, eps0: float, decay: float,
               device: torch.device) -> torch.Tensor:
    """(n,) f32: eps_t = eps0 / (1 + decay t) for t = 1 .. n."""
    den = 1.0 + decay * torch.arange(1, n + 1, device=device,
                                     dtype=torch.float32)
    return torch.full_like(den, eps0) / den


def _winners(w: torch.Tensor, z: torch.Tensor, precision: str
             ) -> torch.Tensor:
    """Each worker's nearest prototype: w (M, K, d), z (M, d) -> (M,)."""
    if precision == "f32":
        diff = w - z.unsqueeze(1)
        return torch.argmin(torch.sum(diff * diff, dim=-1), dim=-1)
    products = "tf32" if precision.startswith("tf32") else "f32"
    dist = sq_distances(z.unsqueeze(1), w, precision=products)[:, 0]
    return torch.argmin(dist, dim=-1)


def _eval_precision(precision: str) -> str:
    return "tf32" if precision == "tf32" else "f32"


def _check(precision: str, w0, data, eval_data) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if data.dim() != 3 or eval_data.dim() != 3 or w0.dim() != 2:
        raise ValueError("need w0 (K, d), data (M, n, d), eval_data "
                         "(M, n_eval, d)")
    for x in (w0, data, eval_data):
        if x.dtype != torch.float32:
            raise ValueError(f"inputs are f32, got {x.dtype}")


def run_sync(w0: torch.Tensor, data: torch.Tensor, eval_data: torch.Tensor,
             *, tau: int, eps0: float, decay: float = 1.0,
             lengths: torch.Tensor | None = None, eval_every: int = 1,
             precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (8) over data (M, n, d) from the shared w0 (K, d): returns the
    final shared codebook (K, d) and the curve (n // tau,), scored after
    every window (no round lengths, ``eval_every`` 1)."""
    _check(precision, w0, data, eval_data)
    if lengths is not None or eval_every != 1:
        raise ValueError("eq. 8 scores every window and draws no round "
                         "lengths")
    ev = _eval_precision(precision)
    m, n, _ = data.shape
    n_windows = n // tau
    eps = step_sizes(n_windows * tau, eps0=eps0, decay=decay,
                     device=data.device)
    workers = torch.arange(m, device=data.device)
    shared = w0.clone()
    curve = []
    for i in range(n_windows):
        w = shared.expand(m, *shared.shape).clone()
        for s in range(tau):
            t = i * tau + s
            z = data[:, t]
            win = _winners(w, z, precision)
            rows = w[workers, win]
            w[workers, win] = rows - eps[t] * (rows - z)
        shared = shared - torch.sum(shared - w, dim=0)
        curve.append(distortion(eval_data, shared, precision=ev))
    return shared, torch.stack(curve)


def completion_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """(n, M) bool on the host: row t marks the workers whose round completes
    at the 0-based tick t."""
    ends = torch.cumsum(lengths.to("cpu", torch.int64), dim=1)
    mask = torch.zeros((n, lengths.shape[0]), dtype=torch.bool)
    for i in range(lengths.shape[0]):
        hit = ends[i][ends[i] < n]
        mask[hit, i] = True
    return mask


def run_async(w0: torch.Tensor, data: torch.Tensor, eval_data: torch.Tensor,
              *, lengths: torch.Tensor, tau: int, eps0: float,
              decay: float = 1.0, eval_every: int = 10,
              precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (9) for n = data.shape[1] ticks with the round lengths
    (M, rounds): returns the final shared codebook (K, d) and the curve
    (n // eval_every,)."""
    _check(precision, w0, data, eval_data)
    ev = _eval_precision(precision)
    m, n, _ = data.shape
    if bool((lengths < tau).any()):
        raise ValueError(f"every round lasts at least tau={tau} ticks")
    done = completion_mask(lengths, n)
    landing = done.to(device=data.device, dtype=torch.float32)
    eps = step_sizes(n, eps0=eps0, decay=decay, device=data.device)
    workers = torch.arange(m, device=data.device)
    w = w0.expand(m, *w0.shape).clone()
    shared = w0.clone()
    snapshot = w.clone()
    since = torch.zeros_like(w)      # each worker's steps in this round
    uploaded = torch.zeros_like(w)   # the displacement of its last round
    curve = []
    for t in range(n):
        z = data[:, t]
        win = _winners(w, z, precision)
        step = eps[t] * (w[workers, win] - z)
        w[workers, win] = w[workers, win] - step
        since[workers, win] = since[workers, win] + step
        finished = torch.nonzero(done[t]).flatten().tolist()
        if finished:
            # sum_i done_i * uploaded_i over all M workers
            shared = shared - torch.sum(
                landing[t].view(m, 1, 1) * uploaded, dim=0)
            for i in finished:
                w[i] = snapshot[i] - since[i]
                snapshot[i] = shared
                uploaded[i] = since[i]
                since[i] = 0.0
        if (t + 1) % eval_every == 0:
            curve.append(distortion(eval_data, shared, precision=ev))
    return shared, (torch.stack(curve) if curve
                    else torch.zeros(0, device=data.device))
