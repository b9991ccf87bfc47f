"""Public wrappers over the port's kernels, and the residency predicates
that route between them.  Counterpart of ``repro/kernels/ops.py``.

The reference plans residency against a TPU core's VMEM
(``DEFAULT_VMEM_BUDGET_BYTES = 8 MiB``) and aligns batch blocks to 8 rows
for the TPU's sublanes (``_bm_floor``).  Neither applies on Hopper.  Here a
kernel "fits" when each of its blocks fits the shared memory one block may
use, by default an H100's 227 KB (232,448 bytes), counting what the port's
own kernels hold there (``delta_smem_bytes``, ``vq_fused.smem_bytes``).
The window kernel's block holds what ``vq_fused._window_plan`` lays out
under the budget: its rows of the codebook where the cluster holds the
codebook on chip (232,436 B at kappa=4096, d=128), else their norms as the
rows stream from global memory (3,216 B there under a smaller budget,
26,768 B at d=3072).  The full-codebook delta kernel's
largest block holds a (32, d) tile, which fits up to d = 1,807.  The port
does not pad batches, so no row floor exists.

``vq_delta_routed`` routes as the reference's does (``delta_route``): the
full-codebook delta kernel where it fits the budget; past it the blocked
assign+delta kernel (``vq_delta_blocked``), whose shared memory does not
grow with d, or with ``fused=False`` the assign kernel and an
``index_add_`` (``_delta_via_assign``, the comparator).  ``vq_delta_topk``
takes the blocked kernel's epilogue past the budget.  The budget is the
caller's ``budget_bytes``, else ``REPRO_SMEM_BUDGET_BYTES``, else the
H100's (``smem_budget_bytes``); a smaller one forces the blocked routes at
any width.  A CUDA tensor launches the routed kernel or raises.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels import vq_assign as assign_kernels
from repro_torch.kernels import vq_fused

#: Shared memory one block may use on an H100 (dynamic, after opting in).
DEFAULT_SMEM_BUDGET_BYTES = assign_kernels.SMEM_MAX


def smem_budget_bytes(budget_bytes: int | None = None) -> int:
    """The shared-memory budget that routes between kernels: the explicit
    value, else ``REPRO_SMEM_BUDGET_BYTES``, else 232,448."""
    if budget_bytes is None:
        env = os.environ.get("REPRO_SMEM_BUDGET_BYTES", "")
        budget_bytes = int(env) if env else DEFAULT_SMEM_BUDGET_BYTES
    if budget_bytes <= 0:
        raise ValueError(f"smem budget must be > 0, got {budget_bytes}")
    return budget_bytes


def delta_smem_bytes(kappa: int, d: int, *, bk: int | None = None) -> int:
    """Shared memory of the largest block of one delta launch: the ONE
    model the router and the tuner share.

    ``bk=None``: the full-codebook delta kernel (``vq_assign.smem_bytes``),
    whose (32, d) accumulate tile grows with d.  ``bk`` given: the blocked
    kernel at accumulate tile ``bk`` (``vq_fused.blocked_smem_bytes``)."""
    if bk is None:
        return assign_kernels.smem_bytes(d)
    return vq_fused.blocked_smem_bytes(kappa, d, bk)


def codebook_fits_smem(kappa: int, d: int, *,
                       budget_bytes: int | None = None) -> bool:
    """Does a replicated (kappa, d) f32 codebook fit the shared-memory
    budget?  The counterpart of the reference's ``codebook_fits_vmem``: the
    lookup shards kappa over a process group when it does not."""
    return 4 * kappa * d <= smem_budget_bytes(budget_bytes)


def window_fits(kappa: int, d: int, *, budget_bytes: int | None = None
                ) -> bool:
    """Can the window kernel run a (kappa, d) codebook within the budget,
    by either of its routes?"""
    budget = smem_budget_bytes(budget_bytes)
    return vq_fused.smem_bytes(kappa, d, budget) <= budget


def delta_fits(d: int, *, budget_bytes: int | None = None) -> bool:
    """Can the full-codebook delta kernel run at width d?"""
    return delta_smem_bytes(0, d) <= smem_budget_bytes(budget_bytes)


def delta_route(d: int, *, budget_bytes: int | None = None,
                fused: bool = True) -> str:
    """The route ``vq_delta_routed`` takes at width d: ``"full"`` (the delta
    kernel), ``"blocked"`` (the blocked kernel) or ``"via_assign"`` (the
    assign kernel and an ``index_add_``)."""
    if delta_fits(d, budget_bytes=budget_bytes):
        return "full"
    return "blocked" if fused else "via_assign"


def vq_assign(z: torch.Tensor, w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-prototype ``(assign int32, mind f32)``; the contract of
    ``ref.vq_assign_ref``, with optional leading worker dimension.  The
    serving read path (``serve.lookup``) goes through it."""
    return assign_kernels.vq_assign(z, w)


def vq_delta(z: torch.Tensor, w: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minibatch displacement statistics ``(counts, zsum)``; the contract of
    ``ref.vq_delta_ref``, with optional leading worker dimension."""
    counts, zsum, _, _ = assign_kernels.vq_delta(z, w)
    return counts, zsum


def distortion(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean min distance (paper eq. 2 per worker) through the assign
    kernel: z (..., B, d), w (..., kappa, d) -> (...)."""
    _, mind = assign_kernels.vq_assign(z, w)
    return torch.mean(mind, dim=-1)


def vq_delta_blocked(z: torch.Tensor, w: torch.Tensor, *,
                     residual: torch.Tensor | None = None,
                     kchunk: int | None = None, bk: int | None = None):
    """The blocked kernel at any width: ``(counts, zsum)``, and with
    ``residual`` also the displacement epilogue
    ``counts.unsqueeze(-1) * w - zsum + residual``.  Tiles come from
    ``kernels.autotune`` unless given."""
    out = vq_fused.vq_delta_blocked(z, w, residual=residual, kchunk=kchunk,
                                    bk=bk)
    return out[:2] if residual is None else (out[0], out[1], out[4])


def _delta_via_assign(z: torch.Tensor, w: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts, zsum) through the assign kernel and an ``index_add_``: the
    reference's pre-fusion blocked route, kept as the ``fused=False``
    comparator.  The assignments round-trip through device memory; on the
    card ``index_add_`` adds with atomics, so at a batch past one the sums
    may differ from the blocked kernel's in the last bits."""
    assign, _ = assign_kernels.vq_assign(z, w)
    kappa, d = w.shape[-2:]
    m = z.shape[0] if z.dim() == 3 else 1
    rows = (assign.reshape(m, -1).long()
            + kappa * torch.arange(m, device=z.device)[:, None]).reshape(-1)
    counts = torch.zeros(m * kappa, dtype=torch.float32, device=z.device)
    counts.index_add_(0, rows, torch.ones(rows.shape, device=z.device))
    zsum = torch.zeros((m * kappa, d), dtype=torch.float32, device=z.device)
    zsum.index_add_(0, rows, z.reshape(-1, d))
    return counts.view(w.shape[:-1]), zsum.view(w.shape)


def vq_delta_routed(z: torch.Tensor, w: torch.Tensor, *,
                    budget_bytes: int | None = None, fused: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``vq_delta`` routed by shared memory (``delta_route``): the
    full-codebook kernel where it fits the budget, else the blocked kernel,
    else with ``fused=False`` the assign kernel and an ``index_add_``."""
    route = delta_route(w.shape[-1], budget_bytes=budget_bytes, fused=fused)
    if route == "full":
        return vq_delta(z, w)
    if route == "blocked":
        return vq_delta_blocked(z, w)
    return _delta_via_assign(z, w)


def vq_minibatch_step(z: torch.Tensor, w: torch.Tensor, eps: torch.Tensor,
                      *, budget_bytes: int | None = None) -> torch.Tensor:
    """One minibatch VQ update ``w - (eps / |B|) * (counts * w - zsum)``
    over z (..., B, d), routed through ``vq_delta_routed``, so wide
    codebooks take the blocked kernel."""
    counts, zsum = vq_delta_routed(z, w, budget_bytes=budget_bytes)
    delta = counts.unsqueeze(-1) * w - zsum
    return w - (eps / z.shape[-2]) * delta


def vq_topk(full: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse transport's selection: for each row of full (M, N), the k
    largest-|x| entries ``(vals (M, k), idx (M, k) int32)`` in ascending
    index order and the error-feedback residual ``full - kept`` (M, N)."""
    return vq_fused.vq_topk(full, k)


def vq_delta_topk(z: torch.Tensor, w: torch.Tensor, residual: torch.Tensor,
                  *, frac: float, budget_bytes: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eq.-8 displacement with the error-feedback carry folded in,
    ``counts * w - zsum + residual``, compressed to the sparse transport's
    payload with ``k = max(1, int(frac * kappa * d))`` (the convention of
    ``comm.sparse.topk_count``).

    z (B, d), w and residual (kappa, d) -> (vals (k,), idx (k,) int32,
    new residual (kappa, d)); with a leading worker dimension M on all
    three, each output gains it.  Where the delta kernel fits the budget
    the payload is formed eagerly from its (counts, zsum); past it, by the
    blocked kernel's epilogue, with the same rounding."""
    if residual.shape != w.shape:
        raise ValueError(f"residual must be shaped like w {tuple(w.shape)}, "
                         f"got {tuple(residual.shape)}")
    if delta_fits(w.shape[-1], budget_bytes=budget_bytes):
        counts, zsum = vq_delta(z, w)
        full = counts.unsqueeze(-1) * w - zsum + residual
    else:
        _, _, full = vq_delta_blocked(z, w, residual=residual)
    flat = full.reshape(-1, w.shape[-2] * w.shape[-1])
    vals, idx, new_res = vq_topk(flat, max(1, int(frac * flat.shape[1])))
    if w.dim() == 2:
        return vals[0], idx[0], new_res.view(w.shape)
    return vals, idx, new_res.view(w.shape)


def vq_divergence(w_local: torch.Tensor, w_shared: torch.Tensor
                  ) -> torch.Tensor:
    """Each worker's ``||w_local[m] - w_shared||^2``, (M,) f32, in one
    pass: an observed sync window's codebook divergence."""
    return vq_fused.vq_divergence(w_local, w_shared)


def vq_window(zwin: torch.Tensor, w0: torch.Tensor, eps: torch.Tensor, *,
              budget_bytes: int | None = None) -> torch.Tensor:
    """One window for every worker in a single launch, its blocks held to
    the budget; callers check ``window_fits`` at the same budget first."""
    return vq_fused.vq_window(zwin, w0, eps, smem_budget_bytes(budget_bytes))


def window_routed(zwin: torch.Tensor, w0: torch.Tensor, eps: torch.Tensor,
                  *, budget_bytes: int | None = None, fused: bool = True
                  ) -> torch.Tensor:
    """tau sequential eq.-1 steps for every worker from the shared w0
    (kappa, d) over zwin (M, tau, d) -> (M, kappa, d): the window kernel
    where ``fused`` and it fits the budget, else the per-step loop through
    ``vq_delta_routed`` (the delta kernel, past its shared memory the
    blocked kernel, with ``fused`` off there the assign kernel and an
    ``index_add_``), the eq.-1 update in PyTorch.  Both give the same
    codebooks bit for bit."""
    m, tau, d = zwin.shape
    kappa = w0.shape[0]
    if fused and window_fits(kappa, d, budget_bytes=budget_bytes):
        return vq_window(zwin, w0, eps, budget_bytes=budget_bytes)
    w = w0.expand(m, kappa, d).contiguous()
    for s in range(tau):
        # a batch of one point per worker, so counts/zsum reduce exactly to
        # H(z, w)
        counts, zsum = vq_delta_routed(
            zwin[:, s].unsqueeze(1).contiguous(), w,
            budget_bytes=budget_bytes, fused=fused)
        w = w - eps[s] * (counts.unsqueeze(-1) * w - zsum)
    return w
