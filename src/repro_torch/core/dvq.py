"""Distributed VQ over process groups, counterpart of ``repro/core/dvq.py``.

The reference runs the paper's workload as SPMD programs on its production
mesh: the dataset split over the data-parallel axes, every shard one of the
paper's workers, and the reducing phase a psum over those axes (eq. 8),
with a kappa-sharded codebook for large (kappa, d).  Here the axes are
process groups (``Topology.make_groups``, one worker a process) and the
collectives are written out:

  * ``make_window_vq_step(tau=)``: one tau-point window per worker, then
    ``w <- w - sum_i delta_i``.  Stacked (no group), the window kernel runs
    every worker of ``(M, tau, d)`` in one launch and the sum is over the
    worker dimension (the reference's ``vmap`` and sum); with a group, each
    rank runs its ``(1, tau, d)`` window and the sum runs over the group.
    The sum goes through a dense transport (``"xla"`` or ``"ring"``), whose
    ``CommRecord``s the dry run reports.
  * ``make_minibatch_vq_step()``: each data rank's ``(counts, zsum)`` over
    its shard of the batch through the delta kernel, summed over the data
    group (eq. 8 with tau = one batch).  With a model group that divides
    kappa, each rank holds ``kappa / tp`` rows of the codebook, assigns
    against them with the assign kernel, and ``serve.lookup.min_tournament``
    picks the global winner; each rank then sums the points its rows won.
  * ``vq_layout``: which dimensions a group layout splits (the reference's
    ``vq_shardings``).
  * ``run_minibatch_vq``: the minibatch step over a ``(steps, batch, d)``
    stream on one device, scored on a fixed eval prefix of at most 4,096
    points.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import comm
from repro_torch.core import vq
from repro_torch.distributed import process_group
from repro_torch.kernels import ops, ref, vq_assign, vq_fused

#: Eval points of ``run_minibatch_vq``'s fixed prefix (the reference's cap).
EVAL_POINTS = 4096


def _sizes(layout) -> dict[str, int]:
    """Axis sizes of a ``topology.Groups`` or a mapping of them."""
    if isinstance(layout, dict):
        return dict(layout)
    return dict(zip(layout.axes, layout.shape))


def vq_layout(layout, *, kappa: int, d: int, batch: int) -> dict:
    """Which dimensions are split, by axis name: ``{"w": (rows, cols),
    "z": (rows, cols)}``, each entry an axis, a tuple of axes or None.  The
    codebook's rows over ``model`` where it divides kappa; the batch over
    the data-parallel axes (``pod``, ``data``) where it divides the batch."""
    del d
    sizes = _sizes(layout)
    tp = sizes.get("model", 1)
    w_rows = "model" if tp > 1 and kappa % tp == 0 else None
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    z_rows = dp if dp and batch % dp_total == 0 else None
    return {"w": (w_rows, None), "z": (z_rows, None)}


def _transport(name: str, group):
    if name not in ("xla", "ring"):
        raise ValueError(f"transport must be 'xla' or 'ring', got {name!r}")
    cls = comm.RingTransport if name == "ring" else comm.XlaTransport
    return cls(group=group)


def make_window_vq_step(*, tau: int, eps0: float = 0.5, decay: float = 1.0,
                        group=None, transport: str = "xla",
                        use_kernel: bool = True) -> Callable:
    """(w, t, z_window) -> (w', t + tau), the paper's S2 window (eq. 8).

    z_window: (M, tau, d) stacked, or this rank's (1, tau, d) with
    ``group``.  ``step.transport`` holds the reduce's ``CommRecord``s."""
    tr = _transport(transport, group)

    def step(w: torch.Tensor, t: int, z_window: torch.Tensor):
        if z_window.dim() != 3 or z_window.shape[1] != tau:
            raise ValueError(f"z_window must be (M, tau={tau}, d), got "
                             f"{tuple(z_window.shape)}")
        w32 = w.to(torch.float32)
        eps = vq.default_steps(
            torch.arange(t + 1, t + tau + 1, device=w.device),
            eps0=eps0, decay=decay)
        if use_kernel:
            w_fin = ops.window_routed(z_window.contiguous(), w32, eps)
        else:
            w_fin = w32.expand(z_window.shape[0], *w.shape).contiguous()
            for s in range(tau):
                w_fin = w_fin - eps[s] * vq.H(z_window[:, s], w_fin)
        total, _ = tr.all_reduce(w32 - w_fin, op="sum")
        return (w32 - total).to(w.dtype), t + tau

    step.transport = tr
    return step


def make_minibatch_vq_step(*, eps0: float = 0.5, decay: float = 1.0,
                           use_kernel: bool = True, data_group=None,
                           model_group=None,
                           transport: str = "xla") -> Callable:
    """(w, t, z) -> (w', t + 1): ``w - (eps / B) (counts * w - zsum)`` over
    the global batch of B points.

    z: this data rank's rows (the whole batch without ``data_group``), of
    one size on every rank.  w: this model rank's ``kappa / tp`` codebook
    rows with ``model_group`` (tp its size), else the whole codebook.
    ``step.stats(w, z)`` gives ``(counts, zsum, assign)``: the sums over
    the data group for this rank's rows, and this rank's points' global
    codebook indices.  ``step.transport`` holds the data sum's records."""
    tr = _transport(transport, data_group)

    def stats(w: torch.Tensor, z: torch.Tensor):
        w32 = w.to(torch.float32)
        z32 = z.to(torch.float32).contiguous()
        if model_group is None:
            if use_kernel:
                counts, zsum, _, assign = _delta(z32, w32)
            else:
                assign, _ = ref.vq_assign_ref(z32, w32)
                counts, zsum = ref.vq_delta_ref(z32, w32)
        else:
            assign, counts, zsum = _sharded_stats(z32, w32, model_group,
                                                  use_kernel)
        if data_group is not None:
            (counts, zsum), _ = tr.all_reduce((counts[None], zsum[None]),
                                              op="sum")
        return counts, zsum, assign

    def step(w: torch.Tensor, t: int, z: torch.Tensor):
        counts, zsum, _ = stats(w, z)
        batch = z.shape[0] * (1 if data_group is None
                              else process_group.group_size(data_group))
        eps = vq.default_steps(torch.tensor(t + 1, device=w.device),
                               eps0=eps0, decay=decay)
        w32 = w.to(torch.float32)
        delta = counts[:, None] * w32 - zsum
        return (w32 - (eps / batch) * delta).to(w.dtype), t + 1

    step.stats = stats
    step.transport = tr
    return step


def _delta(z: torch.Tensor, w: torch.Tensor):
    """(counts, zsum, mind, assign) through the delta kernel (the blocked
    kernel past its shared memory)."""
    if ops.delta_route(w.shape[-1]) == "full":
        return vq_assign.vq_delta(z, w)
    return vq_fused.vq_delta_blocked(z, w)[:4]


def _sharded_stats(z: torch.Tensor, w_local: torch.Tensor, model_group,
                   use_kernel: bool):
    """The kappa-sharded codebook: the local argmin over this rank's rows,
    the tournament over the model group for the global winner, then the
    counts and sums of the points this rank's rows won."""
    from repro_torch.serve.lookup import min_tournament
    k_local = w_local.shape[0]
    r = process_group.group_rank(model_group)
    if use_kernel:
        a_l, m_l = ops.vq_assign(z, w_local)
    else:
        a_l, m_l = ref.vq_assign_ref(z, w_local)
    assign, _ = min_tournament(m_l, a_l + r * k_local, model_group)
    local = assign.long() - r * k_local
    mine = (local >= 0) & (local < k_local)
    rows = local[mine]
    counts = torch.zeros(k_local, dtype=torch.float32, device=z.device)
    counts.index_add_(0, rows, torch.ones(rows.shape, device=z.device))
    zsum = torch.zeros_like(w_local)
    zsum.index_add_(0, rows, z[mine])
    return assign, counts, zsum


def run_minibatch_vq(w0: torch.Tensor, data: torch.Tensor, *, steps: int,
                     eps0: float = 0.5, decay: float = 1.0,
                     use_kernel: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The minibatch step over a (steps, batch, d) stream on one device:
    ``(w_final, distortion trace)``, the trace scored on a fixed eval set,
    the stream's first ``EVAL_POINTS`` points, so entries compare across
    steps."""
    if data.dim() != 3 or data.shape[0] != steps:
        raise ValueError(f"data must be (steps={steps}, batch, d), got "
                         f"{tuple(data.shape)}")
    step = make_minibatch_vq_step(eps0=eps0, decay=decay,
                                  use_kernel=use_kernel)
    flat = data.reshape(-1, data.shape[-1])
    eval_set = flat[: min(EVAL_POINTS, flat.shape[0])]
    w, t, trace = w0, 0, []
    for z in data:
        w, t = step(w, t, z)
        trace.append(vq.distortion(eval_set, w))
    return w, torch.stack(trace)
