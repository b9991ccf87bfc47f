"""Batched codebook lookup, counterpart of ``repro/serve/lookup.py``.

Three plans for ``argmin_l ||z - w_l||^2`` over a query batch:

  * ``direct``: one device, the assign kernel (``kernels/ops.vq_assign``);
  * ``shard_batch``: the codebook fits the shared-memory budget; every
    rank of a process group takes its rows of the batch, and ``all_gather``
    gives every rank the whole ``(assign, mind)``;
  * ``shard_kappa``: it does not; every rank takes its ``ceil(kappa / P)``
    codebook rows (the last padded with ``_PAD_FILL`` rows), and
    ``min_tournament`` picks the global winner: an ``all_reduce(MIN)`` of
    the min distances, then one of the global index among the ranks tied
    at that min, so ties go to the lowest index, the reference's
    first-occurrence rule.

The reference's devices are a mesh axis under ``shard_map``; here they are
the ranks of a process group (``group=``, one worker a process,
``distributed.process_group``), each calling ``assign(z, w)`` with the same
global ``z`` and ``w``, as every device runs the reference's body.  Each
rank runs the assign kernel on its part (the plain version on the CPU), so
the serving read path and the training hot path share one kernel
(``csrc/vq_delta.cu``).  ``plan()`` routes ``auto`` by the port's
shared-memory budget (``ops.codebook_fits_smem``), which stands for the
reference's ``codebook_fits_vmem``.  ``QuantizeService`` serves over a
group: rank 0 runs the service and hands every flush to the other ranks'
``serve.service.follow`` loops, so every rank calls ``assign`` on the same
arguments.

A rank whose kernel raises still takes its part in the plan's collectives,
with the failure sentinel (assignment -1, the min distance ``-inf`` in
``shard_kappa``), and raises; a rank that finds the sentinel in the
gathered assignments raises too, so a failure on any rank fails the call
on every rank, and no rank is left waiting in a collective.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops

MODES = ("auto", "direct", "shard_batch", "shard_kappa")

# sentinel fill for codebook pad rows in the shard_kappa plan: far enough
# that a padded row can never win the argmin, small enough that ||w||^2
# stays finite in f32 for any practical d (the reference's value)
_PAD_FILL = 1.0e15


def group_size(group) -> int:
    """The ranks a lookup over ``group`` spreads over (1 without one)."""
    if group is None:
        return 1
    from repro_torch.distributed import process_group
    return process_group.group_size(group)


def min_tournament(mind: torch.Tensor, index: torch.Tensor, group
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global ``(argmin, min)`` from every rank's local candidates:
    ``mind`` (B,) f32 and its global codebook ``index`` (B,) int32.  The
    min distance over the group, then the lowest index among the ranks
    tied at it; every rank gets both."""
    from repro_torch.distributed import process_group
    gmin = process_group.all_reduce(mind.clone(), "min", group)
    cand = torch.where(mind == gmin, index,
                       torch.full_like(index, torch.iinfo(torch.int32).max))
    garg = process_group.all_reduce(cand, "min", group)
    return garg, gmin


class ShardedLookup:
    """Batched nearest-prototype lookup.

    n_devices:     ranks to spread the lookup over (default: the group's;
                   without a group, 1).
    mode:          'auto' routes per codebook by the shared-memory budget;
                   or one of the plans.
    budget_bytes:  that budget (None: ``ops.smem_budget_bytes``).
    group:         the process group whose ranks share the lookup.
    device:        ``cuda`` unless the caller asks for ``"cpu"``.
    """

    def __init__(self, n_devices: int | None = None, *, mode: str = "auto",
                 budget_bytes: int | None = None, group=None,
                 device: str | torch.device | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown lookup mode {mode!r}; "
                             f"choose from {MODES}")
        self.device = device_lib.resolve(device)
        avail = group_size(group)
        self.n_shards = avail if n_devices is None else n_devices
        if not 1 <= self.n_shards <= avail:
            raise ValueError(
                f"need 1 <= n_devices <= {avail}, got {self.n_shards}"
                + ("" if group is not None else
                   " (a lookup spreads over the ranks of a process group: "
                   "pass group=)"))
        if self.n_shards not in (1, avail):
            raise ValueError(
                f"a lookup over a process group spreads over all its "
                f"{avail} ranks or runs direct, got n_devices="
                f"{self.n_shards}")
        if mode in ("shard_batch", "shard_kappa") and self.n_shards < 2:
            raise ValueError(f"mode {mode!r} needs >= 2 devices, "
                             f"got {self.n_shards}")
        self.mode = mode
        self.budget_bytes = budget_bytes
        self.group = group

    def plan(self, kappa: int, d: int) -> str:
        """Which execution plan a (kappa, d) codebook gets."""
        if self.mode != "auto":
            return self.mode
        if self.n_shards == 1:
            return "direct"
        if ops.codebook_fits_smem(kappa, d, budget_bytes=self.budget_bytes):
            return "shard_batch"
        return "shard_kappa"

    def batch_multiple(self) -> int:
        """Query batches must be padded to a multiple of this row count
        (the micro-batcher's padding target)."""
        return self.n_shards

    def assign(self, z: torch.Tensor | np.ndarray,
               w: torch.Tensor | np.ndarray
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(batch, d), (kappa, d) -> (assign (batch,) int32, mind (batch,)
        f32) on the lookup's device; the contract of
        ``kernels.ref.vq_assign_ref``.  Batch must be a multiple of
        ``batch_multiple()`` for the sharded plans."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        if z.dim() != 2 or w.dim() != 2 or z.shape[1] != w.shape[1]:
            raise ValueError(
                f"want z (batch, d) and w (kappa, d) with matching d, "
                f"got {tuple(z.shape)} vs {tuple(w.shape)}")
        plan = self.plan(*w.shape)
        if plan == "direct":
            return ops.vq_assign(z.contiguous(), w.contiguous())
        if z.shape[0] % self.n_shards:
            raise ValueError(
                f"batch {z.shape[0]} must be a multiple of "
                f"{self.n_shards} shards for the {plan!r} plan "
                f"(pad the batch — the service's micro-batcher does)")
        if plan == "shard_batch":
            return self._shard_batch(z, w)
        return self._shard_kappa(z, w)

    def _rank(self) -> int:
        from repro_torch.distributed import process_group
        return process_group.group_rank(self.group)

    def _local(self, fn, rows: int):
        """This rank's ``fn()`` -> ``(assign, mind, None)``, or, when it
        raises, ``(the failure sentinel, the exception)``: rows of -1 and
        ``-inf`` for the plan's collectives to carry to every rank."""
        try:
            return (*fn(), None)
        except Exception as e:  # noqa: BLE001 - raised after the collectives
            return (torch.full((rows,), -1, dtype=torch.int32,
                               device=self.device),
                    torch.full((rows,), -math.inf, device=self.device), e)

    @staticmethod
    def _raise_failed(assign: torch.Tensor, err) -> None:
        """Raise this rank's exception, or one naming another rank's
        failure when the sentinel reached ``assign``."""
        if err is not None:
            raise err
        if bool((assign < 0).any()):
            raise RuntimeError("the lookup failed on another rank of its "
                               "group")

    def _shard_batch(self, z, w):
        from repro_torch.distributed import process_group
        rows = z.shape[0] // self.n_shards
        r = self._rank()
        a, m, err = self._local(lambda: ops.vq_assign(
            z[r * rows:(r + 1) * rows].contiguous(), w.contiguous()), rows)
        a = process_group.all_gather(a, self.group).reshape(-1)
        m = process_group.all_gather(m, self.group).reshape(-1)
        self._raise_failed(a, err)
        return a, m

    def _shard_kappa(self, z, w):
        kappa = w.shape[0]
        k_local = -(-kappa // self.n_shards)  # ceil
        r = self._rank()
        w_l = w[r * k_local:(r + 1) * k_local]
        pad = k_local - w_l.shape[0]
        if pad:
            # sentinel rows are strictly worse than any real prototype, so
            # they never win the local argmin on the last shard
            w_l = torch.cat([w_l, w_l.new_full((pad, w.shape[1]),
                                               _PAD_FILL)])
        a, m, err = self._local(lambda: ops.vq_assign(z.contiguous(),
                                                      w_l.contiguous()),
                                z.shape[0])
        index = a if err is not None else a + r * k_local
        garg, gmin = min_tournament(m, index, self.group)
        self._raise_failed(garg, err)
        return garg, gmin
