"""Batched codebook lookup, counterpart of ``repro/serve/lookup.py``.

The reference has three plans for ``argmin_l ||z - w_l||^2`` over a query
batch: ``direct`` (one device, the assign kernel), ``shard_batch`` and
``shard_kappa`` (several devices, with collectives).  On one card the plan
is ``direct``, through ``kernels/ops.vq_assign``: the serving read path and
the training hot path share one kernel's passes (``csrc/vq_delta.cu``).
The two sharded plans need several devices and a ``torch.distributed``
backend (ROADMAP.md queue 1, item 9); asking for them raises
``NotImplementedError`` once the reference's validation has passed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops

MODES = ("auto", "direct", "shard_batch", "shard_kappa")


def device_count(device: torch.device) -> int:
    """Devices a lookup on ``device``'s type could spread over."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class ShardedLookup:
    """Batched nearest-prototype lookup.

    n_devices: devices to spread the lookup over (default: all of the
               device's type; only 1 runs so far).
    mode:      'auto' (``direct`` on one device) or one of the plans.
    device:    ``cuda`` unless the caller asks for ``"cpu"``.
    """

    def __init__(self, n_devices: int | None = None, *, mode: str = "auto",
                 device: str | torch.device | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown lookup mode {mode!r}; "
                             f"choose from {MODES}")
        self.device = device_lib.resolve(device)
        avail = device_count(self.device)
        self.n_shards = avail if n_devices is None else n_devices
        if not 1 <= self.n_shards <= avail:
            raise ValueError(
                f"need 1 <= n_devices <= {avail}, got {self.n_shards}")
        if mode in ("shard_batch", "shard_kappa") and self.n_shards < 2:
            raise ValueError(f"mode {mode!r} needs >= 2 devices, "
                             f"got {self.n_shards}")
        if self.n_shards > 1:
            raise NotImplementedError(
                f"a lookup over {self.n_shards} devices (the shard_batch and "
                f"shard_kappa plans) needs the torch.distributed backend: "
                f"ROADMAP.md queue 1, item 9")

    def plan(self, kappa: int, d: int) -> str:
        """Which execution plan a (kappa, d) codebook gets."""
        del kappa, d
        return "direct"

    def batch_multiple(self) -> int:
        """Query batches must be padded to a multiple of this row count."""
        return self.n_shards

    def assign(self, z: torch.Tensor | np.ndarray,
               w: torch.Tensor | np.ndarray
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(batch, d), (kappa, d) -> (assign (batch,) int32, mind (batch,)
        f32) on the lookup's device; the contract of
        ``kernels.ref.vq_assign_ref``."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        if z.dim() != 2 or w.dim() != 2 or z.shape[1] != w.shape[1]:
            raise ValueError(
                f"want z (batch, d) and w (kappa, d) with matching d, "
                f"got {tuple(z.shape)} vs {tuple(w.shape)}")
        return ops.vq_assign(z.contiguous(), w.contiguous())
