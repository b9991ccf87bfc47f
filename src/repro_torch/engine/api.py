"""The ``Executor`` protocol, counterpart of ``repro/engine/api.py``.

An executor runs one of the paper's schemes over M worker streams and
returns a ``SchemeResult``.  Two backends are ported:

  * ``SimExecutor``  (``engine.sim``): the plain PyTorch oracles of
    ``core.schemes``;
  * ``MeshExecutor`` (``engine.mesh``): the workers stacked on one card,
    inner loop on the port's kernels, merges through a ``Transport``.

Scheme names are the reference's; ``async_delta`` (eq. 9) is accepted by
name and raises ``NotImplementedError`` until its slice is ported.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.schemes import SchemeResult

SCHEMES = ("average", "delta", "async_delta")
#: The schemes this slice runs.
SYNC_SCHEMES = ("average", "delta")


def validate_scheme(scheme: str) -> str:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; choose from {SCHEMES}")
    if scheme not in SYNC_SCHEMES:
        raise NotImplementedError(
            f"scheme {scheme!r} (paper eq. 9) belongs to the async slice of "
            f"the port, not ported yet (ROADMAP.md queue 1)")
    return scheme


@runtime_checkable
class Executor(Protocol):
    """Runs a parallelization scheme over M worker streams."""

    name: str

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0) -> SchemeResult:
        """data: (M, n, d) per-worker streams; eval_data: (M, n_eval, d).
        Returns the curve indexed by wall tick."""
        ...


def get_executor(name: str, **kwargs) -> Executor:
    """Factory: 'sim' | 'mesh' (+ backend kwargs)."""
    if name == "sim":
        from repro_torch.engine.sim import SimExecutor
        return SimExecutor(**kwargs)
    if name == "mesh":
        from repro_torch.engine.mesh import MeshExecutor
        return MeshExecutor(**kwargs)
    raise ValueError(f"unknown executor {name!r}; choose from ('sim', 'mesh')")
