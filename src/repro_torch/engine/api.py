"""The ``Executor`` protocol, counterpart of ``repro/engine/api.py``.

An executor runs one of the paper's schemes over M worker streams and
returns a ``SchemeResult``.  Four backends are ported:

  * ``SimExecutor``  (``engine.sim``): the plain PyTorch oracles of
    ``core.schemes``;
  * ``MeshExecutor`` (``engine.mesh``): the workers stacked on one card,
    inner loop on the port's kernels, merges through a ``Transport``;
  * ``ElasticMeshExecutor`` (``engine.elastic``): ``MeshExecutor`` with a
    ``ResizeSchedule``, the worker count changing between windows;
  * ``ThreadExecutor`` (``engine.threads``): the real-thread runtime of
    ``core.async_runtime`` (``async_delta`` only; its curve is indexed by
    wall seconds).

Scheme names are the reference's: ``average`` (eq. 3), ``delta`` (eq. 8)
and ``async_delta`` (eq. 9).  ``run`` also takes the async scheme's round
lengths, drawn from ``generator`` under the executor's network unless the
caller passes ``lengths``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.core import async_vq
from repro_torch.core.schemes import SchemeResult

SCHEMES = ("average", "delta", "async_delta")


def validate_scheme(scheme: str) -> str:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; choose from {SCHEMES}")
    return scheme


def async_lengths(network, m: int, n: int, tau: int, *,
                  generator: torch.Generator | None = None,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The async scheme's (M, n // tau + 2) round lengths: the caller's, or
    a draw from ``network`` with ``generator`` (default:
    ``async_vq.seeded``)."""
    if lengths is not None:
        return lengths
    return network.round_lengths(async_vq.seeded(generator), m,
                                 n // tau + 2, tau)


@runtime_checkable
class Executor(Protocol):
    """Runs a parallelization scheme over M worker streams."""

    name: str

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        """data: (M, n, d) per-worker streams; eval_data: (M, n_eval, d).
        Returns the curve indexed by wall tick (``ThreadExecutor`` indexes
        it by wall seconds: real threads have no tick clock).  ``generator`` and
        ``lengths`` concern ``async_delta`` only."""
        ...


def get_executor(name: str, **kwargs) -> Executor:
    """Factory: 'sim' | 'mesh' | 'thread' | 'elastic' (+ backend kwargs;
    ``transport=`` a name or a ``comm.Transport`` reaches the mesh and
    elastic executors' merges, the sim oracles and the threads have no
    collective to route).

    'elastic' needs ``schedule=``: a ``ResizeSchedule``, a list of
    ``(window, new_m)`` pairs, or a ``"WINDOW:M,..."`` string."""
    if name == "sim":
        from repro_torch.engine.sim import SimExecutor
        return SimExecutor(**kwargs)
    if name == "mesh":
        from repro_torch.engine.mesh import MeshExecutor
        return MeshExecutor(**kwargs)
    if name == "thread":
        from repro_torch.engine.threads import ThreadExecutor
        return ThreadExecutor(**kwargs)
    if name == "elastic":
        from repro_torch.engine.elastic import (ElasticMeshExecutor,
                                                ResizeSchedule)
        schedule = kwargs.pop("schedule", None)
        if schedule is None:
            raise ValueError(
                "the elastic executor needs a schedule= kwarg "
                "(ResizeSchedule, [(window, new_m), ...], or 'WINDOW:M,...')")
        if isinstance(schedule, str):
            schedule = ResizeSchedule.parse(schedule)
        return ElasticMeshExecutor(schedule, **kwargs)
    raise ValueError(
        f"unknown executor {name!r}; choose from "
        f"('sim', 'mesh', 'thread', 'elastic')")
