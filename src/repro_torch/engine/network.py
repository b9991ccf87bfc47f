"""Communication-cost models, counterpart of ``repro/engine/network.py``.

A ``NetworkModel`` answers what the executors ask of the network:

  * ``round_lengths(generator, m, max_rounds, tau)``, for the async scheme
    (eq. 9) and the load generator's arrivals: the wall ticks each of a
    worker's back-to-back upload/download rounds takes, always >= tau;
  * ``window_ticks(tau)``, for the sync schemes: what a barriered window
    costs (compute plus the blocking merge round-trip), and
    ``transfer_ticks(wire_bytes)``, the extra ticks to move a window's
    measured merge bytes.

``late_matrix`` (the quorum merge's straggler bits) comes with the quorum
merge.

  * ``InstantNetwork``: communication is free, a window costs tau ticks
    (the simulated architecture of paper Sections 2-3);
  * ``FixedLatencyNetwork``: every round pays a constant latency, and
    optionally ceil(bytes / bandwidth) ticks;
  * ``GeometricDelayNetwork``: extra ticks ~ Geometric(p_delay), the paper's
    Section 4 cloud model; a barriered window is charged the mean delay.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import async_vq


class NetworkModel:
    """Base communication-cost model."""

    name = "base"

    def round_lengths(self, generator: torch.Generator, m: int,
                      max_rounds: int, tau: int) -> torch.Tensor:
        """(m, max_rounds) int32 per-round durations in wall ticks (>= tau),
        a host tensor; random models draw from ``generator`` (a CPU
        ``torch.Generator``)."""
        raise NotImplementedError

    def window_ticks(self, tau: int) -> int:
        """Wall ticks a synchronous tau-window costs under this network."""
        raise NotImplementedError

    def transfer_ticks(self, wire_bytes: float, *,
                       tier: int | None = None) -> int:
        """Extra wall ticks to move ``wire_bytes`` of measured merge traffic
        over link class ``tier``; the base model has infinite bandwidth."""
        del wire_bytes, tier
        return 0


@dataclasses.dataclass(frozen=True)
class InstantNetwork(NetworkModel):
    name = "instant"

    def round_lengths(self, generator, m, max_rounds, tau):
        del generator
        return torch.full((m, max_rounds), tau, dtype=torch.int32)

    def window_ticks(self, tau):
        return tau


@dataclasses.dataclass(frozen=True)
class FixedLatencyNetwork(NetworkModel):
    """Every round pays ``latency_ticks``; ``bytes_per_tick`` > 0 also
    charges ceil(wire / bandwidth) ticks per window, and
    ``dcn_bytes_per_tick`` > 0 prices tier 1 at its own bandwidth."""

    latency_ticks: int = 1
    bytes_per_tick: int = 0
    dcn_bytes_per_tick: int = 0
    name = "fixed"

    def __post_init__(self):
        for field in ("latency_ticks", "bytes_per_tick", "dcn_bytes_per_tick"):
            if getattr(self, field) < 0:
                raise ValueError(
                    f"{field} must be >= 0, got {getattr(self, field)}")

    def transfer_ticks(self, wire_bytes, *, tier=None):
        rate = self.bytes_per_tick
        if tier == 1 and self.dcn_bytes_per_tick > 0:
            rate = self.dcn_bytes_per_tick
        if rate <= 0 or wire_bytes <= 0:
            return 0
        return int(-(-wire_bytes // rate))

    def round_lengths(self, generator, m, max_rounds, tau):
        del generator
        return torch.full((m, max_rounds), tau + self.latency_ticks,
                          dtype=torch.int32)

    def window_ticks(self, tau):
        return tau + self.latency_ticks


@dataclasses.dataclass(frozen=True)
class GeometricDelayNetwork(NetworkModel):
    """Paper Section 4: extra round ticks ~ Geometric(p_delay)."""

    p_delay: float = 0.5
    name = "geometric"

    def __post_init__(self):
        if not 0.0 < self.p_delay <= 1.0:
            raise ValueError(f"p_delay must be in (0, 1], got {self.p_delay}")

    def round_lengths(self, generator, m, max_rounds, tau):
        # the same sampler as async_vq's own draw, so the sim oracle and the
        # mesh engine replay identical delays from one generator
        return async_vq.round_lengths(generator, (m, max_rounds), tau=tau,
                                      p_delay=self.p_delay)

    def window_ticks(self, tau):
        # a barriered window waits for the slowest worker; charging the MEAN
        # extra delay keeps the sync/async comparison conservative
        mean_extra = (1.0 - self.p_delay) / self.p_delay
        return tau + int(round(mean_extra))


_NETWORKS = {
    "instant": InstantNetwork,
    "fixed": FixedLatencyNetwork,
    "geometric": GeometricDelayNetwork,
}


def get_network(name: str, **kwargs) -> NetworkModel:
    """Factory: 'instant' | 'fixed' | 'geometric' (+ model kwargs)."""
    if name not in _NETWORKS:
        raise ValueError(
            f"unknown network model {name!r}; choose from {sorted(_NETWORKS)}")
    return _NETWORKS[name](**kwargs)
