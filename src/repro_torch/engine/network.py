"""Communication-cost models, counterpart of ``repro/engine/network.py``.

A ``NetworkModel`` answers what the executors ask of the network:

  * ``round_lengths(generator, m, max_rounds, tau)``, for the async scheme
    (eq. 9) and the load generator's arrivals: the wall ticks each of a
    worker's back-to-back upload/download rounds takes, always >= tau;
  * ``window_ticks(tau)``, for the sync schemes: what a barriered window
    costs (compute plus the blocking merge round-trip), and
    ``transfer_ticks(wire_bytes, tier=)``, the extra ticks to move a
    window's measured merge bytes over a link class;
  * ``late_matrix(m, n_windows, tau, window0=)``, for the quorum merge:
    which worker's delta misses which window's deadline.  It is host-side
    numpy (Philox), so its bits are the reference's exactly.

  * ``InstantNetwork``: communication is free, a window costs tau ticks
    (the simulated architecture of paper Sections 2-3);
  * ``FixedLatencyNetwork``: every round pays a constant latency, and
    optionally ceil(bytes / bandwidth) ticks;
  * ``GeometricDelayNetwork``: extra ticks ~ Geometric(p_delay), the paper's
    Section 4 cloud model; a barriered window is charged the mean delay.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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

    def late_matrix(self, m: int, n_windows: int, tau: int, *,
                    window0: int = 0) -> np.ndarray:
        """(m, n_windows) float32 lateness bits for the sync quorum merge:
        1.0 = that worker's window delta misses the merge deadline (it is
        folded in late, damped by the stale-window rule).  ``window0`` is
        the global index of the first window.  The base model is always on
        time, so a quorum run over it is the plain eq.-8 merge."""
        del tau, window0
        return np.zeros((m, n_windows), np.float32)


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

    def late_matrix(self, m, n_windows, tau, *, window0=0):
        """Geometric-tail stragglers: a worker is late when its sampled
        extra delay exceeds a window of slack (extra > tau), the tail mass
        ``(1-p)^(tau+1)``.  One numpy Philox stream per global window,
        keyed on ``(p_delay, window0 + w)``, so a run that starts at
        ``window0`` draws the columns a whole run drew for those windows."""
        u = np.stack([
            np.random.Generator(np.random.Philox(
                key=[int(self.p_delay * 1e6), window0 + w])).random(m)
            for w in range(n_windows)], axis=1)
        extra = np.floor(np.log(np.maximum(u, 1e-12))
                         / np.log1p(-min(self.p_delay, 1 - 1e-9)))
        return (np.maximum(extra, 0) > tau).astype(np.float32)


class Tier1BudgetController:
    """Host-side bandwidth-adaptive top-k: sizes the sparse tier's ``frac``
    to a wire budget a window.

    After every chunk of windows the executor hands it the chunk's measured
    tier-1 bytes a window; it prices them with ``transfer_ticks(tier=1)``
    and halves ``frac`` when the transfer overshoots ``budget_ticks``,
    doubles it when it is at most ``low_water * budget_ticks`` (a free
    network relaxes to ``max_frac``), and otherwise holds it.  The factor-2
    ladder bounds the distinct top-k counts to ``log2(max_frac /
    min_frac)``.

    It adapts ``transport.tier1.frac`` on a ``HierarchicalTransport``, or
    ``transport.frac`` on a flat ``SparseTransport``; a
    ``QuantizedTransport`` is transparent (the knob is on its inner
    transport).  One worker a process, each rank runs its own controller
    on its own transport: the bytes it prices are its ``CommLog``'s, shape
    arithmetic equal on every rank, so every rank sets the same ``frac``,
    and so gathers the same k, after every chunk."""

    def __init__(self, network: NetworkModel, *, budget_ticks: int = 2,
                 min_frac: float = 1.0 / 1024.0, max_frac: float = 1.0,
                 low_water: float = 0.5):
        if budget_ticks < 1:
            raise ValueError(f"budget_ticks must be >= 1, got {budget_ticks}")
        if not 0.0 < min_frac <= max_frac <= 1.0:
            raise ValueError(
                f"need 0 < min_frac <= max_frac <= 1, got "
                f"({min_frac}, {max_frac})")
        if not 0.0 <= low_water < 1.0:
            raise ValueError(f"low_water must be in [0, 1), got {low_water}")
        self.network = network
        self.budget_ticks = budget_ticks
        self.min_frac = min_frac
        self.max_frac = max_frac
        self.low_water = low_water
        self.last_frac: float | None = None

    @staticmethod
    def _target(transport):
        """The object whose ``frac`` this controller owns, or None."""
        transport = getattr(transport, "inner", transport)
        tier1 = getattr(transport, "tier1", None)
        if tier1 is not None and hasattr(tier1, "frac"):
            return tier1
        if hasattr(transport, "frac"):
            return transport
        return None

    def update(self, transport, wire_per_window: float) -> float | None:
        """One control step from a chunk's tier-1 bytes a window: sets the
        transport's frac and returns it (None: no sparse tier to adapt)."""
        target = self._target(transport)
        if target is None:
            return None
        frac = float(target.frac)
        ticks = self.network.transfer_ticks(wire_per_window, tier=1)
        if ticks > self.budget_ticks:
            frac = max(frac / 2.0, self.min_frac)
        elif ticks <= self.low_water * self.budget_ticks:
            frac = min(frac * 2.0, self.max_frac)
        target.frac = frac
        self.last_frac = frac
        return frac


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
