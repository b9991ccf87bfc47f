"""``SimExecutor``: the plain oracles behind the Executor API.

Counterpart of ``repro/engine/sim.py``: it runs
``core.schemes.scheme_average`` / ``scheme_delta`` and restates their wall
ticks under the executor's ``NetworkModel``, and runs
``core.async_vq.scheme_async`` on round lengths drawn from that network
(or the caller's).
"""

from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.core import async_vq, schemes
from repro_torch.core.schemes import SchemeResult
from repro_torch.engine import api
from repro_torch.engine.network import GeometricDelayNetwork, NetworkModel


class SimExecutor:
    """Plain PyTorch oracle backend (M workers as one stacked tensor)."""

    name = "sim"

    def __init__(self, network: NetworkModel | None = None,
                 eval_every: int = 10, *,
                 device: str | torch.device | None = None):
        self.network = network or GeometricDelayNetwork()
        self.eval_every = eval_every
        self.device = device_lib.resolve(device)

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        api.validate_scheme(scheme)
        w0, data, eval_data = (x.to(self.device, torch.float32)
                               for x in (w0, data, eval_data))
        if scheme == "async_delta":
            m, n, _ = data.shape
            r = async_vq.scheme_async(
                w0, data, eval_data, tau=tau, eps0=eps0, decay=decay,
                eval_every=self.eval_every,
                lengths=api.async_lengths(self.network, m, n, tau,
                                          generator=generator,
                                          lengths=lengths))
            return SchemeResult(*r)
        fn = (schemes.scheme_average if scheme == "average"
              else schemes.scheme_delta)
        res = fn(w0, data, eval_data, tau=tau, eps0=eps0, decay=decay)
        # the oracles assume instant communication (ticks = k*tau); restate
        # wall time under this executor's network so sim and mesh curves
        # share a time axis
        wt = self.network.window_ticks(tau)
        if wt != tau:
            res = res._replace(wall_ticks=(res.wall_ticks // tau) * wt)
        return res
