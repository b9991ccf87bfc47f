"""``SimExecutor``: the plain oracles behind the Executor API.

Counterpart of ``repro/engine/sim.py``: it runs
``core.schemes.scheme_average`` / ``scheme_delta`` and restates their wall
ticks under the executor's ``NetworkModel``, and runs
``core.async_vq.scheme_async`` on round lengths drawn from that network
(or the caller's).  ``tracer=`` / ``metrics=`` (``repro_torch.obs``) get
the reference's ``run`` span, ``run_wall_s`` and ``distortion``
histograms and the distortion-over-ticks counter series.
"""

from __future__ import annotations

import time

import torch

from repro_torch import device as device_lib
from repro_torch.core import async_vq, schemes
from repro_torch.core.schemes import SchemeResult
from repro_torch.engine import api
from repro_torch.engine.network import GeometricDelayNetwork, NetworkModel
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer


class SimExecutor:
    """Plain PyTorch oracle backend (M workers as one stacked tensor)."""

    name = "sim"

    def __init__(self, network: NetworkModel | None = None,
                 eval_every: int = 10, *,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 device: str | torch.device | None = None):
        self.network = network or GeometricDelayNetwork()
        self.eval_every = eval_every
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.device = device_lib.resolve(device)

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        api.validate_scheme(scheme)
        t_wall = time.perf_counter()
        with self.tracer.span("run", scheme=scheme, executor=self.name,
                              m=data.shape[0]):
            res = self._run(scheme, w0, data, eval_data, tau=tau, eps0=eps0,
                            decay=decay, generator=generator,
                            lengths=lengths)
        self._emit_obs(scheme, res, time.perf_counter() - t_wall)
        return res

    def _run(self, scheme: str, w0, data, eval_data, *, tau: int,
             eps0: float, decay: float, generator, lengths) -> SchemeResult:
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

    def _emit_obs(self, scheme: str, res: SchemeResult,
                  wall_s: float) -> None:
        """Distortion-over-ticks counters on one timeline, as the
        reference's ``_emit_obs`` (``sim.py:70-84``)."""
        tr, mt = self.tracer, self.metrics
        if mt is None and not tr.enabled:
            return
        curve = res.distortion.cpu().tolist()
        if mt is not None:
            mt.histogram("run_wall_s", executor=self.name,
                         scheme=scheme).observe(wall_s)
            mt.histogram("distortion", scheme=scheme).observe_many(curve)
        for t, c in zip(res.wall_ticks.cpu().tolist(), curve):
            tr.counter("distortion", float(c), ts_us=float(t))
