"""``MeshExecutor``: the paper's schemes with the workers stacked on one card.

Counterpart of ``repro/engine/mesh.py`` for ``average`` (eq. 3), ``delta``
(eq. 8) and ``async_delta`` (eq. 9).  The reference shards one worker per
device and merges with collectives; here the M workers are the leading
dimension of the codebook tensor ``(M, kappa, d)``, one kernel launch runs
every worker's window (or tick), and the merge is a reduction over that
dimension through the executor's ``Transport``, which records the wire
bytes a ring all-reduce among M devices would move.

The inner loop (``_local_window``) has the reference's three routes:

  * the window kernel, one launch per window, when ``fused`` is on and the
    codebook fits (``ops.window_fits``);
  * the per-step loop through the delta kernel (``ops.vq_delta_routed``),
    with the eq.-1 update in PyTorch, when ``fused`` is off or the window
    kernel does not fit;
  * the per-step loop through ``core.vq.H``, when ``use_kernels`` is off.

On the CPU the kernels' plain versions stand in, and all three routes give
the same codebooks bit for bit; on the card the first two do (the kernels
share their distance routine).

After every window the shared codebook is scored by eq. 2: the mean over
workers of ``vq.distortion`` on each worker's eval points, reduced through
the transport with tag ``"eval"``.

The merge runs on the executor's transport: the dense ``XlaTransport`` by
default, or the top-k ``SparseTransport`` (``transport="sparse"`` or an
instance with its ``frac``).  A stateful transport's state (the sparse
residual, f32 (M, kappa, d) on the device) is made once per run and threaded
window by window, or tick by tick for eq. 9, as the reference threads it
through its scans.  With ``use_kernels`` off the transport's selection is
its plain version too (``Transport.plain``).

The async scheme (``_run_async``, the reference's ``mesh.py:812-915``) has
no window: every tick each worker takes one eq.-1 step at batch 1 (the
delta kernel, or ``vq.H`` with ``use_kernels`` off), then the in-flight
displacements of the workers whose round completes land on the shared
version through ``Transport.masked_all_reduce``.  The completion schedule
is one (n, M) mask made from the round lengths before the loop starts
(``core.async_vq.done_mask``), so no tick waits on the host; the shared
version is scored every ``eval_every`` ticks as the loop passes them.
"""

from __future__ import annotations

import torch

from repro_torch import comm
from repro_torch import device as device_lib
from repro_torch.core import async_vq, vq
from repro_torch.core.schemes import SchemeResult
from repro_torch.engine import api
from repro_torch.engine import merge as merge_lib
from repro_torch.engine.network import GeometricDelayNetwork, NetworkModel
from repro_torch.kernels import ops


class MeshExecutor:
    """M workers stacked on one device, merged through a transport."""

    name = "mesh"

    def __init__(self, network: NetworkModel | None = None, *,
                 transport: comm.Transport | str | None = None,
                 use_kernels: bool = True, fused: bool = True,
                 eval_every: int = 10,
                 device: str | torch.device | None = None):
        self.network = network or GeometricDelayNetwork()
        # use_kernels=False is the reference's use_pallas=False: the plain
        # vq.H step, and the transport's plain selection.  fused=False keeps
        # the per-step delta-kernel loop as the comparator of the window
        # kernel; both give the same codebooks.
        self.transport = comm.get_transport(
            transport if transport is not None else "xla")
        if not use_kernels:
            self.transport = self.transport.plain()
        self.use_kernels = use_kernels
        self.fused = fused
        # the async scheme scores the shared version every eval_every ticks
        self.eval_every = eval_every
        self.device = device_lib.resolve(device)
        # comm summary of the most recent run() (CommLog.summarize dict)
        self.last_comm: dict | None = None

    def _local_window(self, w0: torch.Tensor, zwin: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
        """tau sequential eq.-1 steps for every worker from the shared w0
        (kappa, d) over zwin (M, tau, d); returns (M, kappa, d)."""
        m, tau, d = zwin.shape
        kappa = w0.shape[0]
        if self.use_kernels and self.fused and ops.window_fits(kappa, d):
            return ops.vq_window(zwin, w0, eps)
        w = w0.expand(m, kappa, d).contiguous()
        for s in range(tau):
            w = w - eps[s] * self._h(zwin[:, s], w)
        return w

    def _h(self, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Eq. (4)'s H(z, w) for every worker: z (M, d), w (M, kappa, d)."""
        if not self.use_kernels:
            return vq.H(z, w)
        # a batch of one point per worker, so counts/zsum reduce exactly to
        # H(z, w)
        counts, zsum = ops.vq_delta_routed(z.unsqueeze(1).contiguous(), w)
        return counts.unsqueeze(-1) * w - zsum

    def _run_async(self, w0: torch.Tensor, data: torch.Tensor,
                   eval_data: torch.Tensor, *, tau: int, eps0: float,
                   decay: float, lengths: torch.Tensor) -> SchemeResult:
        """Eq. (9), tick by tick; the where-updates follow the reference's
        ``mesh.py:834-866`` line for line."""
        m, n, _ = data.shape
        kappa, d = w0.shape
        dones = async_vq.done_mask(lengths, m, n, tau, self.device)
        dones_f = dones.to(torch.float32)
        eps_all = vq.default_steps(torch.arange(1, n + 1, device=self.device),
                                   eps0=eps0, decay=decay)
        w = w0.expand(m, kappa, d).contiguous()
        w_srd, snap = w0, w.clone()
        dcur = torch.zeros_like(w)
        dinf = torch.zeros_like(w)
        comm_state = self.transport.init_state(dinf)
        curve = []
        for t in range(n):
            # local VQ step on every worker (1st line of eq. 9)
            step = eps_all[t] * self._h(data[:, t], w)
            w_tmp = w - step
            dcur = dcur + step
            # masked merge: only completing workers' in-flight deltas land
            # on the shared version (4th line)
            landed, comm_state = self.transport.masked_all_reduce(
                dinf, dones_f[t], state=comm_state, tag="merge")
            w_srd = w_srd - landed
            # completed: adopt the downloaded snapshot and replay the local
            # delta (3rd line); the others keep the plain step (2nd line)
            mask = dones[t][:, None, None]
            w = torch.where(mask, snap - dcur, w_tmp)
            snap = torch.where(mask, w_srd, snap)
            dinf = torch.where(mask, dcur, dinf)
            dcur = dcur.masked_fill(mask, 0.0)
            if (t + 1) % self.eval_every == 0:
                curve.append(self._eval(eval_data, w_srd))
        ticks = async_vq.eval_ticks(n, self.eval_every) + 1
        return SchemeResult(
            w_shared=w_srd, wall_ticks=ticks.to(torch.int32),
            distortion=torch.stack(curve) if curve else torch.zeros(0))

    def _eval(self, eval_data: torch.Tensor, w_srd: torch.Tensor
              ) -> torch.Tensor:
        """Eq. 2 of the shared codebook: the mean over workers, reduced
        through the transport with tag "eval"."""
        return self.transport.all_reduce(vq.distortion(eval_data, w_srd),
                                         op="mean", tag="eval")[0]

    def run(self, scheme: str, w0: torch.Tensor, data: torch.Tensor,
            eval_data: torch.Tensor, *, tau: int, eps0: float = 0.5,
            decay: float = 1.0, generator: torch.Generator | None = None,
            lengths: torch.Tensor | None = None) -> SchemeResult:
        api.validate_scheme(scheme)
        if data.dim() != 3:
            raise ValueError(f"data must be (M, n, d), got {tuple(data.shape)}")
        if eval_data.dim() != 3 or eval_data.shape[0] != data.shape[0]:
            raise ValueError(
                f"eval_data must be (M, n_eval, d) with the same M as data; "
                f"got {tuple(eval_data.shape)} vs M={data.shape[0]}")
        if w0.dim() != 2 or w0.shape[1] != data.shape[2]:
            raise ValueError(
                f"w0 must be (kappa, d={data.shape[2]}), got {tuple(w0.shape)}")
        m, n, _ = data.shape
        n_windows = n // tau
        if n_windows == 0:
            raise ValueError(f"need at least one tau={tau} window, got n={n}")
        w0, data, eval_data = (x.to(self.device, torch.float32).contiguous()
                               for x in (w0, data, eval_data))
        if scheme == "async_delta":
            lengths = api.async_lengths(self.network, m, n, tau,
                                        generator=generator, lengths=lengths)
            mark = self.transport.log.mark()
            try:
                return self._run_async(w0, data, eval_data, tau=tau,
                                       eps0=eps0, decay=decay,
                                       lengths=lengths)
            finally:
                self.last_comm = comm.CommLog.summarize(
                    self.transport.log.since(mark))
        strategy = merge_lib.get_merge(scheme, transport=self.transport)
        # every window's step sizes at once: eps_t for t = 1 .. n_windows*tau
        eps_all = vq.default_steps(
            torch.arange(1, n_windows * tau + 1, device=self.device),
            eps0=eps0, decay=decay)
        log = self.transport.log
        mark = log.mark()
        w_srd, curve = w0, []
        state = strategy.init_state(w0.expand(m, *w0.shape))
        try:
            for i in range(n_windows):
                span = slice(i * tau, (i + 1) * tau)
                w_fin = self._local_window(w_srd, data[:, span].contiguous(),
                                           eps_all[span])
                w_srd, state = strategy(w_srd, w_fin, state=state)
                curve.append(self._eval(eval_data, w_srd))
        finally:
            self.last_comm = comm.CommLog.summarize(log.since(mark))
        merge_wire = self.last_comm["by_tag"].get(
            "merge", {"wire_bytes": 0})["wire_bytes"]
        wt = (self.network.window_ticks(tau)
              + self.network.transfer_ticks(merge_wire / n_windows))
        ticks = torch.arange(1, n_windows + 1, dtype=torch.int32) * wt
        return SchemeResult(w_shared=w_srd, wall_ticks=ticks,
                            distortion=torch.stack(curve))
