"""Three-term roofline of one VQ window, counterpart of the VQ half of
``repro/distributed/roofline.py`` (``VqCell``, ``vq_roofline_terms``; lines
215-337 there).  The LM half (``MeshShape``, ``cell_flops``,
``cell_bytes``, ``roofline_terms``) comes with the LM dry run's cells
(ROADMAP queue 1, item 8b-2).

  compute term    = FLOPs / PEAK_FLOPS
  memory term     = HBM bytes / HBM_BW
  collective term = collective bytes / COLLECTIVE_BW

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates
at the 700 W power limit):

  * ``PEAK_FLOPS`` = 67e12, f32 outside the tensor cores.  The port pins
    TF32 off (``device.pin_full_f32``), so the VQ loop runs f32 on the CUDA
    cores; the reference's 197e12 is a TPU bf16 peak.
  * ``HBM_BW`` = 3.35e12 bytes/s.
  * ``COLLECTIVE_BW``: the rate a merge moves its bytes at.  With the
    workers stacked on one card a merge is a reduction in the card's own
    memory, so it is ``HBM_BW``.  With one worker a process on one card
    (``distributed.process_group``) both collectives are priced at
    ``HBM_BW`` too: the ring's hops read and write the same HBM through
    CUDA IPC, and gloo's reduce (and the sparse transport's gather) stages
    CUDA tensors through host memory, whose copies and handshakes the model
    does not count, so they land in the ``host`` residual.  The terms are
    then those of the stacked run of the same configuration, the ranks
    sharing the card counted as its workers.  Across cards a hop would
    move over NVLink at 450e9 bytes/s a direction (NVLink 4, 18 links); no
    path prices that rate yet (one card).

Every method of ``VqCell`` keeps the reference's hand count exactly: the
terms are per worker.  ``obs.profile.Profiler`` scales them to the card.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 67e12         # f32 FLOP/s, CUDA cores, one H100 SXM
HBM_BW = 3.35e12           # bytes/s, one H100 SXM
COLLECTIVE_BW = HBM_BW     # bytes/s of a merge among workers on one card


@dataclasses.dataclass(frozen=True)
class VqCell:
    """Shapes of one VQ *window* of ONE worker.

    A window is ``tau`` stochastic VQ steps (assign -> delta -> update, the
    eq. 3/8 inner loop), an eval-set distortion probe and the cross-worker
    merge.  The flop and byte terms below are the reference's hand counts
    for those phases at the ``(d, kappa, tau, bm)`` shapes its Pallas path
    tiles over."""

    d: int                 # point dimensionality
    kappa: int             # codebook size
    tau: int               # steps per window (merge period)
    n_eval: int = 0        # eval points scored per window (0 = no probe)
    bm: int = 128          # block rows (HBM tiling granularity)
    dtype_bytes: int = 4   # codebook/point element width (f32)
    bk: int = 128          # codebook-block rows (blocked/fused regime)

    def step_flops(self) -> float:
        """One stochastic VQ step: distances ``2*kappa*d`` (|z-w|^2 via the
        expanded dot), argmin ``kappa``, one-hot delta scatter ``2*kappa*d``,
        and the eq.-8 update (scale + add + displacement) ``3*kappa*d``."""
        k, d = self.kappa, self.d
        return 2 * k * d + k + 2 * k * d + 3 * k * d

    def eval_flops(self) -> float:
        """Distortion probe: full distance matrix + min-reduce over codes."""
        return 2 * self.n_eval * self.kappa * self.d + 2 * self.n_eval * self.kappa

    def merge_flops(self) -> float:
        """Post-collective combine: scale + add over the codebook."""
        return 3 * self.kappa * self.d

    def window_flops(self) -> float:
        """FLOPs for one full window (tau steps + probe + merge)."""
        return self.tau * self.step_flops() + self.eval_flops() + self.merge_flops()

    def window_hbm_bytes(self) -> float:
        """Dominant per-window HBM traffic: each step re-reads the codebook
        (twice: assign + update) and streams its point; the probe streams the
        eval shard; the merge reads + writes the codebook once."""
        b = self.dtype_bytes
        k, d = self.kappa, self.d
        per_step = 2 * k * d * b + d * b + k * b     # codebook x2, point, codes
        probe = self.n_eval * d * b
        merge = 2 * k * d * b
        return self.tau * per_step + probe + merge

    def merge_collective_bytes(self) -> float:
        """Logical all-reduce payload of one dense merge: the codebook."""
        return self.kappa * self.d * self.dtype_bytes

    # -- blocked/fused delta kernel terms (the tile tuner's objective) -----

    def delta_grid(self, batch: int) -> tuple[int, int]:
        """(codebook_blocks, batch_blocks) of the blocked kernel's two-sweep
        grid, after padding to tile multiples."""
        kb = -(-self.kappa // self.bk)
        nb = -(-batch // self.bm)
        return kb, nb

    def delta_flops(self, batch: int) -> float:
        """One fused assign+delta dispatch over a (batch, d) block of
        points: the distance sweep's expanded dot + argmin and the
        accumulate sweep's one-hot matmul scatter."""
        k, d = self.kappa, self.d
        distance = 2 * batch * k * d + batch * k
        accumulate = 2 * batch * k * d + batch * k
        return distance + accumulate

    def delta_hbm_bytes(self, batch: int) -> float:
        """HBM traffic of the blocked kernel INCLUDING refetches: both
        sweeps re-stream each (bm, d) point block once per codebook block
        and each (bk, d) codebook block once per batch block."""
        kb, nb = self.delta_grid(batch)
        b = self.dtype_bytes
        k, d = self.kappa, self.d
        sweeps = 2 * (kb * batch * d * b + nb * k * d * b)
        outputs = k * d * b + k * b + 2 * batch * b   # zsum, counts, arg+min
        return sweeps + outputs


def vq_roofline_terms(cell: VqCell,
                      collective_bytes_per_window: float | None = None) -> dict:
    """Per-window roofline terms (seconds) for one VQ worker.

    ``collective_bytes_per_window`` comes from the run's ``CommRecord``s
    (``comm_analysis.analyze_collectives``); the analytic
    ``merge_collective_bytes`` is the dense-merge count used when no
    program was recorded."""
    coll = (cell.merge_collective_bytes()
            if collective_bytes_per_window is None
            else collective_bytes_per_window)
    terms = {
        "compute": cell.window_flops() / PEAK_FLOPS,
        "memory": cell.window_hbm_bytes() / HBM_BW,
        "collective": coll / COLLECTIVE_BW,
    }
    dominant = max(terms, key=terms.get)
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dominant,
        "window_flops": cell.window_flops(),
        "window_hbm_bytes": cell.window_hbm_bytes(),
        "collective_bytes": coll,
        "window_time_bound_s": max(terms.values()),   # perfect-overlap bound
    }
