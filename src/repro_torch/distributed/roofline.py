"""Three-term rooflines, counterpart of ``repro/distributed/roofline.py``:
the LM half (``MeshShape``, ``mesh_shape``, ``layer_flops_token``,
``cell_flops``, ``replication_waste``, ``cell_bytes``, ``uses_fsdp_name``,
``roofline_terms``; lines 31-208 and 339-366 there) for every (arch x
shape x layout) cell of the dry run, and the VQ half (``VqCell``,
``vq_roofline_terms``; lines 215-337) for one VQ window.

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

The LM half keeps the reference's FLOP and byte arithmetic exactly (the
model's bf16 weights, the reference's remat and sharding policy) and
prices it per device at one H100 SXM's rates (NVIDIA H100 80GB HBM3 at its
700 W power limit):

  * ``BF16_PEAK_FLOPS`` = 989e12, the bf16 dense tensor-core peak (the LM
    runs its matmuls in bf16 on the tensor cores; ``PEAK_FLOPS`` above is
    the VQ loop's f32 rate on the CUDA cores);
  * ``HBM_BW`` = 3.35e12 bytes/s;
  * ``NVLINK_BW`` = 450e9 bytes/s a direction (NVLink 4, 18 links): the
    rate a collective between cards would move at.

The reference reads its collective bytes from the compiled program's HLO
(its ``hlo_analysis``); the port's dry run reads them from its placed
program lowered on ``meta`` tensors (``distributed.hlo_analysis``), and
``roofline_terms`` prices them at ``NVLINK_BW`` ("lowered").  A caller
with no program passes ``collective_bytes_per_dev=None``: the collective
term is then ``None`` ("not lowered") and the dominant term and the MFU
bound are taken over the compute and memory terms.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import ShapeCell
from repro_torch.models.common import ModelConfig, get_run_options

PEAK_FLOPS = 67e12         # f32 FLOP/s, CUDA cores, one H100 SXM
HBM_BW = 3.35e12           # bytes/s, one H100 SXM
COLLECTIVE_BW = HBM_BW     # bytes/s of a merge among workers on one card
BF16_PEAK_FLOPS = 989e12   # bf16 dense FLOP/s, tensor cores, one H100 SXM
NVLINK_BW = 450e9          # bytes/s a direction, NVLink 4, one H100 SXM


# ---------------------------------------------------------------------------
# LM cells: analytic FLOPs and HBM bytes a device, the reference's counts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    pod: int
    data: int
    model: int

    @property
    def n_devices(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data


def mesh_shape(multi_pod: bool) -> MeshShape:
    """The production layout: (16, 16), or (2, 16, 16) multi-pod
    (``topology.production_grid``)."""
    return MeshShape(2 if multi_pod else 1, 16, 16)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _attn_proj_flops_token(cfg: ModelConfig) -> int:
    """Per-token projection matmul FLOPs of one attention layer (fwd)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2 * d * (hq * dh) * 2 + 2 * d * (hkv * dh) * 2  # q,o + k,v


def _attn_score_flops_token(cfg: ModelConfig, ctx: int,
                            window: int = 0) -> int:
    """Per-token score + value FLOPs at context length ``ctx`` (fwd)."""
    eff = min(ctx, window) if window else ctx
    return 2 * 2 * cfg.n_heads * cfg.head_dim * eff  # qk^T and pv


def _mlp_flops_token(cfg: ModelConfig) -> int:
    if cfg.family == "moe":
        return 2 * 3 * cfg.d_model * cfg.d_ff * cfg.top_k
    if cfg.family == "encdec":
        return 2 * 2 * cfg.d_model * cfg.d_ff
    return 2 * 3 * cfg.d_model * cfg.d_ff


def _ssm_flops_token(cfg: ModelConfig) -> int:
    d, di, n, h, p = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    proj = 2 * d * (2 * di + 2 * n + h)
    out = 2 * di * d
    # SSD: intra-chunk quadratic (chunk q=128) + state update/output
    q = 128
    intra = 2 * h * p * q + 2 * q * n  # per token vs chunk
    state = 2 * 2 * h * p * n
    return proj + out + intra + state


def layer_flops_token(cfg: ModelConfig, ctx: int,
                      decode: bool = False) -> float:
    """Fwd FLOPs a token a layer (a weighted mix for hybrid schedules)."""
    win = cfg.window
    f = 0.0
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        f += _attn_proj_flops_token(cfg)
        f += _attn_score_flops_token(cfg, ctx)
        f += _mlp_flops_token(cfg)
        if cfg.family == "encdec":  # cross attention
            f += 2 * cfg.d_model * cfg.n_heads * cfg.head_dim * 2
            f += 2 * 2 * cfg.n_heads * cfg.head_dim * cfg.encoder_frames
    elif cfg.family == "ssm":
        f += _ssm_flops_token(cfg)
    elif cfg.family == "hybrid":
        glob = 3 / cfg.n_layers
        eff = ctx if not win else (glob * ctx + (1 - glob) * min(ctx, win))
        f += _attn_proj_flops_token(cfg)
        f += _attn_score_flops_token(cfg, int(eff))
        f += _ssm_flops_token(cfg)
        f += _mlp_flops_token(cfg)
    return f


def cell_flops(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Global FLOPs of one step of the cell (fwd [+ bwd + remat for
    train])."""
    b, t = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        tokens = b  # one new token a sequence
        per_tok = layer_flops_token(cfg, t, decode=True) * cfg.n_layers
        head = 2 * cfg.d_model * cfg.vocab
        fwd = tokens * (per_tok + head)
        return {"fwd": fwd, "total": fwd,
                "model_flops": 2 * cfg.active_params() * tokens}
    tokens = b * t
    # mean causal context = t/2
    per_tok = layer_flops_token(cfg, t // 2) * cfg.n_layers
    if cfg.family == "encdec":
        enc_tok = cell.global_batch * cfg.encoder_frames
        enc = enc_tok * (_attn_proj_flops_token(cfg)
                         + _attn_score_flops_token(cfg, cfg.encoder_frames)
                         + 2 * 2 * cfg.d_model * cfg.d_ff) * cfg.encoder_layers
    else:
        enc = 0
    head = 2 * cfg.d_model * cfg.vocab
    fwd = tokens * (per_tok + head) + enc
    if cell.kind == "train":
        total = fwd * 4  # bwd = 2x fwd, full remat = +1x fwd
        model = 6 * cfg.active_params() * tokens
    else:
        total = fwd
        model = 2 * cfg.active_params() * tokens
    return {"fwd": fwd, "total": total, "model_flops": model}


def replication_waste(cfg: ModelConfig, mesh: MeshShape) -> float:
    """FLOP multiplier >= 1 for layers whose TP sharding falls back to
    replication (head counts the 'model' axis does not divide): those
    FLOPs run on every 'model' device instead of 1/model of them."""
    tp = mesh.model
    if cfg.family == "ssm":
        return 1.0
    if _div(cfg.n_heads, tp):
        return 1.0
    ctx = 2048  # representative
    attn = _attn_proj_flops_token(cfg) + _attn_score_flops_token(cfg, ctx)
    frac = attn / layer_flops_token(cfg, ctx)
    return (1 - frac) + frac * tp


def cell_bytes(cfg: ModelConfig, cell: ShapeCell, mesh: MeshShape,
               *, seq_parallel: bool = True) -> dict:
    """HBM traffic a device for one step (the dominant terms)."""
    n = mesh.n_devices
    params = cfg.n_params()
    p_bytes = params * 2  # bf16
    b, t = cell.global_batch, cell.seq_len
    d = cfg.d_model

    if cell.kind == "decode":
        # every local weight shard is read once a token step, plus the
        # cache's read and write
        weight_read = p_bytes / mesh.model  # TP-sharded; DP replicas each read
        if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            kv = (cfg.n_layers * 2 * b * t * cfg.n_kv_heads * cfg.head_dim * 2)
            cache = kv / n  # sharded over batch x seq
        else:
            cache = 0
        if cfg.family in ("ssm", "hybrid"):
            cache += (cfg.n_layers * b * cfg.ssm_heads * cfg.ssm_headdim
                      * cfg.ssm_state * 4 * 2) / max(mesh.model, 1)
        if cfg.family == "moe":
            weight_read = (p_bytes * cfg.active_params() / params) / mesh.model
        act = b * cfg.n_layers * d * 2 * 8 / n
        total = weight_read + cache + act
        return {"total": total, "weights": weight_read, "cache": cache}

    # train / prefill: the local params' traffic plus activations
    tp_shard = mesh.model
    fsdp = mesh.data if uses_fsdp_name(cfg) else 1
    local_params = p_bytes / tp_shard
    passes = 3 if cell.kind == "train" else 1  # fwd read, bwd read, grad write
    opt = (params * 4 * 2 * 2 / (tp_shard * fsdp)) if cell.kind == "train" else 0
    # activations: residual stream + attention internals, remat ~2x fwd
    toks_local = b * t / (mesh.dp * (tp_shard if seq_parallel else 1))
    act_unit = toks_local * d * 2
    act = act_unit * cfg.n_layers * 12 * (2 if cell.kind == "train" else 1)
    total = local_params * passes + opt + act
    return {"total": total, "weights": local_params * passes, "opt": opt,
            "activations": act}


def uses_fsdp_name(cfg: ModelConfig) -> bool:
    return cfg.name in {
        "granite-34b", "command-r-35b", "internvl2-76b",
        "moonshot-v1-16b-a3b", "starcoder2-7b",
    }


def roofline_terms(cfg: ModelConfig, cell: ShapeCell, mesh: MeshShape,
                   collective_bytes_per_dev: float | None) -> dict:
    """The cell's per-device seconds a step at the H100's rates: compute
    (FLOPs at ``BF16_PEAK_FLOPS``), memory (bytes at ``HBM_BW``, the
    activations split over 'model' under ``RunOptions.seq_parallel``) and
    collective (bytes at ``NVLINK_BW``, or ``None`` when no program was
    lowered, as ``collective_note`` then says); the dominant term, the step
    bound and the MFU bound are taken over the terms there are."""
    fl = cell_flops(cfg, cell)
    waste = replication_waste(cfg, mesh)
    dev_flops = fl["total"] * waste / mesh.n_devices
    by = cell_bytes(cfg, cell, mesh,
                    seq_parallel=get_run_options().seq_parallel)
    terms = {"compute": dev_flops / BF16_PEAK_FLOPS,
             "memory": by["total"] / HBM_BW,
             "collective": (None if collective_bytes_per_dev is None
                            else collective_bytes_per_dev / NVLINK_BW)}
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    step_time = max(known.values())  # perfect-overlap bound
    mfu = ((fl["model_flops"] / mesh.n_devices / BF16_PEAK_FLOPS) / step_time
           if step_time > 0 else 0.0)
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dominant,
        "collective_note": ("not lowered" if collective_bytes_per_dev is None
                            else "lowered"),
        "device_flops": dev_flops,
        "device_bytes": by["total"],
        "bytes_detail": by,
        "model_flops": fl["model_flops"],
        "useful_ratio": fl["model_flops"] / (fl["total"] * waste),
        "replication_waste": waste,
        "step_time_bound_s": step_time,
        "mfu_bound": mfu,
    }


# ---------------------------------------------------------------------------
# VQ cells: one window of one worker
# ---------------------------------------------------------------------------


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
