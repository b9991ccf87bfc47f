"""Block-level forward functions, counterpart of ``repro/models/blocks.py``:
GQA attention, SwiGLU / GELU MLPs, top-k MoE and the Mamba2 SSD mixer.

All functions take ``(cfg, params_leafdict, x, ...)`` with one layer's
leaves (no ``L`` axis); ``transformer.py`` / ``encdec.py`` loop them over
the stacked layers.  Each is written in the reference's spelling with
plain torch ops (einsum contractions, f32 scores and states, the casts back
to the activations' dtype where the reference has them).  No Pallas kernel
lies on this path in the reference: XLA compiles it.  ``moe_apply_ep``
is the reference's opt-in expert parallelism (its ``shard_map`` over
'model') over a process group: ``moe_apply`` takes it under
``RunOptions.moe_ep`` with a ``model_group`` whose size divides the
expert count.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ModelConfig, rope

_NEG = -1e30  # the reference's mask fill


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, -1)


@functools.lru_cache(maxsize=None)
def sqrt_f32(dh: int) -> float:
    """sqrt(dh) rounded to f32, as the reference computes it, held in a
    Python float: a scalar tensor built on the card would be one more
    host-to-device copy in every attention layer."""
    return float(torch.sqrt(torch.tensor(float(dh), dtype=torch.float32)))


@functools.lru_cache(maxsize=None)
def inv_sqrt_f32(dh: int) -> float:
    """1 / sqrt(dh) in f32 (the reference's attention scale)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(dh),
                                               dtype=torch.float32)))


def attention_train(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, return_kv: bool = False,
                    kv_index: list | None = None):
    """Self-attention over a (B, T, D) block, chunked over query blocks.

    Exact softmax per query chunk against the full K/V (the reference's
    memory-efficient attention): the peak transient is (B, H, q_chunk, T)
    f32 scores.  The chunks are ``q_chunk`` queries, the last one ragged;
    the reference takes the largest of 512, 256, ..., 1 that divides T,
    which is 4 for whisper's 1,500 frames: a scan step in XLA, but 375
    rounds of eager launches here.  Each query's row is the same softmax
    either way.  ``window`` > 0 masks to a sliding window.  The
    probabilities are cast to the activations' dtype before the PV
    product, as the reference casts them.

    The head counts are the leaves': a rank's shard of ``wq`` (and of
    ``wk`` / ``wv``) under tensor parallelism runs its own heads.
    ``kv_index`` names the K/V head of each query head when ``wk`` / ``wv``
    are whole and ``wq`` a shard (``attention_placed``).  ``return_kv``
    returns the K/V of every head the leaves give."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    hq, hkv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    pos = torch.arange(t, dtype=torch.int32, device=x.device)[None]
    q = _split_heads(x @ p["wq"], hq)
    k_all = _split_heads(x @ p["wk"], hkv)
    v_all = _split_heads(x @ p["wv"], hkv)
    if cfg.rope_theta > 0:
        q = rope(q, pos, cfg.rope_theta)
        k_all = rope(k_all, pos, cfg.rope_theta)
    k, v = k_all, v_all
    if kv_index is not None:
        k, v = k[:, :, kv_index], v[:, :, kv_index]
        hkv = len(kv_index)
    g = hq // hkv
    q = q.reshape(b, t, hkv, g, dh)

    scale = inv_sqrt_f32(dh)
    kpos = torch.arange(t, dtype=torch.int32, device=x.device)
    outs = []
    for i in range(0, t, q_chunk):
        qi = q[:, i:i + q_chunk]
        c = qi.shape[1]
        s = torch.einsum("bthgd,bshd->bhgts", qi, k).float() * scale
        qpos = i + torch.arange(c, dtype=torch.int32, device=x.device)
        mask = torch.ones((c, t), dtype=torch.bool, device=x.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask[None, None, None], s, _NEG)
        probs = torch.softmax(s, dim=-1).to(x.dtype)
        outs.append(torch.einsum("bhgts,bshd->bthgd", probs, v))
    out = torch.cat(outs, dim=1).reshape(b, t, hq * dh)
    if return_kv:
        return out @ p["wo"], k_all, v_all
    return out @ p["wo"]


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int, *, window: int = 0) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D); caches: (B, S, Hkv, Dh).

    Writes the new token's K/V at index ``cur_len`` of the caches IN PLACE
    and attends to positions [0, cur_len]; returns the (B, 1, D) output.
    """
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = k_cache.shape[1]
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q = _split_heads(x @ p["wq"], hq)
    k = _split_heads(x @ p["wk"], hkv)
    v = _split_heads(x @ p["wv"], hkv)
    if cfg.rope_theta > 0:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    k_cache[:, cur_len] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cur_len] = v[:, 0].to(v_cache.dtype)

    g = hq // hkv
    q = q.reshape(b, 1, hkv, g, dh)
    scores = torch.einsum("bthgd,bshd->bhgts", q, k_cache).float()
    scores = scores / sqrt_f32(dh)
    kpos = torch.arange(s, device=x.device)
    mask = kpos <= cur_len
    if window > 0:
        mask &= kpos > cur_len - window
    scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v_cache).reshape(
        b, 1, hq * dh)
    return out @ p["wo"]


def init_attention(cfg: ModelConfig, gen, n_layers: int, *,
                   device=None) -> dict:
    hq, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    shp = lambda *s: (n_layers, *s)  # noqa: E731
    init = lambda shape: common.init_dense(  # noqa: E731
        gen, shape, cfg.dtype, device=device)
    return {
        "wq": init(shp(d, hq * dh)),
        "wk": init(shp(d, hkv * dh)),
        "wv": init(shp(d, hkv * dh)),
        "wo": init(shp(hq * dh, d)),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def init_swiglu(cfg: ModelConfig, gen, n_layers: int, *,
                device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    init = lambda shape: common.init_dense(  # noqa: E731
        gen, shape, cfg.dtype, device=device)
    return {
        "w_gate": init((n_layers, d, f)),
        "w_up": init((n_layers, d, f)),
        "w_down": init((n_layers, f, d)),
    }


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-bounded, per-row dispatch)
# ---------------------------------------------------------------------------

def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties lowest
    index first (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
               logits: torch.Tensor | None = None):
    """Shared routing: per-row ranks and capacity mask.

    Returns (gates (B,T,k), unit_e (B,U), unit_pos (B,U), keep (B,U), cap);
    units are in (T, k) order, so the per-row rank cumsum drops the same
    units the reference drops, and a dropped unit's position is 0.
    ``logits``: the (B, T, E) router logits when the caller has them (a
    router split over the experts, gathered), else ``x @ router``.
    """
    b, t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    u = t * k
    if logits is None:
        logits = x @ router
    logits = logits.float()                                     # (B, T, E)
    gates, idx = _top_k(torch.softmax(logits, dim=-1), k)        # (B, T, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    cap = int(cfg.capacity_factor * t * k / e) or 1
    unit_e = idx.reshape(b, u)
    onehot = F.one_hot(unit_e, e).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1) - 1) * onehot             # per-row rank
    unit_pos = torch.sum(pos, dim=-1)
    keep = unit_pos < cap
    return gates, unit_e, torch.where(keep, unit_pos, 0), keep, cap


def _moe_experts(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 router: torch.Tensor, lo: int, n_loc: int,
                 logits: torch.Tensor | None = None) -> torch.Tensor:
    """Experts ``lo .. lo + n_loc - 1`` of a (B, T, D) block (``p``'s expert
    leaves hold just those): routing on the whole router, the dispatch of
    the kept units bound for them, their FFNs and the gate-weighted combine,
    as an f32 (B, T, D) partial.

    The dispatch writes only those units into the (B, n_loc, C, D) buffer
    with a plain indexed store: kept units have distinct (expert, rank)
    slots, so no two writes meet and the store needs no atomics.  The other
    units go to a spare slot C that is cut off before the experts run (the
    reference adds zeros at slot 0 instead: the same buffer).  The gate
    products are in the activations' dtype and their sum over k is f32, so
    a partial is rounded once, where the group's sum of them ends."""
    b, t, d = x.shape
    k = cfg.top_k
    gates, unit_e, unit_pos, keep, cap = _moe_route(cfg, router, x, logits)
    mine = keep & (unit_e >= lo) & (unit_e < lo + n_loc)
    e_local = torch.where(mine, unit_e - lo, 0)
    # each token k times, (B, U, D): an expand, whose backward sums the k
    # copies in a fixed order (repeat_interleave's adds with atomics on
    # the card)
    xu = x[:, :, None].expand(b, t, k, d).reshape(b, t * k, d)
    rows = torch.arange(b, device=x.device)[:, None]
    buf = torch.zeros((b, n_loc, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, e_local, torch.where(mine, unit_pos, cap)] = xu
    buf = buf[:, :, :cap]                                       # (B,El,C,D)

    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"])
    yb = torch.einsum("becf,efd->becd", h, p["w_down"])

    yu = yb[rows, e_local, torch.where(mine, unit_pos, 0)]      # (B, U, D)
    yu = yu * mine[..., None]
    return torch.sum((yu.reshape(b, t, k, d)
                      * gates[..., None].to(yu.dtype)).float(), dim=2)


def moe_apply_ep(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 group) -> torch.Tensor:
    """Expert-parallel MoE over the process group ``group``, counterpart of
    the reference's ``moe_apply_ep`` (its lines 214-272).

    Each rank holds ``n_experts / |group|`` experts (``p``'s expert leaves
    are its slice under ``sharding.param_specs``: ``sharding.moe_ep_params``)
    and the whole router.  Routing runs on every rank, each rank dispatches
    only the units bound for its experts, runs them, applies the
    gate-weighted combine locally, and the f32 partial (B, T, D) is summed
    over the group once (the reference rounds each shard's partial to the
    activations' dtype before its f32 psum, which in bf16 at olmoe's 16
    layers moved the logits 5.4% of their largest on an H100; kept in f32,
    the sum is ``moe_apply``'s).  The gradient takes Megatron's conjugate
    pair: ``x`` and the router enter through ``copy_to_group`` (identity
    forward, the ranks' gradient shares summed backward) and the partial
    leaves through ``reduce_from_group`` (sum forward, identity backward),
    so every rank gets the whole gradient of its replicated inputs and of
    its own experts."""
    from repro_torch.distributed import process_group
    e = cfg.n_experts
    tp = process_group.group_size(group)
    e_loc = e // tp
    if e % tp or p["w_gate"].shape[0] != e_loc:
        raise ValueError(
            f"expert parallelism over {tp} ranks needs this rank's "
            f"{e}/{tp} experts, got {p['w_gate'].shape[0]}")
    part = _moe_experts(cfg, p, process_group.copy_to_group(x, group),
                        process_group.copy_to_group(p["router"], group),
                        process_group.group_rank(group) * e_loc, e_loc)
    return process_group.reduce_from_group(part, group).to(x.dtype)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Top-k MoE over a (B, T, D) block, per-row capacity
    (capacity_factor * T * k / E a sequence): every expert on this rank
    (``_moe_experts``).  Under ``RunOptions.moe_ep`` with a ``model_group``
    whose size divides the expert count, ``moe_apply_ep`` runs instead, as
    in the reference (its lines 291-297)."""
    opts = common.get_run_options()
    group = opts.model_group
    if opts.moe_ep and group is not None:
        from repro_torch.distributed import process_group
        if cfg.n_experts % process_group.group_size(group) == 0:
            return moe_apply_ep(cfg, p, x, group)
    return _moe_experts(cfg, p, x, p["router"], 0,
                        cfg.n_experts).to(x.dtype)


def init_moe(cfg: ModelConfig, gen, n_layers: int, *, device=None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    init = lambda shape: common.init_dense(  # noqa: E731
        gen, shape, cfg.dtype, device=device)
    return {
        "router": init((n_layers, d, e)),
        "w_gate": init((n_layers, e, d, f)),
        "w_up": init((n_layers, e, d, f)),
        "w_down": init((n_layers, e, f, d)),
    }


# ---------------------------------------------------------------------------
# Mamba2 (SSD: state space duality, chunked scan)
# ---------------------------------------------------------------------------

def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  xbc: (B, T, C), conv_w: (W, C)."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * conv_w[i] for i in range(w))
    return F.silu(out)


def _segsum(logd: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular pairwise sums of log-decays:
    out[i, j] = sum_{k=j+1..i} logd[k] for i >= j, -inf otherwise."""
    q = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum_{k=j+1..i}
    i = torch.arange(q, device=logd.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_train(cfg: ModelConfig, xh: torch.Tensor, dt: torch.Tensor,
              A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
              chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD forward (Mamba2 alg. 1, G=1 group).

    xh: (b, T, H, P) head-split inputs; dt: (b, T, H) positive step sizes;
    A: (H,) negative decay rates; B, C: (b, T, N).
    Returns (y: (b, T, H, P), final_state: (b, H, P, N) f32).  T must be a
    multiple of min(chunk, T), the reference's assertion.
    """
    b, t, h, pdim = xh.shape
    q = min(chunk, t)
    if t % q != 0:
        raise ValueError(f"seq_len {t} must divide the SSD chunk: a prompt "
                         f"longer than {chunk} is a multiple of {chunk}")
    nc = t // q
    xc = xh.reshape(b, nc, q, h, pdim)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, -1)
    Cc = C.reshape(b, nc, q, -1)
    logd = dtc * A  # (b, nc, q, h) log-decay per step (A < 0)

    # ---- intra-chunk (quadratic attention-like) term ----
    L = _segsum(logd.movedim(-1, -2))                    # (b, nc, h, q, q)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)          # (b, nc, q, q)
    M = G[:, :, None] * torch.exp(L)                     # (b, nc, h, q, q)
    M = M * dtc.movedim(-1, -2)[..., None, :]            # weight by dt_j
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M.to(xh.dtype), xc)

    # ---- chunk-final states and inter-chunk recurrence ----
    cum = torch.cumsum(logd, dim=2)                      # (b, nc, q, h)
    total = cum[:, :, -1]                                # (b, nc, h)
    decay_to_end = torch.exp(total[:, :, None] - cum)    # (b, nc, q, h)
    Sc = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                      (decay_to_end * dtc).float(), Bc.float(), xc.float())

    s = torch.zeros((b, h, pdim, Sc.shape[-1]), dtype=torch.float32,
                    device=xh.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = torch.exp(total[:, c])[..., None, None] * s + Sc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                # (b, nc, h, p, n)

    decay_from_start = torch.exp(cum)                    # (b, nc, q, h)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp",
                           Cc.float(), s_prevs, decay_from_start)
    y = y_intra + y_inter.to(xh.dtype)
    return y.reshape(b, t, h, pdim), s


def mamba_train(cfg: ModelConfig, p: dict, x: torch.Tensor,
                *, return_state: bool = False):
    """Full Mamba2 mixer over (B, T, D), with the reference's separate
    projections (in_z / in_x / in_bc / in_dt).  With ``return_state`` also
    returns (conv_x_tail, conv_bc_tail, ssm_state) to seed decode after a
    prefill."""
    b, t, _ = x.shape
    # a rank's shard of the inner width and the heads under tensor
    # parallelism: the widths are the leaves'
    di, h, pdim = p["in_x"].shape[-1], p["in_dt"].shape[-1], cfg.ssm_headdim
    n = cfg.ssm_state
    z = x @ p["in_z"]                       # (B, T, di)
    xs_raw = x @ p["in_x"]                  # (B, T, di) pre-conv
    bc_raw = x @ p["in_bc"]                 # (B, T, 2n)
    xin = _causal_conv(xs_raw, p["conv_x"])             # (B, T, di)
    bc = _causal_conv(bc_raw, p["conv_bc"])             # (B, T, 2n)
    B, C = bc[..., :n], bc[..., n:]
    dt = F.softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(b, t, h, pdim)
    y, s_final = ssd_train(cfg, xh, dt, A, B, C)
    y = y + p["D"].to(xh.dtype)[None, None, :, None] * xh
    y = y.reshape(b, t, di) * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        w = cfg.ssm_conv
        pad_x = F.pad(xs_raw, (0, 0, w - 1, 0))
        pad_bc = F.pad(bc_raw, (0, 0, w - 1, 0))
        return out, pad_x[:, t:t + w - 1], pad_bc[:, t:t + w - 1], s_final
    return out


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 conv_x_st: torch.Tensor, conv_bc_st: torch.Tensor,
                 ssm_state: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One-token Mamba2 step.  x: (B, 1, D); conv_x_st: (B, W-1, di);
    conv_bc_st: (B, W-1, 2n); ssm_state: (B, H, P, N).  Returns (out,
    conv_x_st, conv_bc_st, ssm_state), the states new tensors."""
    b = x.shape[0]
    di, n, h, pdim = (p["in_x"].shape[-1], cfg.ssm_state,
                      p["in_dt"].shape[-1], cfg.ssm_headdim)
    z = (x @ p["in_z"])[:, 0]                              # (B, di)
    xs = x @ p["in_x"]                                     # (B, 1, di)
    bcs = x @ p["in_bc"]                                   # (B, 1, 2n)
    hist_x = torch.cat([conv_x_st, xs], dim=1)             # (B, W, di)
    hist_bc = torch.cat([conv_bc_st, bcs], dim=1)
    xin = F.silu(torch.sum(hist_x * p["conv_x"][None], dim=1))    # (B, di)
    bc = F.silu(torch.sum(hist_bc * p["conv_bc"][None], dim=1))   # (B, 2n)
    B, C = bc[..., :n], bc[..., n:]
    dt1 = F.softplus((x @ p["in_dt"])[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt1 * A)                                # (B, H)
    xh = xin.reshape(b, h, pdim)
    ssm_state = (dA[..., None, None] * ssm_state
                 + torch.einsum("bh,bn,bhp->bhpn",
                                dt1, B.float(), xh.float()))
    y = torch.einsum("bhpn,bn->bhp", ssm_state, C.float())
    y = y.to(x.dtype) + p["D"].to(x.dtype)[None, :, None] * xh
    y = (y.reshape(b, di) * F.silu(z))[:, None, :]
    return y @ p["out_proj"], hist_x[:, 1:], hist_bc[:, 1:], ssm_state


def init_mamba(cfg: ModelConfig, gen, n_layers: int, *, device=None) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    shp = lambda *s: (n_layers, *s)  # noqa: E731
    dev = gen.device if gen is not None else device

    def init(shape, scale=None):
        return common.init_dense(gen, shape, cfg.dtype, scale=scale,
                                 device=device)

    def full(value):
        return torch.full((n_layers, h), value, dtype=torch.float32,
                          device=dev)

    return {
        "in_z": init(shp(d, di)),
        "in_x": init(shp(d, di)),
        "in_bc": init(shp(d, 2 * n)),
        "in_dt": init(shp(d, h)),
        "conv_x": init(shp(cfg.ssm_conv, di), 0.5),
        "conv_bc": init(shp(cfg.ssm_conv, 2 * n), 0.5),
        "out_proj": init(shp(di, d)),
        "A_log": full(0.0),
        "D": full(1.0),
        "dt_bias": full(-1.0),
    }


# ---------------------------------------------------------------------------
# the placement's forms: tensor parallelism over 'model'
# ---------------------------------------------------------------------------
# Each form takes this rank's leaves (``sharding.param_specs``: heads,
# d_ff, experts, d_inner over 'model' where their counts divide it) and a
# (B, T, D) input every rank of 'model' holds whole (``Placed.enter``), and
# returns ``(out, partial)``: ``partial`` when the output is this rank's
# share of a row-parallel sum (``Placed.leave`` reduces it), else the
# output is whole on every rank.

def _tp_ok(pl, n: int) -> bool:
    return pl.tp > 1 and n > 0 and n % pl.tp == 0


def kv_index(cfg: ModelConfig, pl) -> list[int]:
    """The K/V head of each of this rank's query heads, when the query
    heads split over 'model' and the K/V heads do not (granite-8b's 8 K/V
    heads on 16 ranks): rank r takes the groups of its own query heads."""
    hq_l = cfg.n_heads // pl.tp
    g = cfg.n_heads // cfg.n_kv_heads
    return [(pl.tp_rank * hq_l + i) // g for i in range(hq_l)]


def attention_placed(cfg: ModelConfig, p: dict, h: torch.Tensor, pl, *,
                     causal: bool = True, window: int = 0,
                     return_kv: bool = False):
    """Self-attention, heads over 'model' where the query heads divide it
    (the K/V heads too, or each rank takes its query heads' groups of the
    whole K/V); where they do not (starcoder2's 36 heads, hymba's 25 on 16
    ranks) every rank runs it whole.  Returns ``(attention_train's result,
    partial)``."""
    part = _tp_ok(pl, cfg.n_heads)
    idx = (kv_index(cfg, pl) if part and not _tp_ok(pl, cfg.n_kv_heads)
           else None)
    return attention_train(cfg, p, h, causal=causal, window=window,
                           return_kv=return_kv, kv_index=idx), part


def mlp_placed(cfg: ModelConfig, p: dict, h: torch.Tensor, pl, *,
               gelu: bool = False):
    """SwiGLU (or GELU) with d_ff over 'model' where it divides."""
    y = gelu_mlp(p, h) if gelu else swiglu(p, h)
    return y, _tp_ok(pl, cfg.d_ff)


def moe_placed(cfg: ModelConfig, p: dict, h: torch.Tensor, pl):
    """Top-k MoE with the experts over 'model' where they divide it, the
    reference's ``_moe_shard`` placement of the (B, E, C, D) buffers (the
    batch over the DP axes, each rank its own experts): the router's
    columns are this rank's experts', so the logits are gathered over
    'model' first (their gradient's partials reduce-scattered back); each
    rank dispatches the units bound for its experts (``_moe_experts``) and
    its f32 partial leaves through ``Placed.leave``."""
    from repro_torch.distributed import process_group
    if not _tp_ok(pl, cfg.n_experts):
        return moe_apply(cfg, p, h), False
    e_loc = cfg.n_experts // pl.tp
    logits = process_group.gather_from_group(h @ p["router"], h.dim() - 1,
                                             pl.tp_group)
    return _moe_experts(cfg, p, h, None, pl.tp_rank * e_loc, e_loc,
                        logits=logits), True


#: Mamba2 leaves split over d_inner, and the dim each splits on
_DI_LEAVES = {"in_z": -1, "in_x": -1, "conv_x": -1, "out_proj": 0}


def mamba_leaves(cfg: ModelConfig, p: dict, pl) -> tuple[dict, bool]:
    """``(leaves, partial)`` of the Mamba2 mixer: d_inner and the SSM heads
    over 'model' where the heads divide it (``in_bc`` and ``conv_bc``
    whole, so B and C are every rank's); where d_inner divides and the
    heads do not (hymba's 50 heads on 16 ranks) its d_inner leaves are
    gathered and the mixer runs whole."""
    from repro_torch.distributed import process_group
    if _tp_ok(pl, cfg.ssm_heads):
        return p, True
    if _tp_ok(pl, cfg.d_inner):
        p = dict(p)
        for name, dim in _DI_LEAVES.items():
            leaf = p[name]
            p[name] = process_group.gather_from_group(
                leaf, dim % leaf.dim(), pl.tp_group)
    return p, False


def mamba_placed(cfg: ModelConfig, p: dict, h: torch.Tensor, pl, *,
                 return_state: bool = False):
    p, part = mamba_leaves(cfg, p, pl)
    return mamba_train(cfg, p, h, return_state=return_state), part


def moe_aux_loss(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
                 pl) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style) for one block of the
    stream ``x`` (this rank's positions when it is split, else whole) with
    this rank's router columns: the router gathered over 'model' where the
    experts split, the two router statistics averaged over 'model' (the
    positions' shares; identity backward, as each rank's loss reads the
    average whole) and over the DP axes (the batch's shares), so the loss
    is the global batch's, as the reference's GSPMD computes it.  With no
    layout, a ``RunOptions.data_group`` (a data-parallel run, every rank
    the same count of tokens) is the DP axis."""
    from repro_torch.distributed import process_group
    if _tp_ok(pl, cfg.n_experts):
        router = process_group.gather_from_group(router, 1, pl.tp_group)
    logits = x.reshape(-1, cfg.d_model) @ router
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(F.one_hot(top1, cfg.n_experts).float(), dim=0)
    imp = torch.mean(probs, dim=0)
    both = torch.stack([frac, imp])
    over = [(a, pl.group(a)) for a in ("model", *pl.rules.dp)
            if pl.sizes.get(a, 1) > 1]
    data_group = common.get_run_options().data_group
    if pl.layout is None and data_group is not None:
        over = [("data", data_group)]
    for axis, g in over:
        n = process_group.size_of(g)
        both = (process_group.reduce_from_group(both, g) if axis == "model"
                else process_group.sum_over_group(both, g))
        both = torch.div(both, torch.full((), float(n), device=both.device))
    return cfg.n_experts * torch.sum(both[0] * both[1])


# -- decode over a cache whose sequence is split ------------------------------

def seq_split(pl, seq_axes: tuple) -> bool:
    """Are a cache's positions split over more than one rank?"""
    return any(pl.sizes[a] > 1 for a in seq_axes)


def split_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lo: int, last: int | None, window: int, pl,
                 seq_axes: tuple) -> torch.Tensor:
    """Attention of one query position over a cache whose positions are
    split over ``seq_axes`` (``sharding.cache_specs``): q (B, 1, Hq, Dh)
    every head; k, v (B, S_loc, Hkv, Dh) this rank's positions ``lo ..
    lo + S_loc - 1``; positions past ``last`` (and, with ``window``, at or
    before ``last - window``) masked.  Each rank's partial softmax (its
    max, its sum of exponentials and its PV product) is combined by two
    f32 all-reduces over each axis: a max, then the sums.  Returns the f32
    (B, 1, Hq * Dh) output, the whole cache's softmax."""
    from repro_torch.distributed import process_group
    b, _, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    s = torch.einsum("bthgd,bshd->bhgts", q.reshape(b, 1, hkv, g, dh),
                     k).float() / sqrt_f32(dh)
    kpos = lo + torch.arange(k.shape[1], device=q.device)
    if last is not None:
        mask = kpos <= last
        if window > 0:
            mask &= kpos > last - window
        s = torch.where(mask, s, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    axes = [a for a in seq_axes if pl.sizes[a] > 1]
    for a in axes:
        m = process_group.reduce_along(m, pl.group(a), "max")
    e = torch.exp(s - m)                                   # (b,h,g,1,S)
    pv = torch.einsum("bhgts,bshd->bthgd", e, v.float())   # (b,1,h,g,dh)
    both = torch.cat([pv, torch.sum(e, dim=-1).permute(0, 3, 1, 2)[
        ..., None]], dim=-1)
    for a in axes:
        both = process_group.reduce_along(both, pl.group(a))
    out = both[..., :dh] / both[..., dh:]
    return out.reshape(b, 1, hq * dh)


def _mine(out: torch.Tensor, pl, n_heads: int, dh: int) -> torch.Tensor:
    """This rank's heads' columns of an all-heads (B, 1, H * Dh) output."""
    hl = n_heads // pl.tp
    return out[..., pl.tp_rank * hl * dh:(pl.tp_rank + 1) * hl * dh]


def attention_decode_placed(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            cur_len: int, pl, seq_axes: tuple, *,
                            window: int = 0):
    """One-token decode over this rank's positions of the cache.  The new
    token's query heads (and K/V heads, where they split) are gathered over
    'model'; its K/V are written IN PLACE on the one rank whose positions
    hold ``cur_len``; ``split_attend`` combines the ranks' softmax; each
    rank's own heads' columns of the output go through its ``wo`` rows.
    Where neither the heads nor the positions split (no layout, or one
    rank on the cache's axes) it is ``attention_decode``, whose PV product
    runs in the activations' dtype as the reference's does;
    ``split_attend`` keeps its partial PV products in f32 until the ranks'
    sum.  Returns ``(out, partial)``."""
    from repro_torch.distributed import process_group
    b = x.shape[0]
    dh = cfg.head_dim
    part = _tp_ok(pl, cfg.n_heads)
    if not part and not seq_split(pl, seq_axes):
        return attention_decode(cfg, p, x, k_cache, v_cache, cur_len,
                                window=window), False
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q = _split_heads(x @ p["wq"], p["wq"].shape[-1] // dh)
    k = _split_heads(x @ p["wk"], p["wk"].shape[-1] // dh)
    v = _split_heads(x @ p["wv"], p["wv"].shape[-1] // dh)
    if cfg.rope_theta > 0:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    if part:
        q = process_group.gather_along(q, 2, pl.tp_group)
        if _tp_ok(pl, cfg.n_kv_heads):
            k = process_group.gather_along(k, 2, pl.tp_group)
            v = process_group.gather_along(v, 2, pl.tp_group)
    lo = pl.seq_index(seq_axes) * k_cache.shape[1]
    if lo <= cur_len < lo + k_cache.shape[1]:
        k_cache[:, cur_len - lo] = k[:, 0].to(k_cache.dtype)
        v_cache[:, cur_len - lo] = v[:, 0].to(v_cache.dtype)
    out = split_attend(q, k_cache, v_cache, lo, cur_len, window, pl,
                       seq_axes).to(x.dtype)
    if part:
        out = _mine(out, pl, cfg.n_heads, dh)
    return out @ p["wo"], part


def mamba_decode_placed(cfg: ModelConfig, p: dict, x: torch.Tensor,
                        conv_x_st: torch.Tensor, conv_bc_st: torch.Tensor,
                        ssm_state: torch.Tensor, pl):
    """One Mamba2 step with this rank's leaves (``mamba_leaves``) and
    states: a conv state split over its channels where the mixer needs it
    whole (``conv_bc`` always, ``conv_x`` when the mixer runs whole) is
    gathered for the step and this rank's channels kept.  Returns
    ``(out, conv_x, conv_bc, ssm, partial)``."""
    from repro_torch.distributed import process_group
    p, part = mamba_leaves(cfg, p, pl)
    split = {}
    for name, st, whole in (("x", conv_x_st, p["in_x"].shape[-1]),
                            ("bc", conv_bc_st, 2 * cfg.ssm_state)):
        split[name] = st.shape[-1] != whole
    if split["x"]:
        conv_x_st = process_group.gather_along(conv_x_st.contiguous(), 2,
                                               pl.tp_group)
    if split["bc"]:
        conv_bc_st = process_group.gather_along(conv_bc_st.contiguous(), 2,
                                                pl.tp_group)
    y, hx, hbc, st = mamba_decode(cfg, p, x, conv_x_st, conv_bc_st,
                                  ssm_state)
    if split["x"]:
        hx = pl.own(hx, 2)
    if split["bc"]:
        hbc = pl.own(hbc, 2)
    return y, hx, hbc, st, part
