"""Shared model machinery, counterpart of ``repro/models/common.py``: the
config dataclass, the run options, the placement rules, init, norms and
RoPE.

Models are plain functions over nested dicts of tensors:
``init(cfg, seed) -> params``, ``forward(cfg, params, batch) -> logits``.
Layer stacks keep the reference's stacked leading ``L`` axis, so params map
one to one onto the reference's pytree; the port loops over ``L`` in Python
where the reference scans.

The placement rules (``axis_ok``, ``ShardingRules``, ``make_rules``;
reference lines 238-273) resolve which axis of a layout each logical dim
takes.  A layout is an ordered mapping of axis name to size, such as
``{"pod": 2, "data": 16, "model": 16}``, or a ``topology.Groups``, where
the reference takes a ``jax.sharding.Mesh``.  ``distributed.sharding``
builds every leaf's spec from them.

The placement as a program (``RunOptions.layout``, ``placement``,
``Placed``): where the reference hands its mesh to GSPMD, which partitions
the program and pins the residual stream with ``shard_seq`` (its lines
167-190), the port runs each rank's own shard of the model under a
``topology.Groups`` (a real world) or a
``process_group.RecordingLayout`` (a program that only records its
collectives, on ``meta`` tensors).  ``Placed`` holds the rules and the
collectives of that form: tensor parallelism over 'model' (Megatron's
column / row pairs, ``models.blocks``), the residual stream
sequence-parallel between the sub-blocks (``Placed.enter`` gathers the
sequence, ``Placed.leave`` reduce-scatters a partial sum or slices a whole
value), FSDP over 'data' (``Placed.unshard`` gathers a weight before use,
its gradient reduce-scattered back) and the batch over ('pod', 'data').
With no layout, ``placed`` gives the one-rank form of it, so the models
keep one body an entry point: every collective is an identity there.

Gradients under a placement: a leaf a rank holds a shard of gets its
shard's whole gradient; a leaf every rank of the 'model' group holds whole
gets a partial on each rank, summed over the group by the train step
(``training.steps.sync_grads``), as a value every rank holds whole (the
gathered sequence, the routing logits) gets a partial gradient that the
gather's reduce-scatter sums.  The reference's ``shard_heads`` has no
caller there and no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # --- hybrid (hymba) ---
    window: int = 0                # sliding-window size; 0 = full attention
    global_every: int = 0          # every k-th layer is full-attention
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 0        # stub frontend: precomputed frame embeddings
    # --- vlm (internvl2) ---
    img_tokens: int = 0            # stub frontend: precomputed patch embeddings
    # --- misc ---
    rope_theta: float = 10000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:      # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = 0
        if self.family in ("dense", "moe", "encdec", "vlm", "hybrid"):
            per_layer += d * hq * dh + 2 * d * hkv * dh + hq * dh * d  # attn
            per_layer += 2 * d  # norms
        if self.family == "moe":
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * ff
        elif self.family in ("dense", "encdec", "vlm"):
            per_layer += 3 * d * ff
        elif self.family == "hybrid":
            per_layer += 3 * d * ff
            per_layer += self._ssm_params() + d
        if self.family == "ssm":
            per_layer += self._ssm_params() + d
        total = self.n_layers * per_layer
        total += v * d * (1 if self.tie_embeddings else 2)
        total += d  # final norm
        if self.family == "encdec":
            enc_layer = 4 * d * d + 3 * d * ff + 2 * d
            cross = 4 * d * d + d
            total += self.encoder_layers * enc_layer + self.n_layers * cross
        return total

    def _ssm_params(self) -> int:
        di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
        # in_proj -> (z, x, B, C, dt), conv on (x,B,C), out_proj, A, D, dt_bias
        return (self.d_model * (2 * di + 2 * n + h)
                + self.ssm_conv * (di + 2 * n) + di * self.d_model + 3 * h)

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense = self.n_params() - self.n_layers * self.n_experts * 3 * d * ff
        return dense + self.n_layers * self.top_k * 3 * d * ff


# ---------------------------------------------------------------------------
# run options (runtime knobs, not arch identity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunOptions:
    # Megatron-style sequence parallelism, the reference's default: under a
    # ``layout`` the residual stream is split over 'model' between the
    # sub-blocks (``Placed.seq_sharded``); the roofline's activation bytes
    # read it too (``distributed.roofline.roofline_terms``)
    seq_parallel: bool = True
    # query-chunk size of the memory-efficient attention loop
    q_chunk: int = 512
    # expert parallelism over ``model_group`` (``blocks.moe_apply_ep``):
    # each rank of the group holds n_experts / its size of the experts
    moe_ep: bool = False
    # the process group expert parallelism runs over, in the place of the
    # reference's ``mesh`` (None: every expert on this rank)
    model_group: Any = None
    # the data-parallel group of a ``--data-axis`` run: the MoE's
    # load-balance loss sums its router statistics over it, so it is the
    # global batch's, as under the reference's GSPMD
    data_group: Any = None
    # the placement the model runs under, the counterpart of the
    # reference's ``mesh``: a ``topology.Groups`` of a real world or a
    # ``process_group.RecordingLayout``; params are this rank's shards
    # under ``sharding.param_specs(cfg, layout, use_fsdp=fsdp)``.  None:
    # the whole model on this rank
    layout: Any = None
    fsdp: bool = False


_RUN_OPTIONS = RunOptions()


def set_run_options(**kw) -> RunOptions:
    for k, v in kw.items():
        if not hasattr(_RUN_OPTIONS, k):
            raise AttributeError(f"RunOptions has no option {k!r}")
        setattr(_RUN_OPTIONS, k, v)
    return _RUN_OPTIONS


def get_run_options() -> RunOptions:
    return _RUN_OPTIONS


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------
# Logical dims and the layout axis each takes where its size divides:
#   vocab, heads (q-head count), kv (kv-head count), mlp (d_ff / d_inner),
#   expert (expert count) -> 'model'; the stacked layer dim never; the
#   batch -> ('pod', 'data'); fsdp: one more weight dim over 'data'.


def axis_ok(size: int, mesh_axis_size: int) -> bool:
    return mesh_axis_size > 0 and size % mesh_axis_size == 0


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved logical -> layout-axis mapping for one (config, layout)
    pair."""
    tp: str | None            # axis of tensor parallelism ('model')
    fsdp: str | None          # axis of param / optimizer sharding ('data')
    dp: tuple[str, ...]       # batch axes, e.g. ('pod', 'data')
    tp_size: int
    fsdp_size: int

    def heads(self, n: int) -> str | None:
        return self.tp if axis_ok(n, self.tp_size) else None

    def dim(self, size: int) -> str | None:
        return self.tp if axis_ok(size, self.tp_size) else None

    def fsdp_dim(self, size: int) -> str | None:
        return self.fsdp if axis_ok(size, self.fsdp_size) else None


def layout_sizes(layout) -> dict[str, int]:
    """``{axis: size}`` in axis order, of an ordered mapping or of a
    ``topology.Groups`` (its ``axes`` and ``shape``)."""
    if hasattr(layout, "axes") and hasattr(layout, "shape"):
        return dict(zip(layout.axes, layout.shape))
    return {str(k): int(v) for k, v in dict(layout).items()}


def make_rules(layout, *, use_fsdp: bool) -> ShardingRules:
    sizes = layout_sizes(layout)
    return ShardingRules(
        tp="model" if "model" in sizes else None,
        fsdp="data" if (use_fsdp and "data" in sizes) else None,
        dp=tuple(a for a in ("pod", "data") if a in sizes),
        tp_size=sizes.get("model", 1), fsdp_size=sizes.get("data", 1),
    )


# ---------------------------------------------------------------------------
# the placement as a program
# ---------------------------------------------------------------------------

_SPECS: dict = {}


class Placed:
    """The placement ``RunOptions.layout`` sets, as the model's forms read
    it: the rules, this rank's coords, the groups, and the collectives at
    the residual stream's boundaries (``enter`` / ``leave``), of FSDP
    (``unshard``) and of the vocabulary-parallel embedding, head and
    cross-entropy (``embed``, ``head``, ``whole_logits``,
    ``cross_entropy``)."""

    def __init__(self, cfg: ModelConfig, opts: RunOptions):
        self.cfg, self.layout = cfg, opts.layout
        whole = opts.layout is None
        self.sizes = {} if whole else layout_sizes(opts.layout)
        self.coords = ({} if whole
                       else dict(zip(opts.layout.axes, opts.layout.coords)))
        self.fsdp = opts.fsdp and not whole
        self.rules = make_rules(self.sizes, use_fsdp=self.fsdp)
        self.seq_parallel = opts.seq_parallel
        self.tp = self.sizes.get("model", 1)
        self.tp_rank = self.coords.get("model", 0)

    def group(self, axis: str):
        return self.layout.group(axis)

    @property
    def tp_group(self):
        return self.layout.group("model")

    def specs(self) -> dict:
        """``sharding.param_specs`` of the config on this layout (each
        config's once)."""
        key = (self.cfg, tuple(self.sizes.items()), self.fsdp)
        if key not in _SPECS:
            from repro_torch.distributed import sharding
            _SPECS[key] = sharding.param_specs(self.cfg, self.sizes,
                                               use_fsdp=self.fsdp)
        return _SPECS[key]

    # -- the reference's shard_seq -------------------------------------------

    def seq_sharded(self, t: int) -> bool:
        """The reference's ``shard_seq`` rule for a (B, T, D) stream of T
        positions: on with ``seq_parallel`` and a 'model' axis of more
        than one rank, for T >= 2 that the axis divides."""
        return (self.seq_parallel and self.tp > 1 and t >= 2
                and t % self.tp == 0)

    def enter(self, h: torch.Tensor, sp: bool) -> torch.Tensor:
        """A sub-block's normed input, whole on every rank: the sequence
        gathered over 'model' when the stream is split (its gradient's
        partials reduce-scattered back)."""
        if not sp:
            return h
        from repro_torch.distributed import process_group
        return process_group.gather_from_group(h, 1, self.tp_group)

    def leave(self, y: torch.Tensor, sp: bool, *, partial: bool,
              dtype) -> torch.Tensor:
        """A sub-block's output as the stream holds it: a ``partial`` (a
        row-parallel product, each rank a share of the sum) reduce-scattered
        over the sequence, or all-reduced when the stream is whole; a value
        every rank holds whole sliced to this rank's positions (no
        collective) or kept."""
        from repro_torch.distributed import process_group as pg
        if self.tp > 1:
            g = self.tp_group
            if partial:
                y = (pg.scatter_to_group(y, 1, g) if sp
                     else pg.sum_over_group(y, g))
            elif sp:
                y = pg.split_to_group(y, 1, g)
        return y.to(dtype)

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice over 'model' of a whole ``t`` along ``dim``."""
        n = t.shape[dim] // self.tp
        return t.narrow(dim, self.tp_rank * n, n)

    # -- decode caches -----------------------------------------------------------

    def seq_index(self, axes: tuple) -> int:
        """This rank's shard index along ``axes``, the first outermost."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def dp_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.rules.dp)

    # -- FSDP ------------------------------------------------------------------

    def unshard(self, leaf, spec) -> torch.Tensor:
        """``leaf`` with its dims over 'data' (FSDP) gathered: this rank's
        TP shard, whole over 'data'.  ``spec`` has one entry a dim of
        ``leaf``."""
        from repro_torch.distributed import process_group
        if not self.fsdp:
            return leaf
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if "data" in axes:
                leaf = process_group.gather_from_group(
                    leaf, d, self.group("data"))
        return leaf

    def unshard_layer(self, p: dict, stack: str) -> dict:
        """One layer's leaves of ``stack`` (``layers``' views of this rank's
        shards) with their FSDP dims gathered; the caller runs it under
        ``process_group.collective_scope(stack)``."""
        if not self.fsdp:
            return p
        specs = self.specs()[stack]
        return {k: self.unshard(v, specs[k][1:]) for k, v in p.items()}

    def top(self, params: dict, key: str) -> torch.Tensor:
        """A leaf outside the stacks (``embed``, ``lm_head``, a norm),
        gathered over 'data' where FSDP splits it."""
        if not self.fsdp:
            return params[key]
        return self.unshard(params[key], self.specs()[key])

    # -- the vocabulary-parallel embedding, head and loss ---------------------

    def vocab_split(self) -> bool:
        return self.tp > 1 and self.specs()["embed"][0] == "model"

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> tuple[torch.Tensor, bool]:
        """``(rows, partial)``: the embedding of ``tokens`` from this rank's
        table.  Split over the vocabulary, each rank looks up the tokens in
        its own rows, zeros elsewhere: a partial.  Split over d_model (no
        vocabulary split), the table is gathered whole first."""
        from repro_torch.distributed import process_group
        # F.embedding's backward sums a repeated token's rows in a fixed
        # order on the card; table[tokens] backs through an atomic
        # accumulate
        if self.tp == 1:
            return F.embedding(tokens, table), False
        spec = self.specs()["embed"]
        if spec[0] == "model":
            v_loc = table.shape[0]
            lo = self.tp_rank * v_loc
            mine = (tokens >= lo) & (tokens < lo + v_loc)
            rows = F.embedding(torch.where(mine, tokens - lo, 0), table)
            return rows * mine[..., None].to(rows.dtype), True
        if spec[1] == "model":
            table = process_group.gather_from_group(table, 1, self.tp_group)
        return F.embedding(tokens, table), False

    def head(self, params: dict) -> torch.Tensor:
        """This rank's (D, V / |model|) columns of the head (the tied
        embedding's rows transposed), or the whole head."""
        from repro_torch.distributed import process_group
        if self.cfg.tie_embeddings:
            table = self.top(params, "embed")
            if self.tp > 1 and self.specs()["embed"][1] == "model":
                table = process_group.gather_from_group(table, 1,
                                                        self.tp_group)
            return table.T
        return self.top(params, "lm_head")

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Every rank's vocabulary columns gathered (no gradient)."""
        if not self.vocab_split():
            return logits
        from repro_torch.distributed import process_group
        return process_group.gather_along(logits.contiguous(),
                                          logits.dim() - 1, self.tp_group)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
        """``cross_entropy`` of the (B, T, V / |model|) logits of this
        rank's vocabulary columns (``_VocabParallelCE``), or of whole logits
        every rank of 'model' holds, its gradient counted on the group's
        first rank."""
        if self.vocab_split():
            v_loc = logits.shape[-1]
            return _VocabParallelCE.apply(logits, labels,
                                          self.tp_rank * v_loc,
                                          self.tp_group)
        loss = cross_entropy(logits, labels)
        if self.tp > 1:
            loss = _FirstRank.apply(loss, self.tp_rank)
        return loss


class _FirstRank(torch.autograd.Function):
    """Identity forward; backward keeps the gradient on the 'model'
    group's first rank and zeros it elsewhere: a value every rank computes
    whole, from leaves whose gradients the group then sums."""

    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None


class _VocabParallelCE(torch.autograd.Function):
    """Mean next-token cross-entropy over labels >= 0 of logits split over
    the vocabulary (Megatron's vocab-parallel loss): the row max
    all-reduced (max), then the sum of exponentials and the gold logit in
    one f32 all-reduce.  The loss is whole on every rank, which seeds it
    with 1; the backward gives each rank its own columns' gradient,
    ``softmax - onehot`` over the count of labels."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        from repro_torch.distributed import process_group as pg
        ctx.dtype = logits.dtype
        logits = logits.float()
        v_loc = logits.shape[-1]
        m = pg.reduce_along(torch.amax(logits, dim=-1), group, "max")
        e = torch.exp(logits - m[..., None])
        lab = labels.long()
        mine = (lab >= lo) & (lab < lo + v_loc)
        gold = torch.gather(logits, -1, torch.where(mine, lab - lo, 0)[
            ..., None])[..., 0] * mine
        both = pg.reduce_along(torch.stack([torch.sum(e, dim=-1), gold]),
                               group)
        mask = (labels >= 0).float()
        n = torch.clamp(torch.sum(mask), min=1.0)
        logz = m + torch.log(both[0])
        ctx.save_for_backward(e, both[0], lab, mine, mask, n)
        ctx.lo = lo
        return torch.sum((logz - both[1]) * mask) / n

    @staticmethod
    def backward(ctx, g):
        e, s, lab, mine, mask, n = ctx.saved_tensors
        grad = e / s[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, torch.where(mine, lab - ctx.lo, 0)[..., None],
            mine[..., None].to(grad.dtype))
        grad = (grad - onehot) * (mask * g / n)[..., None]
        return grad.to(ctx.dtype), None, None, None


def placed(cfg: ModelConfig) -> Placed:
    """The ``Placed`` view of ``RunOptions.layout`` for ``cfg``; with no
    layout, the whole model on this rank: one rank on every axis, where
    every collective of the forms is an identity and none is issued."""
    return Placed(cfg, _RUN_OPTIONS)


def placement(cfg: ModelConfig) -> Placed | None:
    """``placed(cfg)`` when a layout is set, else None."""
    return None if _RUN_OPTIONS.layout is None else placed(cfg)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., T, H, Dh), positions: (..., T)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., T, half)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE over labels >= 0, in f32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long()
                        )[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)


def make_generator(seed: int, device) -> torch.Generator | None:
    """A generator on ``device`` seeded by ``seed``; None on ``meta``,
    where init allocates shapes and draws nothing."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def init_device(device) -> torch.device:
    """``meta`` as is (shapes only), else ``device.resolve``: the card
    unless the caller asks for the CPU."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return device_lib.resolve(device)


def init_dense(gen: torch.Generator | None, shape, dtype, *,
               scale: float | None = None, device=None) -> torch.Tensor:
    """Truncated normal at +-2 sigma in f32, times ``scale`` (default
    1/sqrt(fan_in)), cast to ``dtype``.  A stacked leaf is drawn one
    leading slice at a time, so the f32 transient is one layer's.  With no
    generator (the ``meta`` device) only the shape is allocated."""
    device = gen.device if gen is not None else torch.device(device or "meta")
    out = torch.empty(shape, dtype=dtype, device=device)
    if gen is None:
        return out
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    slices = [out] if len(shape) < 3 else list(out)
    for dst in slices:
        draw = torch.empty(dst.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
        dst.copy_((draw * std).to(dtype))
    return out


def layers(blk: dict, n: int):
    """Layers 0..n-1's leaves in turn, as ``layer_slice`` gives them.  A
    stacked tensor is unbound once, so autograd's backward of its layer
    views is one ``stack``, where n separate selects would each scatter
    into a zero gradient the size of the whole stack."""
    views = {k: (v.unbind(0) if isinstance(v, torch.Tensor) else v)
             for k, v in blk.items()}
    for i in range(n):
        yield {k: (v[i] if isinstance(v, tuple) else v.layer(i))
               for k, v in views.items()}


def layer_slice(blk: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a stacked block dict.  A quantized leaf is
    dequantized here, one layer at a time (``quantization.QuantizedLeaf``
    ``.layer``), so a quantized model never holds more than one layer's
    weights at full precision."""
    return {k: (v[i] if isinstance(v, torch.Tensor) else v.layer(i))
            for k, v in blk.items()}
