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
builds every leaf's spec from them.  The reference's ``shard_heads`` and
``shard_seq`` (lines 138-193) are GSPMD layout hints on activations inside
a replica and change no value; the port's three process forms (data
parallelism, expert parallelism over ``RunOptions.model_group``, the
pipeline over ``pod``) split no activation inside a replica, so they have
no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

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
    # Megatron-style sequence parallelism, the reference's default: the
    # residual stream split over 'model' between blocks.  The port splits no
    # activation inside a replica; the roofline's activation bytes read it
    # (``distributed.roofline.roofline_terms``)
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
