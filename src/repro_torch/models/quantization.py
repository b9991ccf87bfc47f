"""Int8 weight-only quantization for serving, counterpart of
``repro/models/quantization.py``.

Decode is weight-bandwidth bound, so int8 weights halve the bytes a step
must read.  Symmetric per-output-column int8 over axis -2: ``w ~ q *
scale`` with ``scale = max(amax, 1e-8) / 127`` and ``q = round(w / scale)``
(half to even), both divisions in IEEE f32, so ``q`` and ``scale`` equal
the reference's bit for bit.

``quantize_tree`` converts every large floating-point leaf; small leaves
(norms of small models, biases, scalars) stay as they are.  The reference
dequantizes inside its jitted step, where XLA fuses the multiply into the
consuming matmul; eagerly a whole-tree dequantize would put the bf16
weights beside the int8 ones, so the port's quantized serve step
dequantizes one layer at a time (``QuantizedLeaf.layer``, through
``common.layer_slice``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantizedLeaf:
    q: torch.Tensor         # int8, original shape
    scale: torch.Tensor     # f32, amax over axis -2 kept as a size-1 axis
    dtype: torch.dtype      # original dtype

    def materialize(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.dtype)

    def layer(self, i: int) -> torch.Tensor:
        """Leading slice ``i`` dequantized: ``materialize()[i]``, element
        for element.  A 2-D leaf's scale runs over the leading axis (a
        (1, n) row), so every slice shares it."""
        scale = self.scale[i] if self.scale.shape[0] == self.q.shape[0] \
            else self.scale[0]
        return (self.q[i].float() * scale).to(self.dtype)


def _quantize(w32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if w32.dim() >= 2:
        amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    else:
        amax = torch.amax(torch.abs(w32), dim=0, keepdim=True)
    # divide by a tensor on the device: a Python divisor is applied as a
    # multiply by its reciprocal on the card, which rounds differently (and
    # filled there: a tensor copied from the host waits for the stream)
    scale = torch.clamp(amax, min=1e-8) / torch.full(
        (), 127.0, dtype=torch.float32, device=w32.device)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_leaf(w: torch.Tensor) -> QuantizedLeaf:
    """One leaf.  A leaf of 3 or more dims reduces within each leading
    slice, so it is quantized one slice at a time (one layer's f32
    transient)."""
    if w.dim() < 3:
        q, scale = _quantize(w.float())
        return QuantizedLeaf(q=q, scale=scale, dtype=w.dtype)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w.shape[0], *w.shape[1:-2], 1, w.shape[-1]),
                        dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize(w[i].float())
    return QuantizedLeaf(q=q, scale=scale, dtype=w.dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_tree(params, *, min_size: int = 4096):
    """int8-quantize every floating-point leaf with >= min_size
    elements."""
    def leaf(w):
        if (isinstance(w, torch.Tensor) and w.is_floating_point()
                and w.numel() >= min_size):
            return quantize_leaf(w)
        return w

    return _map(leaf, params)


def dequantize_tree(params):
    return _map(lambda x: x.materialize() if isinstance(x, QuantizedLeaf)
                else x, params)


def _leaves(tree) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def quantization_error(params, qparams) -> float:
    """Max relative Frobenius error across quantized leaves (sanity).  A
    leaf of 3 or more dims is measured one leading slice at a time, its
    squared norms summed, so the f32 transients are one layer's."""
    errs = []
    for w, qx in zip(_leaves(params), _leaves(qparams)):
        if isinstance(qx, QuantizedLeaf):
            pairs = (((w[i], qx.layer(i)) for i in range(w.shape[0]))
                     if w.dim() >= 3 else [(w, qx.materialize())])
            d2 = n2 = 0.0
            for wi, mi in pairs:
                wi = wi.float()
                d2 += float(torch.sum((mi.float() - wi) ** 2))
                n2 += float(torch.sum(wi * wi))
            errs.append(d2 ** 0.5 / (n2 ** 0.5 + 1e-9))
    return max(errs) if errs else 0.0
