"""AdamW and SGD(+momentum) as pure tree transforms, with the cosine and
Robbins-Monro schedules, counterpart of ``repro/optim/optimizers.py``.

Trees are nested dicts of tensors (the models' params), walked with dict
keys sorted, as the reference flattens them.  The formulas are the
reference's, in plain tensor ops:

  * moments are f32 beside params of any dtype, and the update runs in f32
    and casts back to the param's dtype; AdamW decays the weights inside
    the step (``step + weight_decay * p``), not before it;
  * ``count`` is a 0-d int32 tensor on the params' device and the
    schedules compute ``lr_t`` from it there in f32, so a step never
    waits on the host;
  * every division by a constant divides by a tensor on the operand's
    device: on the card ``tensor / python_float`` rounds as a multiply by
    the reciprocal, and ``python_float / tensor`` does everywhere;
  * a stacked leaf (3 or more dims: the layer stacks' leading ``L`` axis)
    is updated one leading slice at a time, and another leaf past
    ``CHUNK`` entries (an embedding) a block of rows at a time: the same
    elementwise function, its f32 transients one slice's;
  * ``update(..., donate=True)`` writes the new params and moments into
    the given tensors and returns them, as the reference's launcher
    donates its state to the jitted step: the step then holds 12 B a bf16
    parameter (weights, grads, two f32 moments) and one slice's
    transients, where the functional update holds the old and the new
    moments and weights at once (22 B).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

_F32 = torch.float32


class AdamState(NamedTuple):
    mu: Any        # first moment, f32, param-shaped
    nu: Any        # second moment, f32, param-shaped
    count: torch.Tensor


class SGDState(NamedTuple):
    momentum: Any
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, *, donate=False) -> (params, state)
    update: Callable[..., tuple[Any, Any]]


def tree_map(f, tree, *rest):
    """``f`` over the leaves of nested dicts (``rest`` shaped like
    ``tree``); the result keeps ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in tree}
    return f(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and tuples in the reference's flatten
    order (dict keys sorted); ``None`` holds none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure (nested dicts, tuples, named tuples, ``None``)
    with its leaves replaced, in ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple):
            items = [build(item) for item in t]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as an f32 0-d tensor on like's device."""
    return torch.full((), v, dtype=_F32, device=like.device)


#: Entries of a leaf updated at once, past which a leaf that is not
#: stacked is updated a block of rows at a time.
CHUNK = 1 << 26


def _blocks(leaf: torch.Tensor) -> list[slice]:
    """The leading-dimension blocks a leaf is updated in: one layer of a
    stacked leaf, up to ``CHUNK`` entries of rows of another, or the
    whole leaf."""
    if leaf.dim() < 3 and leaf.numel() <= CHUNK:
        return [slice(None)]
    step = 1 if leaf.dim() >= 3 else max(1, CHUNK // leaf[0].numel())
    return [slice(i, i + step) for i in range(0, leaf.shape[0], step)]


def _sliced(fn, *leaves, out=None) -> tuple[torch.Tensor, ...]:
    """``fn(*leaves)``, a tuple of tensors shaped like ``leaves[0]``,
    computed block by block (``_blocks``) into ``out`` (in place: a block
    is read whole before it is written) or into new tensors."""
    blocks = _blocks(leaves[0])
    if len(blocks) == 1:
        got = fn(*leaves)
        if out is None:
            return got
        for dst, g in zip(out, got):
            dst.copy_(g)
        return out
    for blk in blocks:
        got = fn(*(leaf[blk] for leaf in leaves))
        if out is None:
            out = tuple(torch.empty(leaves[0].shape, dtype=g.dtype,
                                    device=g.device) for g in got)
        for dst, g in zip(out, got):
            dst[blk].copy_(g)
    return out


def _unzip(outs, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda o: o[j], outs) for j in range(n))


def _lr_fn(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda count: _const(lr, count)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=_F32, device=p.device)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float, *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return AdamState(mu=tree_map(_zeros_f32, params),
                         nu=tree_map(_zeros_f32, params),
                         count=_count(params))

    def update(grads, state, params, *, donate: bool = False):
        c = state.count + 1
        lr_t = lr_fn(c)
        cf = c.to(_F32)
        bc1 = 1 - torch.pow(_const(b1, cf), cf)
        bc2 = 1 - torch.pow(_const(b2, cf), cf)
        eps_t = _const(eps, cf)

        def leaf(p, g, m, v):
            g = g.to(_F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps_t)
            step = step + weight_decay * p.to(_F32)
            return (p.to(_F32) - lr_t * step).to(p.dtype), m, v

        new_params, mu, nu = _unzip(tree_map(
            lambda p, g, m, v: _sliced(leaf, p, g, m, v,
                                       out=(p, m, v) if donate else None),
            params, grads, state.mu, state.nu), 3)
        return new_params, AdamState(mu=mu, nu=nu, count=c)

    return Optimizer(init=init, update=update)


def sgd(lr: Callable[[torch.Tensor], torch.Tensor] | float, *,
        momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        mom = tree_map(_zeros_f32, params) if momentum else None
        return SGDState(momentum=mom, count=_count(params))

    def update(grads, state, params, *, donate: bool = False):
        c = state.count + 1
        lr_t = lr_fn(c)

        def apply(p, s):
            return ((p.to(_F32) - lr_t * s).to(p.dtype),)

        if momentum:
            def leaf(p, g, m):
                m = momentum * m + g.to(_F32)
                return apply(p, m)[0], m

            new_params, mom = _unzip(tree_map(
                lambda p, g, m: _sliced(leaf, p, g, m,
                                        out=(p, m) if donate else None),
                params, grads, state.momentum), 2)
        else:
            mom = None
            (new_params,) = _unzip(tree_map(
                lambda p, g: _sliced(lambda p_, g_: apply(p_, g_.to(_F32)),
                                     p, g, out=(p,) if donate else None),
                params, grads), 1)
        return new_params, SGDState(momentum=mom, count=c)

    return Optimizer(init=init, update=update)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def cosine_schedule(peak: float, *, warmup: int = 100,
                    total: int = 10000, floor: float = 0.1):
    def fn(count):
        c = count.to(_F32)
        warm = peak * c / _const(max(warmup, 1), c)
        prog = torch.clip((c - warmup) / _const(max(total - warmup, 1), c),
                          0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)
    return fn


def rm_schedule(eps0: float = 0.5, decay: float = 1.0):
    """The paper's Robbins-Monro step sequence eps_t = eps0 / (1 + decay*t)."""
    def fn(count):
        c = count.to(_F32)
        return _const(eps0, c) / (1.0 + decay * c)
    return fn


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves, in flatten order, of each leaf's f32
    sum of squares."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(_F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``; the scale is
    cast to each grad's dtype before the product, as in the reference."""
    norm = global_norm(grads)
    scale = torch.minimum(_const(1.0, norm),
                          _const(max_norm, norm) / (norm + 1e-9))
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
