"""GPipe pipeline parallelism over the ``pod`` axis, counterpart of
``repro/training/pipeline.py``.

The layer stack is split into S = |pod| stages: stage s holds layers
[s*L/S, (s+1)*L/S), its slice of the stacked block leaves under
``P("pod", ...)`` (``stage_param_specs``, ``stage_params``), one stage a
rank of the ``pod`` process group.

Schedule, the reference's fill-drain: ``n_micro + S - 1`` ticks; at each
tick stage 0 takes a fresh microbatch and every other stage its left
neighbour's output of the tick before, runs its layers, and hands its
output on.  A stage idles on the ticks where no microbatch is at it (the
reference runs them on garbage that never reaches the loss).  The hand-off
is an ``all_gather`` over the pod group: gloo's send/recv aborts on a CUDA
tensor, so the point-to-point hop is a collective here.

Autograd runs through ``_GPipe``, one ``torch.autograd.Function`` around
the whole schedule: its forward keeps each tick's stage input and nothing
else (the reference remats every layer, ``nothing_saveable``); its
backward walks the ticks in reverse, recomputes the stage, and returns
each input's cotangent to the previous stage by the reverse hand-off.  The
replicated leaves (embedding, final norm, head) enter through one
``_Replicated`` node whose backward sums their gradient over the stages,
one call a dtype, so every rank holds their whole gradient.  The loss is
the last stage's cross-entropy, selected by a masked sum over the stages
through the comm layer's dense transport with tag ``"eval"`` (reference
lines 150-153), whose backward is the identity: every rank's loss is the
same number and each stage's share of it is its own.

Every collective runs in the same order on every rank: the ticks' in the
forward, then the reverse ticks' and the replicated leaves' in the
backward.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import comm
from repro_torch.distributed import process_group
from repro_torch.distributed.sharding import P, local_shard
from repro_torch.models import common, transformer
from repro_torch.models.common import ModelConfig, rms_norm


def stage_param_specs(cfg: ModelConfig, base_specs: dict) -> dict:
    """PP layout: each block leaf takes 'pod' on its leading (layer) dim.
    The reference assigns ``out["blocks"]`` twice (lines 38-53); the second
    assignment, the leading entry replaced by 'pod', is the one that
    counts."""
    out = dict(base_specs)
    out["blocks"] = {name: P("pod", *tuple(spec)[1:])
                     for name, spec in base_specs["blocks"].items()}
    return out


def stage_params(params: dict, groups) -> dict:
    """``params`` with the block leaves cut to this rank's stage: its
    ``local_shard`` under ``P("pod", None, ...)``."""
    sizes = {"pod": groups.size("pod")}
    coords = {"pod": groups.index("pod")}
    blk = {name: local_shard(leaf, P("pod", *([None] * (leaf.dim() - 1))),
                             sizes, coords)
           for name, leaf in params["blocks"].items()}
    return {**params, "blocks": blk}


class _Replicated(torch.autograd.Function):
    """Identity forward on the replicated leaves; backward sums their
    gradients over the pod group, one flat bucket a dtype, in the leaves'
    own dtype (as autograd accumulates a leaf's gradient in its dtype; an
    untied dense model's embedding has its gradient on stage 0 only and
    its head on the last stage only, so each sum adds zeros)."""

    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype) for x in leaves]
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        like = [torch.zeros(s, dtype=d, device=grads[0].device)
                if g is None else g for g, (s, d) in zip(grads, ctx.meta)]
        out = list(like)
        for dtype in sorted({d for _, d in ctx.meta}, key=str):
            idx = [i for i, (_, d) in enumerate(ctx.meta) if d == dtype]
            flat = torch.cat([like[i].reshape(-1) for i in idx])
            process_group.all_reduce(flat, "sum", ctx.group)
            at = 0
            for i in idx:
                n = like[i].numel()
                out[i] = flat[at:at + n].view(like[i].shape)
                at += n
        return (None, *out)


class _EvalSum(torch.autograd.Function):
    """The masked sum of the stages' losses through ``transport`` (tag
    ``"eval"``); identity backward."""

    @staticmethod
    def forward(ctx, x, transport):
        out, _ = transport.all_reduce(x.reshape(1), tag="eval")
        return out.reshape(())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Schedule:
    """One pipeline's fixed parts: the stage's layers and the hand-off."""

    def __init__(self, cfg: ModelConfig, names: tuple, groups, n_micro: int):
        self.cfg = cfg
        self.names = names
        self.group = groups.group("pod")
        self.stages = groups.size("pod")
        self.stage = groups.index("pod")
        self.n_micro = n_micro
        self.n_ticks = n_micro + self.stages - 1

    def valid(self, tick: int) -> bool:
        """Is a microbatch at this stage at ``tick``?"""
        return 0 <= tick - self.stage < self.n_micro

    def run(self, leaves, x: torch.Tensor) -> torch.Tensor:
        blk = dict(zip(self.names, leaves))
        n = blk[self.names[0]].shape[0]
        for p in common.layers(blk, n):
            x = transformer.block_apply(self.cfg, p, x)
        return x

    def hand_off(self, y: torch.Tensor, step: int) -> torch.Tensor:
        """Every stage's ``y`` gathered; this stage takes that of the stage
        ``step`` before it (1: the forward's left neighbour, -1: the
        backward's right one)."""
        got = process_group.all_gather(y, self.group)
        return got[(self.stage - step) % self.stages]


class _GPipe(torch.autograd.Function):
    """The fill-drain schedule over the microbatches ``micro`` (n_micro,
    mb, T, D); returns the last stage's outputs in microbatch order (zeros
    on the other stages)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, micro, *leaves):
        s = sched.stage
        recv = torch.zeros_like(micro[0])
        outs = torch.zeros_like(micro)
        inputs = {}
        for i in range(sched.n_ticks):
            if sched.valid(i):
                x_in = micro[i] if s == 0 else recv
                inputs[i] = x_in
                y = sched.run(leaves, x_in)
                if s == sched.stages - 1:
                    outs[i - s] = y
            else:
                y = torch.zeros_like(recv)
            if i < sched.n_ticks - 1:
                recv = sched.hand_off(y, 1)
        ctx.sched = sched
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        sched = ctx.sched
        s = sched.stage
        leaves = ctx.saved_tensors
        acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for x in leaves]
        g_micro = torch.zeros_like(g_outs)
        g_next = torch.zeros_like(g_outs[0])   # cotangent of y from s + 1
        for i in reversed(range(sched.n_ticks)):
            g_in = torch.zeros_like(g_outs[0])
            if sched.valid(i):
                g_y = g_next
                if s == sched.stages - 1:
                    g_y = g_y + g_outs[i - s]
                live = [x.detach().requires_grad_() for x in leaves]
                x_in = ctx.inputs[i].detach().requires_grad_()
                with torch.enable_grad():
                    y = sched.run(live, x_in)
                    got = torch.autograd.grad(y, [x_in, *live], g_y)
                for a, g in zip(acc, got[1:]):
                    a += g
                if s == 0:
                    g_micro[i] = got[0]
                else:
                    g_in = got[0]
            if i > 0:
                g_next = sched.hand_off(g_in, -1)
        return (None, g_micro,
                *(a.to(x.dtype) for a, x in zip(acc, leaves)))


def make_pp_loss_fn(cfg: ModelConfig, groups, *, n_micro: int) -> Callable:
    """The pipelined loss of the dense decoder family over ``groups``'
    ``pod`` group, counterpart of the reference's ``make_pp_loss_fn``.

    ``loss(params, batch)``: params as ``stage_params`` leaves them (this
    stage's layers, the replicated leaves whole), batch ``{"tokens",
    "labels"}`` whole on every rank; returns the loss on every rank.  The
    function's ``transport`` logs the loss's masked sum."""
    if cfg.family != "dense":
        raise ValueError("the pipeline covers the dense family")
    stages = groups.size("pod")
    if cfg.n_layers % stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{stages} stages")
    group = groups.group("pod")
    last = groups.index("pod") == stages - 1
    transport = comm.XlaTransport(group=group)

    def loss(params: dict, batch: dict) -> torch.Tensor:
        blk = params["blocks"]
        names = tuple(sorted(blk))
        if blk[names[0]].shape[0] != cfg.n_layers // stages:
            raise ValueError("params hold the whole stack; cut them to this "
                             "stage with stage_params")
        repl = ["embed", "final_norm"] + (
            [] if cfg.tie_embeddings else ["lm_head"])
        got = dict(zip(repl, _Replicated.apply(group,
                                               *(params[k] for k in repl))))
        tokens, labels = batch["tokens"], batch["labels"]
        b, t = tokens.shape
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             f"microbatches")
        x_all = F.embedding(tokens, got["embed"])
        micro = x_all.reshape(n_micro, b // n_micro, t, -1)
        sched = _Schedule(cfg, names, groups, n_micro)
        outs = _GPipe.apply(sched, micro, *(blk[k] for k in names))
        x = rms_norm(outs.reshape(b, t, -1), got["final_norm"], cfg.norm_eps)
        head = got["embed"].T if cfg.tie_embeddings else got["lm_head"]
        ce = common.cross_entropy((x @ head).float(), labels)
        return _EvalSum.apply(ce if last else ce * 0.0, transport)

    loss.transport = transport
    return loss
