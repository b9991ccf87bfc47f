"""Train, window, serve and prefill step factories, counterpart of
``repro/training/steps.py``.

  * ``make_train_step``   -- one synchronous step: the loss and its grads
    by autograd, the global-norm clip, the optimizer's update;
  * ``make_window_step``  -- one tau-step window of M replicas with the
    paper's merge protocols between them (``Merge``): eq. 3 averaging,
    eq. 8 delta merging, its top-k/error-feedback form, the one-window-
    stale eq. 9 form, or a per-step mean of the grads;
  * ``make_serve_step``   -- one decode step over the cache; with
    ``quantized=True`` over the int8 tree of
    ``models.quantization.quantize_tree``;
  * ``make_prefill_step`` -- one forward over the prompt that also fills the
    decode cache.

The reference places the replicas on a mesh axis; here they are a
leading replica dim on one card.  The placement over processes is
``distributed.sharding`` (specs), ``launch.train --data-axis`` (data
parallelism), ``models.blocks.moe_apply_ep`` (expert parallelism) and
``training.pipeline`` (GPipe stages).
"""

from __future__ import annotations

import enum
from typing import Callable

import torch

from repro_torch import comm
from repro_torch.engine import merge as merge_lib
from repro_torch.models import quantization
from repro_torch.models.api import get_api
from repro_torch.models.common import ModelConfig
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map,
                                          tree_unflatten)


class Merge(enum.Enum):
    ALLREDUCE = "allreduce"
    AVERAGE = "average"          # paper eq. (3), the scheme that does NOT scale
    DELTA = "delta"              # paper eq. (8)
    ASYNC_DELTA = "async_delta"  # paper eq. (9), pipelined-collective form
    DELTA_SPARSE = "delta_sparse"  # eq. (8) + top-k/error-feedback compression


# ---------------------------------------------------------------------------
# plain synchronous step
# ---------------------------------------------------------------------------

def loss_and_grads(loss_fn, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` of ``loss_fn(params, batch)`` by autograd, the
    grads a tree like ``params`` in each leaf's dtype (bf16 leaves get bf16
    grads, as ``jax.value_and_grad`` gives them; a leaf the loss does not
    reach gets zeros).  The caller's tensors are not marked."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def mean_over_group(loss: torch.Tensor, leaves: list, group
                    ) -> tuple[torch.Tensor, list]:
    """The group's mean of ``loss`` and of each gradient leaf, in ONE f32
    all-reduce of a flat bucket (a gloo call is a handshake of a few ms,
    so one a leaf would cost a model's leaf count of them).  ``leaves`` is
    emptied as the bucket fills, so the old gradients are freed as they
    are copied; returns the mean loss and new leaves in their own dtypes
    (none a view of the bucket)."""
    from repro_torch.distributed import process_group
    meta = [(g.shape, g.dtype) for g in leaves]
    total = sum(g.numel() for g in leaves)
    bucket = torch.empty(total + 1, dtype=torch.float32, device=loss.device)
    at = 0
    for i, (shape, _) in enumerate(meta):
        n = shape.numel()
        bucket[at:at + n].copy_(leaves[i].reshape(-1))
        leaves[i] = None
        at += n
    bucket[at].copy_(loss)
    process_group.all_reduce(bucket, "sum", group)
    bucket.div_(torch.full((), float(process_group.group_size(group)),
                           device=bucket.device))
    out, at = [], 0
    for shape, dtype in meta:
        n = shape.numel()
        out.append(bucket[at:at + n].view(shape).to(dtype, copy=True))
        at += n
    return bucket[at].clone(), out


def _spec_axes(spec) -> set:
    out: set = set()
    for entry in spec:
        if entry is not None:
            out.update(entry if isinstance(entry, tuple) else (entry,))
    return out


def sync_axes(pl, spec) -> tuple:
    """The axes a leaf's gradient under ``spec`` is summed over after the
    backward: 'model' where every rank of it holds the leaf whole (each
    has a partial), and each DP axis of more than one rank that does not
    split it (FSDP's 'data' was reduce-scattered by the backward)."""
    have = _spec_axes(spec)
    return tuple(a for a in ("model", *pl.rules.dp)
                 if pl.sizes.get(a, 1) > 1 and a not in have)


def sync_grads(pl, loss: torch.Tensor, grads: dict
               ) -> tuple[torch.Tensor, dict]:
    """The placement's gradient sync: each leaf's gradient summed over its
    ``sync_axes`` and divided by the DP size (the batch's mean), the loss
    averaged over the DP axes; one f32 bucket an axis set, all-reduced
    once over each of its axes."""
    from repro_torch.distributed import process_group, sharding
    specs = sharding.spec_leaves(pl.specs())
    leaves = tree_leaves(grads)
    dp = tuple(a for a in pl.rules.dp if pl.sizes[a] > 1)
    buckets: dict = {}
    for i, spec in enumerate(specs):
        buckets.setdefault(sync_axes(pl, spec), []).append(i)
    buckets.setdefault(dp, [])
    n_dp = float(pl.dp_size())
    out = list(leaves)
    for axes, idx in buckets.items():
        if not axes and not dp:
            continue
        parts = [leaves[i].reshape(-1).float() for i in idx]
        if axes == dp:
            parts.append(loss.reshape(1).float())
        flat = torch.cat(parts)
        for a in axes:
            flat = process_group.reduce_along(flat, pl.group(a))
        if dp:
            flat = flat / n_dp
        at = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[at:at + n].view(leaves[i].shape).to(leaves[i].dtype)
            at += n
        if axes == dp:
            loss = flat[at].clone()
    return loss, tree_unflatten(grads, out)


def placed_global_norm(pl, grads: dict) -> torch.Tensor:
    """``global_norm`` of synced gradient shards: each leaf's f32 sum of
    squares over the ranks of 'model' and 'data' that hold it whole,
    summed over both groups (two f32 scalar all-reduces)."""
    from repro_torch.distributed import process_group, sharding
    total = None
    for g, spec in zip(tree_leaves(grads), sharding.spec_leaves(pl.specs())):
        have = _spec_axes(spec)
        rep = 1
        for a in ("model", "data"):
            if a not in have:
                rep *= pl.sizes.get(a, 1)
        sq = torch.sum(torch.square(g.float())) / rep
        total = sq if total is None else total + sq
    for a in ("model", "data"):
        if pl.sizes.get(a, 1) > 1:
            total = process_group.reduce_along(total, pl.group(a))
    return torch.sqrt(total)


def clip_placed(pl, grads: dict, max_norm: float):
    """``clip_by_global_norm`` of synced gradient shards."""
    norm = placed_global_norm(pl, grads)
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    scale = torch.minimum(one, max_norm / (norm + 1e-9))
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    *, clip: float = 1.0, donate: bool = False,
                    data_group=None) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``, the
    metrics device tensors (nothing waits on the host).  With ``donate``
    the step writes the new params and moments into ``state``'s tensors,
    as the reference's launcher donates its state to the jitted step
    (``optim.optimizers``: 12 B a bf16 parameter, not 22).

    With ``data_group`` (data parallelism: every rank the same state,
    ``batch`` its rows of the global batch) the loss and the grads are
    averaged over the group (``mean_over_group``) before the clip, so the
    clip and the update run identically on every rank, as the reference's
    GSPMD averages the grads over its 'data' axis.

    Under a placement (``RunOptions.layout``: ``state`` holds this rank's
    shards of the params and moments, ``batch`` its rows) the grads are
    synced by ``sync_grads`` and clipped by ``clip_placed``, and the
    optimizer updates the local shards (``sharding.opt_specs_like``)."""
    from repro_torch.models import common
    api = get_api(cfg)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads = loss_and_grads(api.loss_fn, state["params"], batch)
        pl = common.placement(cfg)
        if pl is not None:
            loss, grads = sync_grads(pl, loss, grads)
            grads, gnorm = clip_placed(pl, grads, clip)
            params, opt_state = optimizer.update(
                grads, state["opt_state"], state["params"], donate=donate)
            return ({"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1},
                    {"loss": loss, "grad_norm": gnorm})
        if data_group is not None:
            leaves = tree_leaves(grads)
            del grads
            loss, leaves = mean_over_group(loss, leaves, data_group)
            grads = tree_unflatten(state["params"], leaves)
        grads, gnorm = clip_by_global_norm(grads, clip)
        params, opt_state = optimizer.update(
            grads, state["opt_state"], state["params"], donate=donate)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, seed: int = 0,
                     *, device=None) -> dict:
    """Params from ``seed`` on ``device`` (the card unless the caller asks
    for the CPU), the optimizer's state and a 0-d int32 ``step``."""
    params = get_api(cfg).init(seed, device=device)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# paper-scheme window step
# ---------------------------------------------------------------------------

def _transport(transport, compress_frac: float) -> comm.Transport:
    if transport == "sparse":
        # the string picks up the step's compression knob; an instance
        # keeps its own frac (SparseDeltaMerge refuses a conflicting pair)
        return comm.get_transport("sparse", frac=compress_frac)
    return comm.get_transport(transport if transport is not None else "xla")


def replica(state, i: int):
    """Replica i's copy of a window-step state (or of any tree of stacked
    leaves): every leaf's row i, as views.  Replica 0's is what the
    reference's state reads as on the host."""
    return tree_unflatten(state, [x[i] for x in tree_leaves(state)])


def _expanded(tree, m: int):
    """Every leaf of ``tree`` held once and seen by m replicas: expanded
    over a new leading dimension (stride 0, no copy)."""
    return tree_unflatten(tree, [x.expand(m, *x.shape)
                                 for x in tree_leaves(tree)])


def _shared(x: torch.Tensor) -> torch.Tensor:
    """A stacked leaf as its one row when the replicas share it (stride 0
    over the replica dimension), else as it is."""
    return x[0] if x.stride(0) == 0 else x


def _all_shared(*trees) -> bool:
    return all(x.stride(0) == 0 for t in trees for x in tree_leaves(t))


def _alloc(leaves: list, m: int) -> tuple:
    """Empty (m, ...) buffers, one a leaf, for the replicas' rows."""
    return tuple(torch.empty((m, *x.shape), dtype=x.dtype, device=x.device)
                 for x in leaves)


def make_window_step(cfg: ModelConfig, optimizer: Optimizer, *,
                     workers: int, tau: int, merge: Merge,
                     clip: float = 1.0, compress_frac: float = 0.01,
                     transport: "comm.Transport | str | None" = None
                     ) -> Callable:
    """``window_step(state, batches) -> (state, {"loss"})``: one window of
    ``tau`` local steps on each of ``workers`` replicas, then ``merge``.

    ``batches``: leaves of shape (tau, B, ...); replica i takes rows
    ``[i * B / M, (i + 1) * B / M)`` of each, the split the reference's
    ``P(None, "pod")`` gives.  The replicas run one after another; the
    merge reduces their stacked (M, ...) leaves through the
    ``engine.merge`` strategies over ``transport`` (a ``comm`` name or
    instance, dense by default), whose log holds one record a collective
    of the window (the log is marked at each window's start):

      * ALLREDUCE: each step's grads are averaged over the replicas before
        the clip and the update (one record, ``calls`` tau);
      * AVERAGE / DELTA: the params through ``AverageMerge`` /
        ``DeltaMerge``, then ``opt_state`` averaged over the replicas (the
        int32 ``count`` passes through: non-floating);
      * DELTA_SPARSE: ``SparseDeltaMerge`` (over ``transport`` when it is
        a ``SparseTransport``, else a sparse transport at
        ``compress_frac``), the residuals in ``state["residual"]``;
      * ASYNC_DELTA: ``AsyncDeltaMerge``, last window's deltas in
        ``state["delta_prev"]`` (``{"own", "comm"}`` over a stateful
        transport).

    ``state`` holds every replica's copy, as the reference's devices hold
    theirs: each leaf of ``{"params", "opt_state", "step"}`` and of the
    merge's ``"delta_prev"`` or ``"residual"`` has a leading (M,) replica
    dimension, and a leaf the replicas share is held once, expanded over
    that dimension (stride 0; ``init_window_state`` starts so).  The state
    returned is the same: shared where the merge makes it so (the merged
    params under every merge but ASYNC_DELTA, the averaged ``opt_state``
    under AVERAGE and DELTA, every leaf under ALLREDUCE from a shared
    start), each replica's own elsewhere.  The reference returns its state
    with ``out_specs=P()`` under ``check_vma=False``: each device keeps its
    own replica's leaves and the next window starts from them, as here,
    while a read on the host (or a checkpoint) sees device 0's, here
    ``replica(state, 0)``.  ``loss`` is replica 0's mean over its tau
    steps, the host's read of the reference's."""
    if tau < 1 or workers < 1:
        raise ValueError(f"need tau >= 1 and workers >= 1, got tau={tau}, "
                         f"workers={workers}")
    api = get_api(cfg)
    tsp = _transport(transport, compress_frac)
    if tsp.stateful and merge is Merge.DELTA:
        raise ValueError(
            "Merge.DELTA over a stateful transport would drop the "
            "error-feedback residual every window (the window step only "
            "carries residual state for DELTA_SPARSE); use "
            "Merge.DELTA_SPARSE instead")
    strategy = make_strategy(merge, tsp, compress_frac)
    local = make_train_step(cfg, optimizer, clip=clip)
    m = workers

    def rows(batches: dict, s: int, i: int) -> dict:
        b = next(iter(batches.values())).shape[1] // m
        return {k: v[s, i * b:(i + 1) * b] for k, v in batches.items()}

    def allreduce_window(state, batches):
        params, opt_state, losses = state["params"], state["opt_state"], []
        for s in range(tau):
            grads = None
            for i in range(m):
                loss, g = loss_and_grads(api.loss_fn, replica(params, i),
                                         rows(batches, s, i))
                g = tree_leaves(g)
                grads = _alloc(g, m) if grads is None else grads
                for dst, x in zip(grads, g):
                    dst[i].copy_(x)
                if i == 0:
                    losses.append(loss)
            mean, _ = tsp.all_reduce(grads, op="mean")
            del grads
            # replicas that share their params and moments take one update
            n = 1 if _all_shared(params, opt_state) else m
            outs = []
            for i in range(n):
                g, _ = clip_by_global_norm(
                    tree_unflatten(state["params"], mean), clip)
                outs.append(optimizer.update(g, replica(opt_state, i),
                                             replica(params, i)))
            if n == 1:
                params, opt_state = (_expanded(t, m) for t in outs[0])
            else:
                params, opt_state = (tree_unflatten(like, [
                    torch.stack(xs) for xs in zip(*(
                        tree_leaves(o[j]) for o in outs))])
                    for j, like in enumerate((params, opt_state)))
        return params, opt_state, losses

    def replicas(state, batches):
        """Each replica's tau steps in turn: (the stacked local params, the
        stacked local opt_states, replica 0's losses)."""
        w_local = opt_local = None
        losses = []
        for i in range(m):
            inner = replica({k: state[k] for k in ("params", "opt_state",
                                                   "step")}, i)
            for s in range(tau):
                inner, metrics = local(inner, rows(batches, s, i))
                if i == 0:
                    losses.append(metrics["loss"])
            p = tree_leaves(inner["params"])
            o = tree_leaves(inner["opt_state"])
            if w_local is None:
                w_local, opt_local = _alloc(p, m), _alloc(o, m)
            for dst, x in zip(w_local + opt_local, p + o):
                dst[i].copy_(x)
        return w_local, opt_local, losses

    def window_step(state: dict, batches: dict) -> tuple[dict, dict]:
        b = next(iter(batches.values())).shape[1]
        if b % m:
            raise ValueError(f"the batch of {b} rows does not split over "
                             f"{m} replicas")
        tsp.log.mark()
        out = dict(state)
        out["step"] = state["step"] + tau
        if merge is Merge.ALLREDUCE:
            out["params"], out["opt_state"], losses = allreduce_window(
                state, batches)
            return out, {"loss": torch.mean(torch.stack(losses))}
        w_local, opt_local, losses = replicas(state, batches)
        out.update(merge_phase(merge, strategy, tsp, state, w_local,
                               opt_local, m))
        return out, {"loss": torch.mean(torch.stack(losses))}

    return window_step


def make_strategy(merge: Merge, tsp: comm.Transport,
                  compress_frac: float = 0.01):
    """The ``engine.merge`` strategy of ``merge`` over ``tsp`` (None for
    ALLREDUCE, whose mean runs in the steps)."""
    sparse = isinstance(tsp, comm.SparseTransport)
    return {
        Merge.ALLREDUCE: lambda: None,
        Merge.AVERAGE: lambda: merge_lib.AverageMerge(tsp),
        Merge.DELTA: lambda: merge_lib.DeltaMerge(tsp),
        Merge.ASYNC_DELTA: lambda: merge_lib.AsyncDeltaMerge(tsp),
        Merge.DELTA_SPARSE: lambda: merge_lib.SparseDeltaMerge(
            tsp if sparse else None,
            frac=None if sparse else compress_frac),
    }[merge]()


def _carry_in(carry):
    """A merge carry as the strategy takes it: tuples of stacked leaves,
    ``{"own", "comm"}`` of two for a stateful ASYNC_DELTA."""
    if isinstance(carry, dict) and set(carry) == {"own", "comm"}:
        return {k: tuple(tree_leaves(v)) for k, v in carry.items()}
    return tuple(tree_leaves(carry))


def _carry_out(like, carry):
    if isinstance(like, dict) and set(like) == {"own", "comm"}:
        return {k: tree_unflatten(like[k], carry[k]) for k in like}
    return tree_unflatten(like, carry)


def merge_phase(merge: Merge, strategy, tsp: comm.Transport, state: dict,
                w_local: tuple, opt_local: tuple, m: int) -> dict:
    """A window's merge (every merge but ALLREDUCE): the params through
    ``strategy``, the moments averaged over the replicas (AVERAGE, DELTA)
    or kept with the merge's carry (DELTA_SPARSE's residual, ASYNC_DELTA's
    last deltas).  Returns the state's new ``params``, ``opt_state`` and
    carry; the dry run lowers it on ``meta`` leaves for its records."""
    out: dict = {}
    w0 = tuple(_shared(x) for x in tree_leaves(state["params"]))
    if merge in (Merge.AVERAGE, Merge.DELTA):
        merged, _ = strategy(w0, w_local)
        # consensus moments keep the replicas exchangeable
        opt_mean, _ = tsp.all_reduce(opt_local, op="mean")
        out["opt_state"] = _expanded(
            tree_unflatten(state["opt_state"], opt_mean), m)
    else:
        out["opt_state"] = tree_unflatten(state["opt_state"], opt_local)
        key = "residual" if merge is Merge.DELTA_SPARSE else "delta_prev"
        merged, carry = strategy(w0, w_local, _carry_in(state[key]))
        out[key] = _carry_out(state[key], carry)
    # a merge of a shared start is shared (one row); eq. 9's is not
    out["params"] = tree_unflatten(state["params"], [
        x if x.dim() == like.dim() else x.expand(m, *x.shape)
        for x, like in zip(merged, tree_leaves(state["params"]))])
    return out


def init_window_state(cfg: ModelConfig, optimizer: Optimizer, seed: int,
                      merge: Merge,
                      transport: "comm.Transport | str | None" = None, *,
                      workers: int, device=None) -> dict:
    """The window step's state for ``workers`` replicas that share one
    start: ``init_train_state``'s, plus ASYNC_DELTA's ``delta_prev`` (f32
    zeros like the params; ``{"own", "comm"}`` of two such trees over a
    stateful ``transport``, which must match the one given to
    ``make_window_step``) or DELTA_SPARSE's f32 ``residual``, every leaf
    held once and expanded over a leading (workers,) dimension."""
    state = init_train_state(cfg, optimizer, seed, device=device)

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        state["params"])

    if merge is Merge.ASYNC_DELTA:
        stateful = (transport is not None
                    and comm.get_transport(transport).stateful)
        state["delta_prev"] = ({"own": zeros(), "comm": zeros()}
                               if stateful else zeros())
    if merge is Merge.DELTA_SPARSE:
        state["residual"] = zeros()
    return _expanded(state, workers)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def make_serve_step(cfg: ModelConfig, *, quantized: bool = False
                    ) -> Callable:
    """Decode step ``(params, cache, tokens) -> (logits, cache)``.

    With ``quantized=True`` the params argument is the int8 tree.  The
    reference dequantizes the whole tree inside its jitted step, where XLA
    fuses the multiply into the matmuls.  Here the embedding, head and
    norms outside the layer stacks are dequantized whole at each step, and
    each layer's leaves as the layer loop reaches them
    (``QuantizedLeaf.layer``): the same function, with one layer's weights
    at full precision at a time."""
    api = get_api(cfg)

    def serve_step(params: dict, cache: dict, tokens: torch.Tensor):
        if quantized:
            params = {k: (v if k in _STACKS
                          else quantization.dequantize_tree(v))
                      for k, v in params.items()}
        return api.decode_step(params, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, max_len: int | None = None
                      ) -> Callable:
    """Prefill = one forward over the prompt that ALSO fills the decode
    cache (per-layer K/V at [0, T); SSM conv tails + final state).
    Returns (last-position logits, cache ready for decode at cur_len=T)."""
    api = get_api(cfg)

    def prefill_step(params: dict, batch: dict):
        t = batch["tokens"].shape[1]
        return api.prefill(params, batch, max_len or t)

    return prefill_step
