"""Merge strategies, the paper's reducing phases.  Counterpart of
``repro/engine/merge.py`` for the sync strategies: averaging, delta, sparse
delta, the straggler-tolerant quorum merge and the divergence-triggered
dynamic merge.

A strategy is ``(merged, state) = strategy(w0, w_local, state=None)``:
``w0`` is the window's shared starting codebook (kappa, d), ``w_local`` the
workers' codebooks after tau local steps, stacked (M, kappa, d).  The LM
window step (``training.steps.make_window_step``) calls the same
strategies on tuples: ``w0`` a tuple of the parameter leaves (one copy
the replicas share, or stacked (M, ...) where they start apart),
``w_local`` the same leaves stacked (M, ...), one collective over all of
them, as the reference reduces a pytree.  The
strategy decides what to reduce; its ``Transport`` reduces over the worker
dimension and accounts the bytes.  ``state`` threads the strategy's own
state (the quorum and dynamic merges' per-worker carry) and the transport's
(the sparse transport's per-worker residual), ``{"own": ..., "comm": ...}``
when both are present: a ``stateful`` strategy is seeded with
``init_state(w_local)`` and fed its state back every window.
"""

from __future__ import annotations

import math

import torch

from repro_torch import comm
from repro_torch.distributed.elastic import staleness_scale


def _leafwise(fn, a, b):
    """``fn`` on two tensors, or leaf by leaf on two tuples of them."""
    if isinstance(a, tuple):
        return tuple(fn(x, y) for x, y in zip(a, b, strict=True))
    return fn(a, b)


def tree_sub_f32(a, b):
    """``a - b`` in f32 (the displacement Delta of paper eq. 7), leaf by
    leaf for tuples."""
    return _leafwise(
        lambda x, y: x.to(torch.float32) - y.to(torch.float32), a, b)


def tree_apply_delta(base, delta):
    """``base - delta`` with the subtraction in f32, result in base dtype,
    leaf by leaf for tuples."""
    return _leafwise(
        lambda p, d: (p.to(torch.float32) - d).to(p.dtype), base, delta)


def _zeros_f32(x):
    """f32 zeros shaped like x (a tensor or a tuple of them)."""
    return _leafwise(lambda t, _: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), x, x)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar on like's device (filled there, no host copy), so the
    product with it is an f32 multiply, as the reference's."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _per_worker(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """v (M,) shaped to broadcast over x (M, ...)."""
    return v.view(x.shape[0], *(1,) * (x.dim() - 1))


class MergeStrategy:
    """Base strategy over a ``repro_torch.comm`` transport (default: dense)."""

    name = "base"
    own_state = False  # strategy-owned state, beside the transport's

    def __init__(self, transport: comm.Transport | None = None):
        self.transport = (transport if transport is not None
                          else comm.get_transport("xla"))

    @property
    def stateful(self) -> bool:
        return self.own_state or self.transport.stateful

    def _init_own_state(self, w_local: torch.Tensor):
        return None

    def _init_comm_state(self, w_local: torch.Tensor):
        """The transport's state for this strategy's payload."""
        return self.transport.init_state(w_local)

    def init_state(self, w_local: torch.Tensor):
        """The strategy's and the transport's state for stacked codebooks
        like ``w_local``."""
        own = self._init_own_state(w_local)
        tsp = self._init_comm_state(w_local)
        if own is None:
            return tsp
        if tsp is None:
            return own
        return {"own": own, "comm": tsp}

    def _split_state(self, state):
        if self.own_state and self.transport.stateful:
            state = {} if state is None else state
            return state.get("own"), state.get("comm")
        if self.own_state:
            return state, None
        return None, state

    def _join_state(self, own, tsp):
        if self.own_state and self.transport.stateful:
            return {"own": own, "comm": tsp}
        if self.own_state:
            return own
        return tsp

    def __call__(self, w0: torch.Tensor, w_local: torch.Tensor, state=None
                 ) -> tuple[torch.Tensor, object]:
        raise NotImplementedError


class AverageMerge(MergeStrategy):
    """Paper eq. (3): w_srd = mean_i w^i(tau), the scheme that does NOT
    speed convergence up (Section 2's negative result)."""

    name = "average"

    def __call__(self, w0, w_local, state=None):
        del w0
        merged, _ = self.transport.all_reduce(w_local, op="mean")
        # means ride dense on every transport: the state passes through
        return merged, state


class DeltaMerge(MergeStrategy):
    """Paper eq. (8): w_srd = w0 - sum_i Delta^i, displacement merging."""

    name = "delta"

    def __call__(self, w0, w_local, state=None):
        total, state = self.transport.all_reduce(
            tree_sub_f32(w0, w_local), op="sum", state=state)
        return tree_apply_delta(w0, total), state


class SparseDeltaMerge(DeltaMerge):
    """Eq. (8) over the top-k/error-feedback ``SparseTransport``; its state
    is the per-worker residual."""

    name = "delta_sparse"

    def __init__(self, transport: comm.Transport | None = None, *,
                 frac: float | None = None):
        if transport is None:
            transport = comm.get_transport(
                "sparse", frac=0.01 if frac is None else frac)
        elif frac is not None and getattr(transport, "frac", frac) != frac:
            # an explicit transport AND a conflicting frac: refuse rather
            # than compress at a rate the caller did not ask for
            raise ValueError(
                f"frac={frac} conflicts with the supplied transport's "
                f"frac={transport.frac}; configure one place only")
        super().__init__(transport)


class AsyncDeltaMerge(MergeStrategy):
    """Paper eq. (9) in pipelined-collective form: the reduction of window
    k-1's deltas is applied at the end of window k, so the collective has
    no data dependency on window k's compute (a one-window-stale merge).

    Own state: last window's per-worker delta, f32 shaped like
    ``w_local`` (zeros at first); the merge sums it over the workers and
    applies the sum to each worker's ``w_local``, so the merged result
    keeps the worker dimension.  Outside ``get_merge``'s table its caller
    is the LM window step."""

    name = "async_delta"
    own_state = True

    def _init_own_state(self, w_local):
        return _zeros_f32(w_local)

    def __call__(self, w0, w_local, state=None):
        delta_prev, tsp = self._split_state(state)
        if delta_prev is None:
            raise ValueError("AsyncDeltaMerge needs its delta_prev state; "
                             "seed it with init_state(w_local)")
        stale, tsp = self.transport.all_reduce(delta_prev, op="sum",
                                               state=tsp)
        merged = tree_apply_delta(w_local, stale)
        return merged, self._join_state(tree_sub_f32(w0, w_local), tsp)


class QuorumMerge(MergeStrategy):
    """Straggler-tolerant eq. (8): proceed when K of M deltas arrive.

    Each window every worker ships its displacement plus its carried (not
    yet landed) delta, masked by its arrival bit (``1 - late``, ``late`` the
    window's column of the network's ``late_matrix``); the arrivals are
    counted on the same masked reduce, as a one-entry leaf beside the
    delta, so its 4 bytes are part of the merge's wire.  The landed sum
    applies only when at least ``ceil(quorum_frac * M)`` workers made it.
    A late worker's delta is not lost: it rides the worker's carry, damped
    by one ``staleness_scale(1, gamma)`` a window it waits, and lands with
    the next quorum.  With no ``late`` every worker arrives and the merge
    is the plain ``DeltaMerge``, bit for bit.

    Own state: the per-worker carry, f32 (M, kappa, d).  A stateful
    transport's state is made for the (delta, count) payload.  Over a
    process group ``w_local`` is this rank's row (1, kappa, d) and ``late``
    its (1,) entry; the quorum counts the group's workers
    (``Transport.workers``)."""

    name = "quorum"
    own_state = True

    def __init__(self, transport: comm.Transport | None = None, *,
                 quorum_frac: float = 0.6, gamma: float = 0.5):
        if not 0.0 < quorum_frac <= 1.0:
            raise ValueError(
                f"quorum_frac must be in (0, 1], got {quorum_frac}")
        super().__init__(transport)
        self.quorum_frac = quorum_frac
        self.gamma = gamma

    def quorum(self, m: int) -> int:
        """Arrivals a window needs among ``m`` workers:
        ``ceil(quorum_frac * m)``, at least 1."""
        return max(1, int(math.ceil(self.quorum_frac * m - 1e-9)))

    def _init_own_state(self, w_local):
        return torch.zeros(w_local.shape, dtype=torch.float32,
                           device=w_local.device)

    def _init_comm_state(self, w_local):
        return self.transport.init_state(
            (w_local, w_local.new_ones(w_local.shape[0])))

    def __call__(self, w0, w_local, state=None, *, late=None):
        carry, tsp = self._split_state(state)
        if carry is None:
            raise ValueError("QuorumMerge needs its pending-delta state; "
                             "seed it with init_state(w_local)")
        # the quorum counts every worker of the reduction: over a process
        # group w_local is this rank's one row of the group's M
        k_quorum = self.quorum(self.transport.workers(w_local))
        s = _scalar(staleness_scale(1, gamma=self.gamma), w_local)
        # this window's displacement plus the backlog, one window staler
        ship = tree_sub_f32(w0, w_local) + s * carry
        ones = torch.ones(w_local.shape[0], dtype=torch.float32,
                          device=w_local.device)
        arrive = ones if late is None else 1.0 - late.to(torch.float32)
        (landed, n), tsp = self.transport.masked_all_reduce(
            (ship, ones), arrive, state=tsp)
        met = (n >= k_quorum).to(torch.float32)
        merged = (w0.to(torch.float32) - met * landed).to(w0.dtype)
        # an arrived worker whose quorum landed owes nothing; everyone else
        # keeps the whole ship
        keep = 1.0 - met * arrive
        return merged, self._join_state(_per_worker(keep, ship) * ship, tsp)


class DynamicMerge(MergeStrategy):
    """Dynamic averaging for eq. (8): merge on measured drift, not on a
    clock.

    Every window each worker's pending displacement is this window's delta
    plus its carried, staleness-damped backlog; the workers agree on a
    global drift, the sum over workers of ``||pending||^2``, through a
    probe: a (M,) payload reduced with tag "probe" (4 bytes a worker, paid
    every window).  The window merges when the drift reaches ``thresh`` or
    ``max_stale`` windows have passed since the last merge.  The decision
    is a device scalar used as the mask of the transport's masked reduce,
    so no window waits on the host; ``last_trigger`` holds it for the
    executor, which reads the bits once after its loop and re-prices the
    merge records to the windows that triggered.

    A skipped window's displacement rides the worker's carry, damped by one
    ``staleness_scale(1, gamma)`` a window it waits.  With ``thresh=0``
    every window triggers with a zero carry and the merge is the plain
    ``DeltaMerge``, bit for bit.

    Own state: ``{"carry": f32 (M, kappa, d), "stale": windows since the
    last merge, an f32 scalar}``.  Over a process group the probe is this
    rank's (1,) entry reduced over the group: every rank reads the sum the
    collective returns, the same bits on each, so the ranks agree on every
    trigger and merge the same codebook."""

    name = "dynamic"
    own_state = True

    def __init__(self, transport: comm.Transport | None = None, *,
                 thresh: float = 0.0, gamma: float = 0.5,
                 max_stale: int = 8):
        if thresh < 0.0:
            raise ValueError(f"divergence thresh must be >= 0, got {thresh}")
        if max_stale < 1:
            raise ValueError(f"max_stale must be >= 1, got {max_stale}")
        super().__init__(transport)
        self.thresh = thresh
        self.gamma = gamma
        self.max_stale = max_stale
        self.last_trigger: torch.Tensor | None = None

    def _init_own_state(self, w_local):
        return {"carry": torch.zeros(w_local.shape, dtype=torch.float32,
                                     device=w_local.device),
                "stale": torch.zeros((), dtype=torch.float32,
                                     device=w_local.device)}

    def __call__(self, w0, w_local, state=None):
        own, tsp = self._split_state(state)
        if own is None:
            raise ValueError("DynamicMerge needs its carry/staleness state; "
                             "seed it with init_state(w_local)")
        carry, stale = own["carry"], own["stale"]
        s = _scalar(staleness_scale(1, gamma=self.gamma), w_local)
        pend = tree_sub_f32(w0, w_local) + s * carry
        local = (pend * pend).sum(dim=tuple(range(1, pend.dim())))
        drift, _ = self.transport.all_reduce(local, op="sum", tag="probe")
        trig = torch.logical_or(drift >= self.thresh,
                                stale + 1.0 >= self.max_stale
                                ).to(torch.float32)
        landed, tsp = self.transport.masked_all_reduce(
            pend, trig.expand(pend.shape[0]), state=tsp)
        merged = (w0.to(torch.float32) - trig * landed).to(w0.dtype)
        keep = 1.0 - trig
        self.last_trigger = trig
        return merged, self._join_state(
            {"carry": keep * pend, "stale": keep * (stale + 1.0)}, tsp)


_STRATEGIES = {"average": AverageMerge, "delta": DeltaMerge,
               "delta_sparse": SparseDeltaMerge,
               "async_delta": AsyncDeltaMerge, "quorum": QuorumMerge,
               "dynamic": DynamicMerge}


def get_merge(name: str, transport: comm.Transport | None = None, **kwargs
              ) -> MergeStrategy:
    """Factory: 'average' | 'delta' | 'delta_sparse' (``frac=``) |
    'async_delta' | 'quorum' (``quorum_frac=``, ``gamma=``) | 'dynamic' (``thresh=``, ``gamma=``,
    ``max_stale=``)."""
    if name not in _STRATEGIES:
        raise ValueError(
            f"unknown merge strategy {name!r}; choose from "
            f"{sorted(_STRATEGIES)}")
    return _STRATEGIES[name](transport, **kwargs)
