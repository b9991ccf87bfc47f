"""``HierarchicalTransport``: two-tier merges over host groups.

Counterpart of ``repro/comm/hier.py``.  The paper's final scheme exists
because its platform was hierarchical: cheap links inside a machine, slow
links between machines.  This transport composes two others over a
``Topology``:

  * **tier 0** (inside a host group): a dense transport, the stock sum or
    the ring kernel, reduces each group's workers;
  * **tier 1** (across host groups): the group partials cross the slow
    links, by default through ``SparseTransport`` (top-k with error
    feedback).

The reference's transports take the mesh axis of each call, and the axis
spec tells the hierarchical one whether to run one tier or two.  The port's
transports take no axis (the workers are dimension 0 of one tensor), so
the split of that dimension into host groups lives here: the transport is
given its ``Topology`` when it is made (``topology=``, in place of the
reference's ``host_axis=``/``worker_axis=``, whose names it carries), and
reshapes a stacked ``(M, ...)`` payload to ``(hosts, workers_per_host,
...)`` (``Topology.view``).  ``regroup(topology)`` gives the same tiers
over another topology, writing into the same log: the elastic executor
runs each worker count through one, as the reference runs each of its
per-M meshes through one shared transport.

Every delegated call's ``CommRecord``s are copied into this transport's log
with ``tier=`` set (and the axis and participants of their tier), so
``CommLog.summarize`` reports intra- and inter-host wire apart and the
network model charges tier 1 at its own bandwidth.  Tier 0 runs once per
host group on the contiguous ``x[h]`` rows (a ring tier 0 launches the ring
kernel once per group); the sub-transport's log folds those calls into one
record of ``hosts`` calls, which is copied as one call, the reference's
record of one collective over the worker axis.

The reference's three contracts:

  * **dense tiers fuse.**  When both tiers are ``XlaTransport``-family
    (``RingTransport`` is one), one reduction runs over all M rows with
    tier 0's sum, the flat run's own reduction, so a hierarchical run with
    a dense tier 1 equals the flat run bit for bit; the accounting still
    splits per tier (tier 0 the dense ring inside a group, tier 1 across
    the hosts).
  * **a flat topology runs tier 0 only**, on all M rows, with no tier-1
    record: ``hosts=1`` is the flat path bit for bit.
  * **otherwise two stages:** tier 0 inside each group (masked for eq. 9),
    then tier 1 over the ``hosts`` partials.  In the masked form tier 1
    runs every call, even when no worker lands (the error feedback keeps a
    zero partial from consuming residual).

One worker a process: when the tiers carry process groups
(``XlaTransport(group=)``, ``RingTransport(group=)`` or
``SparseTransport(group=)`` over ``Topology.make_groups``' worker and host
groups), a payload is this rank's rows ``(1, ...)`` and the reduction is
two-stage: tier 0 over my host's ranks, then tier 1 over
``Groups.group(host_axis)``, the ranks with my worker coordinate on the
other hosts.  A masked call applies this rank's entry at tier 0.  With two
dense tiers, tier 1 sums the partials under the entry 1.0, so both
records are the fused path's ``masked_sum``, and the sums are the fused
run's to rounding (two reductions in place of one).  Otherwise the records
are the stacked two-stage path's (tier 1 an unmasked sum), and over a
group ring tier 0 the stacked run's bits: a sparse tier 1 gathers the same
top-k pairs and sums them in the same order.  The records equal the
stacked run's field for field.

State is ``{"t0": tier 0's, "t1": tier 1's}`` (``None`` when both tiers are
stateless).  Tier 0's is per worker, ``(M, ...)``.  In the reference every
worker of a group holds the same tier-1 residual (the group partial is the
same on each); the port keeps one per host, ``(hosts, ...)``, and over
processes each rank keeps its own copy of its host's, ``(1, ...)``: the
ranks of a host feed tier 1 the same partial, so their copies stay equal.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.comm.api import (CommRecord, Transport, as_leaves,
                                  from_leaves, get_transport,
                                  ring_wire_bytes, worker_f32_bytes)
from repro_torch.comm.xla import XlaTransport
from repro_torch.topology import Topology


def _map_state(fn, state):
    """fn over every tensor of a transport state (None, a tensor, or tuples
    and dicts of them), keeping its structure."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, tuple):
        return tuple(_map_state(fn, s) for s in state)
    if isinstance(state, dict):
        return {k: _map_state(fn, v) for k, v in state.items()}
    raise TypeError(f"unsupported transport state {type(state).__name__}")


def _stack_states(states):
    """Per-group states (each over one group's rows) -> one over all M rows,
    structure kept."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(states, dim=0)
    if isinstance(first, tuple):
        return tuple(_stack_states([s[i] for s in states])
                     for i in range(len(first)))
    return {k: _stack_states([s[k] for s in states]) for k in first}


class HierarchicalTransport(Transport):
    """Tier-0 dense inside host groups, tier-1 (default sparse) across."""

    name = "hier"

    def __init__(self, tier0: Transport | str = "xla",
                 tier1: Transport | str = "sparse", *, topology: Topology,
                 tier1_frac: float | None = None):
        super().__init__()
        if not isinstance(topology, Topology):
            raise TypeError(
                f"topology= must be a Topology, got {type(topology).__name__}")
        if isinstance(tier1, str) and tier1 == "sparse":
            tier1 = get_transport(
                "sparse", frac=0.01 if tier1_frac is None else tier1_frac)
        elif tier1_frac is not None:
            frac = getattr(get_transport(tier1), "frac", None)
            if frac != tier1_frac:
                # an explicit tier-1 transport AND a conflicting frac
                raise ValueError(
                    f"tier1_frac={tier1_frac} conflicts with the supplied "
                    f"tier-1 transport (frac={frac}); configure one place "
                    f"only")
        self.tier0 = get_transport(tier0)
        self.tier1 = get_transport(tier1)
        for label, sub in (("tier0", self.tier0), ("tier1", self.tier1)):
            if isinstance(sub, HierarchicalTransport):
                # the inner tier labels would be overwritten and the inner
                # log's copies double-count the wire
                raise ValueError(
                    f"{label}= must not be a HierarchicalTransport: nesting "
                    f"would overwrite the inner tier tags and double-count "
                    f"delegated CommRecords")
        self.topology = topology
        self.host_axis = topology.host_axis
        self.worker_axis = topology.worker_axis
        grouped = [getattr(t, "group", None) is not None
                   for t in (self.tier0, self.tier1)]
        if any(grouped) and not all(grouped):
            raise ValueError(
                "over process groups both tiers must carry a group (the "
                "worker and host groups of Topology.make_groups)")

    @property
    def grouped(self) -> bool:
        """The tiers reduce over process groups (one worker a process)."""
        return getattr(self.tier0, "group", None) is not None

    @property
    def stateful(self) -> bool:  # type: ignore[override]
        return self.tier0.stateful or self.tier1.stateful

    @property
    def tier1_frac(self) -> float | None:
        return getattr(self.tier1, "frac", None)

    def workers(self, x) -> int:
        return (self.topology.total_workers if self.grouped
                else super().workers(x))

    def plain(self) -> HierarchicalTransport:
        out = copy.copy(self)    # shares the log
        out.tier0 = self.tier0.plain()
        out.tier1 = self.tier1.plain()
        return out

    def regroup(self, topology: Topology) -> HierarchicalTransport:
        """This transport over another topology: the same tier transports,
        and this transport's log, so one ``CommLog`` covers every worker
        count of an elastic run (the reference shares one transport across
        its per-M meshes, whose axes carry the grouping)."""
        if not isinstance(topology, Topology):
            raise TypeError(
                f"topology= must be a Topology, got {type(topology).__name__}")
        out = copy.copy(self)    # shares the log and the tiers
        out.topology = topology
        out.host_axis = topology.host_axis
        out.worker_axis = topology.worker_axis
        return out

    # -- shapes and state ---------------------------------------------------

    def _groups(self, x):
        """x (M, ...) or a tuple of them -> (the leaves viewed (hosts, wph,
        ...), whether x was a tuple)."""
        leaves, is_tuple = as_leaves(x)
        return [self.topology.view(leaf) for leaf in leaves], is_tuple

    def _host_rows(self, x):
        """One row a host group, (hosts, ...), shaped like tier 1's
        payload."""
        grouped, is_tuple = self._groups(x)
        return from_leaves([g[:, 0] for g in grouped], is_tuple)

    def init_state(self, x):
        s0 = self.tier0.init_state(x)
        # over processes tier 1's payload is this rank's (1, ...) partial
        s1 = self.tier1.init_state(x if self.grouped else self._host_rows(x))
        if s0 is None and s1 is None:
            return None
        return {"t0": s0, "t1": s1}

    @staticmethod
    def _split_state(state):
        if state is None:
            return None, None
        return state.get("t0"), state.get("t1")

    @staticmethod
    def _join_state(state, s0, s1):
        # a state=None call runs residual-free and stays None
        if state is None:
            return None
        return {"t0": s0, "t1": s1}

    # -- delegation ---------------------------------------------------------

    def _relog(self, sub: Transport, mark: int, tier: int, calls: int
               ) -> None:
        """Copy ``sub``'s records since ``mark`` into this log, tagged
        ``tier``: ``calls`` delegated calls make one call here.

        Each delegated record is re-tagged exactly once: one that already
        carries a tier has been through a hierarchical delegation before (a
        sub-transport shared with another one), and overwriting it would
        misattribute, and its earlier copy double-count, the wire."""
        if tier == 0:
            axis, m = self.worker_axis, self.topology.workers_per_host
        else:
            axis, m = self.host_axis, self.topology.hosts
        for r in sub.log.since(mark):
            if r.tier is not None:
                raise RuntimeError(
                    f"CommRecord {r.op!r} on {r.axis!r} already carries "
                    f"tier={r.tier} — delegated records must be re-tagged "
                    f"exactly once (is a sub-transport shared with another "
                    f"hierarchical transport?)")
            if r.calls % calls:
                raise RuntimeError(
                    f"{r.calls} delegated calls of {r.op!r} do not split "
                    f"into {calls} host groups")
            self.log.append(dataclasses.replace(
                r, tier=tier, axis=axis, participants=m,
                calls=r.calls // calls))

    def _tier0(self, x, *, op: str, mask, state, tag: str):
        """Tier 0 inside every host group: (the partials, (hosts, ...) per
        leaf, tier 0's new state over all M rows)."""
        grouped, is_tuple = self._groups(x)
        hosts = self.topology.hosts
        states = (None if state is None else
                  [_map_state(lambda s, h=h: self.topology.view(s)[h], state)
                   for h in range(hosts)])
        mark = self.tier0.log.mark()
        outs, new = [], []
        for h in range(hosts):
            xh = from_leaves([g[h] for g in grouped], is_tuple)
            sh = None if states is None else states[h]
            if mask is None:
                out, sh = self.tier0.all_reduce(xh, op=op, state=sh, tag=tag)
            else:
                view = self.topology.view(mask)[h]
                out, sh = self.tier0.masked_all_reduce(xh, view, state=sh,
                                                       tag=tag)
            outs.append(out if is_tuple else (out,))
            new.append(sh)
        self._relog(self.tier0, mark, 0, hosts)
        partial = from_leaves([torch.stack([o[i] for o in outs])
                               for i in range(len(grouped))], is_tuple)
        return partial, (None if state is None else _stack_states(new))

    def _tier1(self, partial, *, op: str, state, tag: str):
        mark = self.tier1.log.mark()
        out, state = self.tier1.all_reduce(partial, op=op, state=state,
                                           tag=tag)
        self._relog(self.tier1, mark, 1, 1)
        return out, state

    def _flat(self, method: str, x, *args, state, tag: str, **kwargs):
        """A flat topology: tier 0 over all M rows, no tier-1 record."""
        s0, s1 = self._split_state(state)
        mark = self.tier0.log.mark()
        out, s0 = getattr(self.tier0, method)(x, *args, state=s0, tag=tag,
                                              **kwargs)
        self._relog(self.tier0, mark, 0, 1)
        return out, self._join_state(state, s0, s1)

    # -- the fused dense path -----------------------------------------------

    def _dense_fusable(self) -> bool:
        """Both tiers stateless-dense: one reduction over all M rows is the
        flat run's, bit for bit."""
        return (isinstance(self.tier0, XlaTransport)
                and isinstance(self.tier1, XlaTransport))

    def _record_tiers(self, op: str, logical: int, *, tag: str) -> None:
        """Per-tier dense accounting of one fused reduction: the bytes the
        two-tier schedule moves on each link class."""
        wph, hosts = self.topology.workers_per_host, self.topology.hosts
        self.log.append(CommRecord(
            op=op, transport=self.tier0.name, axis=self.worker_axis,
            participants=wph, logical_bytes=logical,
            wire_bytes=ring_wire_bytes(logical, wph), tag=tag, tier=0))
        self.log.append(CommRecord(
            op=op, transport=self.tier1.name, axis=self.host_axis,
            participants=hosts, logical_bytes=logical,
            wire_bytes=ring_wire_bytes(logical, hosts), tag=tag, tier=1))

    def _fused(self, x, *, op: str, tag: str, mask=None):
        leaves, is_tuple = as_leaves(x)
        for leaf in leaves:
            self.topology.view(leaf)          # checks M
        if op == "mean":
            if not all(leaf.is_floating_point() for leaf in leaves):
                raise ValueError(
                    f"a mean reduces floats, got "
                    f"{[leaf.dtype for leaf in leaves]}")
            self._record_tiers("mean", worker_f32_bytes(
                x, floating_only=True), tag=tag)
            return from_leaves([self.tier0._mean(leaf) for leaf in leaves],
                               is_tuple)
        self._record_tiers("sum" if mask is None else "masked_sum",
                           worker_f32_bytes(x), tag=tag)
        return from_leaves([self.tier0._sum(leaf, mask) for leaf in leaves],
                           is_tuple)

    # -- over process groups ------------------------------------------------

    def _grouped(self, x, *, op: str, tag: str, state, mask=None):
        """Tier 0 over my host's ranks, then tier 1 across hosts over my
        column's; x is this rank's rows (1, ...).  Returns (the sum or
        mean, the new state)."""
        s0, s1 = self._split_state(state)
        mark = self.tier0.log.mark()
        if mask is None:
            part, s0 = self.tier0.all_reduce(x, op=op, state=s0, tag=tag)
        else:
            part, s0 = self.tier0.masked_all_reduce(x, mask, state=s0,
                                                    tag=tag)
        self._relog(self.tier0, mark, 0, 1)
        part = (tuple(p[None] for p in part) if isinstance(part, tuple)
                else part[None])
        mark = self.tier1.log.mark()
        if mask is None or not self._dense_fusable():
            # the stacked two-stage path's tier 1: the partials always sum
            out, s1 = self.tier1.all_reduce(part, op=op, state=s1, tag=tag)
        else:
            # the fused path's records: a masked_sum on both tiers
            out, s1 = self.tier1.masked_all_reduce(
                part, torch.ones_like(mask), state=s1, tag=tag)
        self._relog(self.tier1, mark, 1, 1)
        return out, self._join_state(state, s0, s1)

    # -- Transport API ------------------------------------------------------

    def all_reduce(self, x, *, op: str = "sum", state=None, calls: int = 1,
                   tag: str = "merge"):
        if calls != 1:
            return self._charged(calls, self.all_reduce, x, op=op,
                                 state=state, tag=tag)
        if op not in ("sum", "mean"):
            raise ValueError(
                f"unknown reduce op {op!r}; choose 'sum' or 'mean'")
        if self.topology.is_flat:
            return self._flat("all_reduce", x, op=op, state=state, tag=tag)
        if self.grouped:
            return self._grouped(x, op=op, tag=tag, state=state)
        if self._dense_fusable():
            return self._fused(x, op=op, tag=tag), state
        s0, s1 = self._split_state(state)
        partial, s0 = self._tier0(x, op=op, mask=None, state=s0, tag=tag)
        total, s1 = self._tier1(partial, op=op, state=s1, tag=tag)
        return total, self._join_state(state, s0, s1)

    def masked_all_reduce(self, x, mask: torch.Tensor, *, state=None,
                          calls: int = 1, tag: str = "merge"):
        if calls != 1:
            return self._charged(calls, self.masked_all_reduce, x, mask,
                                 state=state, tag=tag)
        m = 1 if self.grouped else self.topology.total_workers
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        if self.topology.is_flat:
            return self._flat("masked_all_reduce", x, mask, state=state,
                              tag=tag)
        if self.grouped:
            return self._grouped(x, op="sum", tag=tag, mask=mask,
                                 state=state)
        if self._dense_fusable():
            return self._fused(x, op="sum", tag=tag, mask=mask), state
        s0, s1 = self._split_state(state)
        # tier 0: only each group's landing workers contribute
        partial, s0 = self._tier0(x, op="sum", mask=mask, state=s0, tag=tag)
        # tier 1: the partials (possibly zero) always sum across hosts
        total, s1 = self._tier1(partial, op="sum", state=s1, tag=tag)
        return total, self._join_state(state, s0, s1)
