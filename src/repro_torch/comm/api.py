"""The ``Transport`` API and its wire-byte accounting.

Counterpart of ``repro/comm/api.py``.  The reference's transports run inside
a ``shard_map`` body and reduce over a named mesh axis.  Here the M workers
are the leading dimension of one tensor, so ``all_reduce`` takes that
stacked tensor, reduces over dimension 0 and returns the one merged
result; the participant count is that dimension's size.

Accounting is the reference's, record for record:

  * ``logical_bytes``: the dense f32 payload one participant contributes
    (``4 * numel`` of one worker's slice);
  * ``wire_bytes``: what a bandwidth-optimal ring all-reduce would put on the
    wire per participant, ``2 * (m-1)/m * logical``; one participant moves
    nothing.

Transports follow the reference's ``(result, state)`` convention:
``all_reduce`` and ``masked_all_reduce`` return the reduced tensor and the
transport's new state.  A ``stateful`` transport (``SparseTransport``, whose
state is the per-worker error-feedback residual) is seeded with
``init_state(x)`` and fed its state back every call; a stateless one
(``XlaTransport``) takes and returns ``None``.

Both calls also take a tuple of stacked ``(M, ...)`` tensors, the leaves
form, and return a tuple: one collective over several payloads, as the
reference reduces a pytree.  It is one record whose ``logical_bytes`` is
the sum of the leaves' f32 bytes; a dense transport charges the ring on
that sum, the sparse one its top-k per leaf.  The quorum merge ships its
displacement and a one-entry arrival count this way.

Each call logs one ``CommRecord`` with ``calls=1`` (or the reference's
``calls=`` keyword: one call standing for that many, its static trip
count); the log folds a repeat
of a collective since its latest mark into the first record's ``calls``, so
a run keeps one record per distinct collective, as the reference's does
(it traces a collective once and puts the window count in ``calls``), and
its totals stay exact however many windows it runs.  ``tag`` separates
merge traffic ("merge") from the distortion curve's reduce ("eval") and
the dynamic merge's per-window divergence probe ("probe", the scalar every
worker pays whether or not the window merges) and, through
``record_host_transfer``, an elastic resize's late deltas ("late_delta").
``tier`` is set on the records of a ``HierarchicalTransport``: 0 inside a
host group, 1 across host groups, ``None`` for a flat collective.

``CommLog.attach_metrics(registry)`` mirrors the log onto a
``repro_torch.obs.MetricsRegistry`` as the reference's does: ``comm_*``
counters of bytes x calls by tag, tier and transport.  The reference
mirrors a record as it lands, once per compiled program; here a repeated
collective folds into its first record, so the executors call
``mirror_metrics()`` once at the end of a run, which adds the records since
the previous mirror, and never a counter update a window.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: The stacked worker dimension's label in ``CommRecord.axis``.
WORKER_AXIS = "workers"


def as_leaves(x) -> tuple[tuple[torch.Tensor, ...], bool]:
    """``(the leaves, whether x was a tuple)``: a tensor is one leaf.  The
    leaves must share their worker dimension (dimension 0)."""
    is_tuple = isinstance(x, tuple)
    leaves = x if is_tuple else (x,)
    if not leaves or any(leaf.dim() < 1 or leaf.shape[0] != leaves[0].shape[0]
                         for leaf in leaves):
        raise ValueError(
            f"a payload is a stacked (M, ...) tensor or a tuple of them with "
            f"one M, got shapes {[tuple(leaf.shape) for leaf in leaves]}")
    return leaves, is_tuple


def from_leaves(outs, is_tuple: bool):
    """The inverse of ``as_leaves`` for a call's per-leaf results."""
    return tuple(outs) if is_tuple else outs[0]


def tree_f32_bytes(tree, *, floating_only: bool = False) -> int:
    """Dense f32 payload bytes of a tensor or a tuple of tensors (the
    ``logical_bytes`` unit)."""
    total = 0
    for leaf in (tree if isinstance(tree, tuple) else (tree,)):
        if floating_only and not leaf.is_floating_point():
            continue
        total += 4 * leaf.numel()
    return total


def worker_f32_bytes(x, *, floating_only: bool = False) -> int:
    """``tree_f32_bytes`` of one worker's slice of a stacked payload, from
    the shapes (no slice is taken: this runs on every collective)."""
    leaves, _ = as_leaves(x)
    return sum(4 * math.prod(leaf.shape[1:]) for leaf in leaves
               if not floating_only or leaf.is_floating_point())


def ring_wire_bytes(logical_bytes: int, m: int) -> int:
    """Per-participant wire bytes of a bandwidth-optimal ring all-reduce
    (reduce-scatter + all-gather): ``2 * (m-1)/m * logical``."""
    if m <= 1:
        return 0
    return int(2 * (m - 1) * logical_bytes // m)


@dataclasses.dataclass(frozen=True)
class CommRecord:
    """One collective call: what it moved, per participant, per call."""

    op: str                # 'sum' | 'mean' | 'masked_sum' | 'host'
    transport: str
    axis: str
    participants: int
    logical_bytes: int     # dense f32 payload per participant per call
    wire_bytes: int        # bytes per participant per call on the wire
    calls: int = 1
    tag: str = "merge"     # 'merge' | 'eval' | 'probe' | 'late_delta'
    # a hierarchical transport's link class: 0 = inside a host group,
    # 1 = across host groups; None = a flat collective
    tier: int | None = None


class CommLog:
    """Bounded stream of ``CommRecord``s with mark/since windows.

    A record equal to one appended since the latest ``mark`` in all but
    ``calls`` is folded into it (its ``calls`` add up), so the records since
    a mark number the distinct collectives, not the calls.  Keeps the newest
    ``max_records``; marks are absolute indices, so ``since`` stays right
    across trims (records that fell off are gone from old summaries, never
    misattributed)."""

    def __init__(self, max_records: int = 1 << 16):
        if max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.max_records = max_records
        self.records: list[CommRecord] = []
        self._dropped = 0
        # record (with calls=0) -> absolute index, for records since the mark
        self._open: dict[CommRecord, int] = {}
        self._metrics = None   # the registry mirror_metrics() adds to
        self._mirrored = 0     # absolute index of the first record it has not

    def attach_metrics(self, registry) -> None:
        """Mirror the records appended from now on onto ``registry`` (a
        ``repro_torch.obs.MetricsRegistry``) at each ``mirror_metrics()``:
        ``comm_wire_bytes``, ``comm_logical_bytes`` and ``comm_calls``
        counters labelled by tag, tier (``"flat"`` for None) and transport.

        Attach only to the top-level transport's log: a
        ``HierarchicalTransport`` copies its sub-transports' records into
        its own log, so attaching to both levels would count them twice."""
        if registry is not self._metrics:
            self._metrics = registry
            self._mirrored = self._dropped + len(self.records)

    def _record_metrics(self, rec: CommRecord, sign: float = 1.0) -> None:
        labels = {"tag": rec.tag,
                  "tier": "flat" if rec.tier is None else rec.tier,
                  "transport": rec.transport}
        self._metrics.counter("comm_wire_bytes", **labels).inc(
            sign * rec.wire_bytes * rec.calls)
        self._metrics.counter("comm_logical_bytes", **labels).inc(
            sign * rec.logical_bytes * rec.calls)
        self._metrics.counter("comm_calls", **labels).inc(sign * rec.calls)

    def mirror_metrics(self) -> None:
        """Add the records appended since the previous mirror to the
        attached registry, and close the folding window, so a mirrored
        record's ``calls`` never grows.  A no-op with no registry."""
        if self._metrics is None:
            return
        for rec in self.records[max(0, self._mirrored - self._dropped):]:
            self._record_metrics(rec)
        self._mirrored = self._dropped + len(self.records)
        self._open.clear()

    def _trim(self) -> None:
        excess = len(self.records) - self.max_records
        if excess > 0:
            del self.records[:excess]
            self._dropped += excess

    def append(self, rec: CommRecord) -> None:
        key = dataclasses.replace(rec, calls=0)
        i = self._open.get(key, -1) - self._dropped
        if i >= 0:
            self.records[i] = dataclasses.replace(
                self.records[i], calls=self.records[i].calls + rec.calls)
            return
        self._open[key] = self._dropped + len(self.records)
        self.records.append(rec)
        self._trim()

    def extend(self, recs) -> None:
        for rec in recs:
            self.append(rec)

    def mark(self) -> int:
        """Absolute position of the next record; records appended after it
        are not folded into earlier ones."""
        self._open.clear()
        return self._dropped + len(self.records)

    def since(self, mark: int) -> list[CommRecord]:
        return list(self.records[max(0, mark - self._dropped):])

    def rewrite_since(self, mark: int, fn) -> None:
        """Replace each record appended after ``mark`` with ``fn(rec)``
        (the record itself to keep it, another to swap it, ``None`` to drop
        it).  A folded record's ``calls`` is what ``fn`` re-prices: the
        dynamic merge runs its merge collective every window and, once the
        trigger bits are read, re-prices it to the windows that merged.  A
        rewrite closes the folding window, as ``mark`` does.  A record
        already mirrored onto the registry is backed out of its counters
        and its replacement added, as the reference does, so the counters
        always equal the log."""
        start = max(0, mark - self._dropped)
        mirrored = self._mirrored - self._dropped   # index, may be < start
        kept, n_mirrored = [], 0
        for i, rec in enumerate(self.records[start:], start):
            new = fn(rec)
            if self._metrics is not None and i < mirrored:
                if new is not rec:
                    self._record_metrics(rec, sign=-1.0)
                    if new is not None:
                        self._record_metrics(new)
                n_mirrored += new is not None
            if new is not None:
                kept.append(new)
        if self._metrics is not None and mirrored > start:
            self._mirrored = self._dropped + start + n_mirrored
        self.records[start:] = kept
        self._open.clear()

    def logical_bytes_by_tag(self, records=None) -> dict[str, int]:
        """Total logical payload (``logical_bytes * calls``) per tag, over
        ``records`` or the whole log."""
        out: dict[str, int] = {}
        for r in (self.records if records is None else records):
            out[r.tag] = out.get(r.tag, 0) + r.logical_bytes * r.calls
        return out

    @staticmethod
    def summarize(records) -> dict:
        """Totals (``wire/logical bytes * calls``) overall and per tag.
        Tiered records also land in a ``by_tier`` dict under their tag, so
        a hierarchical run reads intra-host (0) and inter-host (1) traffic
        apart; untiered records add nothing there."""
        def zero():
            return {"calls": 0, "logical_bytes": 0, "wire_bytes": 0}

        out: dict = {**zero(), "by_tag": {}}
        for r in records:
            by_tag = out["by_tag"].setdefault(r.tag, zero())
            totals = [out, by_tag]
            if r.tier is not None:
                totals.append(by_tag.setdefault("by_tier", {}).setdefault(
                    r.tier, zero()))
            for t in totals:
                t["calls"] += r.calls
                t["logical_bytes"] += r.logical_bytes * r.calls
                t["wire_bytes"] += r.wire_bytes * r.calls
        return out


class Transport:
    """Base transport: reduces a stacked ``(M, ...)`` tensor over dim 0."""

    name = "base"
    stateful = False

    def __init__(self):
        self.log = CommLog()

    def init_state(self, x):
        """The state a stateful transport threads from call to call, for a
        stacked payload shaped like ``x`` (a tensor or a tuple of them);
        ``None`` for a stateless one."""
        return None

    def workers(self, x) -> int:
        """The reduction's participants for payload x (a stacked tensor or a
        tuple of them): its leading dimension.  A transport over process
        groups returns the ranks it reduces over, x holding this rank's
        rows; the quorum merge counts its quorum on this."""
        return as_leaves(x)[0][0].shape[0]

    def plain(self) -> "Transport":
        """This transport with its kernels' plain PyTorch versions in their
        place, sharing its log (``MeshExecutor(use_kernels=False)`` merges
        through it).  A transport that launches no kernel returns itself."""
        return self

    def all_reduce(self, x, *, op: str = "sum", state=None, calls: int = 1,
                   tag: str = "merge"):
        """x (M, ...), or a tuple of them -> ``(the reduction over workers,
        a tuple for a tuple, new state)``; its records charged ``calls``
        calls."""
        raise NotImplementedError

    def masked_all_reduce(self, x, mask: torch.Tensor, *, state=None,
                          calls: int = 1, tag: str = "merge"):
        """The eq.-9 reducer: ``(the f32 sum over workers of mask[i] * x[i],
        new state)`` (mask (M,), 1.0 for the workers whose round lands this
        tick; x a tensor or a tuple of them).  Every participant joins the
        collective whatever its bit, so it is charged as a full call."""
        raise NotImplementedError

    def _charged(self, calls: int, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` with the records it appends charged
        ``calls`` calls each (a composite transport's ``calls=``)."""
        if calls == 1:
            return fn(*args, **kwargs)
        mark = self.log.mark()
        out = fn(*args, **kwargs)
        self.log.rewrite_since(mark, lambda r: dataclasses.replace(
            r, calls=r.calls * calls))
        return out

    def record_host_transfer(self, *, logical_bytes: int, wire_bytes: int,
                             participants: int, axis: str = WORKER_AXIS,
                             calls: int = 1, tag: str = "late_delta",
                             tier: int | None = None) -> None:
        """Account a transfer that bypasses the collectives (an elastic
        resize moving the departing workers' late deltas) as one ``op="host"``
        record; ``tier`` is the link class it crossed (1 when the departing
        workers were whole host groups, ``None`` for a flat worker set)."""
        self.log.append(CommRecord(
            op="host", transport=self.name, axis=axis,
            participants=participants, logical_bytes=logical_bytes,
            wire_bytes=wire_bytes, calls=calls, tag=tag, tier=tier))


def get_transport(name, **kwargs) -> Transport:
    """Factory: 'xla' (dense) | 'ring' (dense, the ring kernel) | 'sparse'
    (top-k + error feedback, ``frac=``) | 'quant' (``inner=``, ``mode=``:
    bf16/int8 deltas over another transport) | 'hier' (``topology=``,
    ``tier0=``, ``tier1=``, ``tier1_frac=``: two tiers over host groups).

    An already-constructed ``Transport`` passes through unchanged."""
    if isinstance(name, Transport):
        return name
    from repro_torch.comm.hier import HierarchicalTransport
    from repro_torch.comm.quant import QuantizedTransport
    from repro_torch.comm.ring import RingTransport
    from repro_torch.comm.sparse import SparseTransport
    from repro_torch.comm.xla import XlaTransport
    transports = {"xla": XlaTransport, "ring": RingTransport,
                  "sparse": SparseTransport, "quant": QuantizedTransport,
                  "hier": HierarchicalTransport}
    if name not in transports:
        raise ValueError(
            f"unknown transport {name!r}; choose from {sorted(transports)}")
    return transports[name](**kwargs)
