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

Each call logs one ``CommRecord`` with ``calls=1``; the log folds a repeat
of a collective since its latest mark into the first record's ``calls``, so
a run keeps one record per distinct collective, as the reference's does
(it traces a collective once and puts the window count in ``calls``), and
its totals stay exact however many windows it runs.  ``tag`` separates
merge traffic ("merge") from the distortion curve's reduce ("eval").
"""

from __future__ import annotations

import dataclasses

import torch

#: The stacked worker dimension's label in ``CommRecord.axis``.
WORKER_AXIS = "workers"


def tree_f32_bytes(tree: torch.Tensor, *, floating_only: bool = False) -> int:
    """Dense f32 payload bytes of a tensor (the ``logical_bytes`` unit)."""
    if floating_only and not tree.is_floating_point():
        return 0
    return 4 * tree.numel()


def ring_wire_bytes(logical_bytes: int, m: int) -> int:
    """Per-participant wire bytes of a bandwidth-optimal ring all-reduce
    (reduce-scatter + all-gather): ``2 * (m-1)/m * logical``."""
    if m <= 1:
        return 0
    return int(2 * (m - 1) * logical_bytes // m)


@dataclasses.dataclass(frozen=True)
class CommRecord:
    """One collective call: what it moved, per participant, per call."""

    op: str                # 'sum' | 'mean' | 'masked_sum'
    transport: str
    axis: str
    participants: int
    logical_bytes: int     # dense f32 payload per participant per call
    wire_bytes: int        # bytes per participant per call on the wire
    calls: int = 1
    tag: str = "merge"     # 'merge' | 'eval'


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

    @staticmethod
    def summarize(records) -> dict:
        """Totals (``wire/logical bytes * calls``) overall and per tag."""
        out: dict = {"calls": 0, "logical_bytes": 0, "wire_bytes": 0,
                     "by_tag": {}}
        for r in records:
            for t in (out, out["by_tag"].setdefault(
                    r.tag, {"calls": 0, "logical_bytes": 0,
                            "wire_bytes": 0})):
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

    def init_state(self, x: torch.Tensor):
        """The state a stateful transport threads from call to call, for a
        stacked payload shaped like ``x``; ``None`` for a stateless one."""
        return None

    def plain(self) -> "Transport":
        """This transport with its kernels' plain PyTorch versions in their
        place, sharing its log (``MeshExecutor(use_kernels=False)`` merges
        through it).  A transport that launches no kernel returns itself."""
        return self

    def all_reduce(self, x: torch.Tensor, *, op: str = "sum", state=None,
                   tag: str = "merge") -> tuple[torch.Tensor, object]:
        """x (M, ...) -> ``(the reduction over workers, new state)``."""
        raise NotImplementedError

    def masked_all_reduce(self, x: torch.Tensor, mask: torch.Tensor, *,
                          state=None, tag: str = "merge"
                          ) -> tuple[torch.Tensor, object]:
        """The eq.-9 reducer: ``(the f32 sum over workers of mask[i] * x[i],
        new state)`` (mask (M,), 1.0 for the workers whose round lands this
        tick).  Every participant joins the collective whatever its bit, so
        it is charged as a full call."""
        raise NotImplementedError


def get_transport(name, **kwargs) -> Transport:
    """Factory: 'xla' (dense) | 'ring' (dense, the ring kernel) | 'sparse'
    (top-k + error feedback, ``frac=``) | 'quant' (``inner=``, ``mode=``:
    bf16/int8 deltas over another transport).

    An already-constructed ``Transport`` passes through unchanged."""
    if isinstance(name, Transport):
        return name
    from repro_torch.comm.quant import QuantizedTransport
    from repro_torch.comm.ring import RingTransport
    from repro_torch.comm.sparse import SparseTransport
    from repro_torch.comm.xla import XlaTransport
    transports = {"xla": XlaTransport, "ring": RingTransport,
                  "sparse": SparseTransport, "quant": QuantizedTransport}
    if name not in transports:
        raise ValueError(
            f"unknown transport {name!r}; choose from {sorted(transports)}")
    return transports[name](**kwargs)
