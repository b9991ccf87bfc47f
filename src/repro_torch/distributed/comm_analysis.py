"""A run's collective bytes and loop structure, the port's substitute for
``repro/distributed/hlo_analysis.py::analyze_collectives``.

The reference parses the compiled post-SPMD HLO of a mesh program: the
bytes of each collective op, multiplied by the trip counts of the
``while`` loops around it.  The port compiles no program (eager PyTorch,
one kernel launch per window or tick), so there is no text to parse.  Its
counterpart of those bytes is the run's ``CommRecord`` stream: every
collective the executor issued, folded into one record a distinct
collective with the count of its calls.  The reference's HLO bytes equal
its ``CommLog`` logical bytes (``tests/test_profile.py:67-77``), so the
total here is ``logical_bytes * calls`` summed over the records.

  * Records with ``op == "host"`` are left out: they are an elastic
    resize's late deltas, which are no collective of the reference's
    program.
  * The caller passes the records before the dynamic merge re-prices its
    merge to the windows that merged: the reference's HLO counts the merge
    collective in every window (SPMD cannot skip one), and the port's
    masked merge runs every window too.
  * ``bytes_by_kind`` uses the reference's HLO kind names: the sparse
    transport's records are the reference's ``all-gather`` of values and
    indices, every other reduction an ``all-reduce``.
  * ``loops`` is the executor's own loop structure, not a parse: a sync run
    is ``[("window", n_windows), ("step", tau)]`` (on the card the tau steps
    run inside one window-kernel launch), eq. 9 ``[("tick", n)]``.
"""

from __future__ import annotations


def analyze_collectives(records, loops) -> dict:
    """``{'total_bytes', 'bytes_by_kind', 'loops'}`` of one program's
    records (``CommLog.since(mark)``), per participant."""
    by_kind: dict[str, float] = {}
    for r in records:
        if r.op == "host":
            continue
        kind = "all-gather" if r.transport == "sparse" else "all-reduce"
        by_kind[kind] = by_kind.get(kind, 0) + r.logical_bytes * r.calls
    return {"total_bytes": sum(by_kind.values()), "bytes_by_kind": by_kind,
            "loops": [(name, int(trip)) for name, trip in loops]}
