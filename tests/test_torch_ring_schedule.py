"""The group ring's step protocol on the card (``comm.ring.hop_schedule``),
modelled on the CPU.

On the card each rank of ``ring_all_reduce_group`` enqueues its steps on
its stream: the stage, the reduce-scatter's folds and the all-gather's
copies, each behind stream waits on its neighbours' progress counters and
ahead of a write of its own, with no host wait inside a call.  The CUDA
route runs only on the card (``chip_smoke.py`` G1 holds it there); here M
ranks run the same schedule under seeded random interleavings: a step
starts only when its waits hold, is in flight for a while (its reads and
its writes are not atomic on the card), and signals when it finishes.
Every chunk carries a tag (the call and the ranks folded into it) and a
write count, so the model sees a step that reads a chunk its neighbour has
not finished, or one that is overwritten while the step reads it.  Three
calls run back to back on new inputs, the counters never reset, and each
rank's output must equal ``ring_all_reduce_plain`` of the stacked rows bit
for bit.  Without the stage's wait on the right neighbour the model must
see the hazard at M = 2, and without the hops' waits on the left at M = 3.

A fake kernel library then records what ``_ring_group_cuda`` enqueues, so
the CUDA driver loop is held to the same schedule: one step entry a step
(its waits, its launch and its write) for three calls, their sequence
numbers, no barrier or synchronize inside a call, and the timing events
that ``step_events`` asks for around each step.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.comm import ring

torch.set_num_threads(1)

F32 = np.float32
CALLS = 3
N = 37          # ragged for every M below but 1


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((m, N)).astype(F32) for _ in range(CALLS)]
    masks = [(rng.random(m) < 0.7).astype(F32) for _ in range(CALLS)]
    return rows, masks


def run_protocol(m, rows, masks, seed, schedule=ring.hop_schedule):
    """M ranks run ``len(rows)`` calls of ``schedule`` in one random
    interleaving; returns (each call's output on each rank, the hazards
    seen as (kind, what): "unfinished", a chunk read before its neighbour
    finished it; "overwritten", a chunk read after or while a later write
    replaced it).  Raises on a deadlock."""
    rng = np.random.default_rng(seed)
    chunk = -(-N // m)
    steps = len(schedule(m, 0))
    full = frozenset(range(m))
    buf = np.zeros((m, m, chunk), F32)               # rank, chunk, entries
    tag = [[None] * m for _ in range(m)]             # (call, ranks folded)
    writes = np.zeros((m, m), np.int64)
    counter = [0] * m
    program = [[(k, st) for k in range(len(rows)) for st in
                (*schedule(m, r), None)] for r in range(m)]  # None: copy out
    pc = [0] * m
    flight = [None] * m
    outs = [[None] * m for _ in rows]
    hazards = []

    def check(k, seen, want, what):
        if seen != want:
            late = seen is not None and seen[0] > k
            hazards.append(("overwritten" if late else "unfinished",
                            f"{what} as {seen}, want {want}"))

    def ready(r):
        k, st = program[r][pc[r]]
        if st is None:
            return True
        base = k * steps
        return ((st.wait_left is None
                 or counter[(r - 1) % m] >= base + st.wait_left)
                and (st.wait_right is None
                     or counter[(r + 1) % m] >= base + st.wait_right))

    def start(r):
        k, st = program[r][pc[r]]
        left = (r - 1) % m
        if st is None:                            # the copy out
            reads = [(r, c) for c in range(m)]
            for c in range(m):
                check(k, tag[r][c], (k, full),
                      f"call {k} rank {r} copies out chunk {c}")
        elif st.chunk is None:                    # the stage
            reads = []
        else:
            c = st.chunk
            reads = [(left, c)] + ([(r, c)] if st.add else [])
            want = ((k, frozenset((c + i) % m for i in range(st.t)))
                    if st.add else (k, full))
            check(k, tag[left][c], want,
                  f"call {k} rank {r} step {st.t} reads chunk {c} of rank "
                  f"{left}")
            if st.add:
                check(k, tag[r][c], (k, frozenset((r,))),
                      f"call {k} rank {r} step {st.t} folds into chunk {c}")
        flight[r] = [(src, c, writes[src, c], buf[src, c].copy(),
                      tag[src][c]) for src, c in reads]

    def finish(r):
        k, st = program[r][pc[r]]
        for src, c, w, _, _ in flight[r]:
            if writes[src, c] != w:
                hazards.append(("overwritten", f"call {k} rank {r}: chunk "
                                f"{c} of rank {src} written while read"))
        got = {(src, c): (v, t) for src, c, _, v, t in flight[r]}
        if st is None:
            outs[k][r] = np.concatenate([got[(r, c)][0] for c in range(m)])
        elif st.chunk is None:
            row = np.zeros(m * chunk, F32)
            row[:N] = (masks[k][r] * rows[k][r]).astype(F32)
            buf[r] = row.reshape(m, chunk)
            for c in range(m):
                tag[r][c] = (k, frozenset((r,)))
                writes[r, c] += 1
        else:
            c, left = st.chunk, (r - 1) % m
            lv, lt = got[(left, c)]
            if st.add:
                mv, mt = got[(r, c)]
                buf[r, c] = (lv + mv).astype(F32)   # the received partial left
                tag[r][c] = (k, lt[1] | mt[1]) if lt and mt else None
            else:
                buf[r, c] = lv
                tag[r][c] = lt
            writes[r, c] += 1
        if st is not None:
            counter[r] = k * steps + st.t + 1
        flight[r] = None
        pc[r] += 1

    while any(pc[r] < len(program[r]) for r in range(m)):
        moves = [(r, "finish") if flight[r] is not None else (r, "start")
                 for r in range(m) if pc[r] < len(program[r])
                 and (flight[r] is not None or ready(r))]
        if not moves:
            raise RuntimeError(f"deadlock at {pc}, counters {counter}")
        r, what = moves[rng.integers(len(moves))]
        (finish if what == "finish" else start)(r)
    return outs, hazards


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", range(2, 9))
def test_schedule_runs_hazard_free_and_gives_plain_bits(m, masked):
    """Three back-to-back calls under random interleavings: no step reads a
    chunk before its neighbour finished it or while it is overwritten, and
    every rank's output is ``ring_all_reduce_plain``'s bits."""
    rows, masks = _inputs(m, 31 + m)
    if not masked:
        masks = [np.ones(m, F32)] * CALLS
    for seed in range(6):
        outs, hazards = run_protocol(m, rows, masks, seed)
        assert hazards == []
        for k in range(CALLS):
            want = ring.ring_all_reduce_plain(
                torch.from_numpy(rows[k]),
                torch.from_numpy(masks[k]) if masked else None).numpy()
            for r in range(m):
                assert (outs[k][r][:N].view(np.int32)
                        == want.view(np.int32)).all(), (k, r, seed)


def _without(field):
    def schedule(m, r):
        return tuple(st._replace(**{field: None})
                     for st in ring.hop_schedule(m, r))
    return schedule


@pytest.mark.parametrize("field,m", [("wait_right", 2), ("wait_left", 3)])
def test_model_sees_a_missing_wait(field, m):
    """Negative cases: without its right-neighbour wait the next call's
    stage overwrites a chunk the right neighbour's last copy still has to
    read (M = 2); without the left-neighbour waits a hop reads a chunk its
    left neighbour has not finished (M = 3).  The model reports each in
    some interleaving."""
    rows, masks = _inputs(m, 5)
    kinds = {kind for seed in range(40) for kind, _ in
             run_protocol(m, rows, masks, seed, _without(field))[1]}
    assert ("overwritten" if field == "wait_right" else "unfinished") in kinds


def test_schedule_is_the_plain_versions_chunks():
    """The stage, waiting on the right neighbour's call before, then M - 1
    folds of chunk (r - s - 1) mod M and M - 1 copies of chunk (r - s) mod
    M, each hop waiting on the left neighbour's previous step; 2M - 1
    steps."""
    for m in range(2, 9):
        for r in range(m):
            sched = ring.hop_schedule(m, r)
            assert len(sched) == 2 * m - 1
            assert sched[0] == ring.RingStep(0, None, False, None, 0)
            for s in range(m - 1):
                assert sched[1 + s] == ring.RingStep(
                    1 + s, (r - s - 1) % m, True, 1 + s, None)
                assert sched[m + s] == ring.RingStep(
                    m + s, (r - s) % m, False, m + s, None)


@pytest.mark.parametrize("m", [2, 3, 8])
def test_lockstep_schedule_is_hazard_free_too(m):
    """The schedule with every hop also waiting on the right neighbour's
    previous step (each rank at most one step ahead) gives the same bits:
    the waits ``hop_schedule`` leaves out are implied by the left waits'
    chain around the ring."""
    rows, masks = _inputs(m, 11)

    def lockstep(m, r):
        return tuple(st._replace(wait_right=st.t)
                     for st in ring.hop_schedule(m, r))

    for seed in range(4):
        a, hazards = run_protocol(m, rows, masks, seed, lockstep)
        b, _ = run_protocol(m, rows, masks, seed)
        assert hazards == []
        assert all((x.view(np.int32) == y.view(np.int32)).all()
                   for xs, ys in zip(a, b) for x, y in zip(xs, ys))


class _FakeLib:
    """Records the ring's C entry points as ``_ring_group_cuda`` calls
    them; the staging pointers are small integers named after the rank."""

    def __init__(self, r):
        self.r = r
        self.calls = []

    def vq_ring_sync_caps(self, caps):
        caps[0], caps[1] = 1, 0
        return 0

    def vq_ring_alloc(self, nbytes, out):
        out._obj.value = 1000 + self.r
        return 0

    def vq_ring_export(self, ptr, handle):
        handle.raw = bytes([ptr - 1000]) * 64
        return 0

    def vq_ring_open(self, handle, out):
        out._obj.value = 1000 + handle.raw[0]
        return 0

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, *args))
            return 0
        return record


class _FakeEvent:
    """A timing event whose ``record`` is logged in the fake library's
    call list."""

    def __init__(self, lib):
        self.lib = lib

    def record(self):
        self.lib.calls.append(("record", self))


def _fake_cuda_route(monkeypatch, m, r):
    """``_ring_group_cuda`` on rank r of M with its kernel library, stream,
    events and handle exchange faked; any host wait inside a call raises.
    Returns (the library, the groups whose handles were exchanged)."""
    lib = _FakeLib(r)
    monkeypatch.setattr(ring._build, "library", lambda: lib)
    monkeypatch.setattr(ring._build, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(ring._build, "current_stream", lambda dev: 77)
    monkeypatch.setattr(ring, "_flush", None)
    monkeypatch.setattr(ring, "_staging", {})
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing: _FakeEvent(lib))
    exchanged = []

    def all_gather_object(out, obj, group=None):
        exchanged.append(group)
        for i in range(len(out)):
            out[i] = bytes([i]) * 64

    def refuse(*a, **k):
        raise AssertionError("a host wait inside a call")

    monkeypatch.setattr(ring.dist, "all_gather_object", all_gather_object)
    monkeypatch.setattr(ring.dist, "barrier", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    return lib, exchanged


@pytest.mark.parametrize("m", [2, 3, 8])
def test_cuda_driver_loop_enqueues_the_schedule(monkeypatch, m):
    """``_ring_group_cuda`` on rank r, its kernel library faked: three calls
    enqueue one ``vq_ring_step`` for each step of ``hop_schedule`` (its
    waits, 0 where it has none, its chunk or -1 for the stage, its counter
    write), then the copy, with call k's sequence numbers from k (2M - 1);
    the hop counter counts 2 (M - 1) a call; no event is recorded while
    ``step_events`` is None; no barrier, no synchronize and no other
    collective after the first call's handle exchange."""
    r = m - 1
    lib, exchanged = _fake_cuda_route(monkeypatch, m, r)
    monkeypatch.setattr(ring, "step_events", None)
    group = object()
    left, right, mine = 1000 + (r - 1) % m, 1000 + (r + 1) % m, 1000 + r
    chunk = -(-N // m)
    x = torch.zeros(N)
    before = ring.launches_ring_hop
    for k in range(CALLS):
        lib.calls.clear()
        ring._ring_group_cuda(x, None, group, m, r, N, chunk)
        base = k * (2 * m - 1)
        want = []
        for st in ring.hop_schedule(m, r):
            want.append(("vq_ring_step",
                         left, 0 if st.wait_left is None
                         else base + st.wait_left,
                         right, 0 if st.wait_right is None
                         else base + st.wait_right, 0,
                         x.data_ptr(), None, N, m,
                         -1 if st.chunk is None else st.chunk, chunk,
                         int(st.add), mine, base + st.t + 1, 77))
        assert lib.calls[:-1] == want
        assert lib.calls[-1][0] == "vq_ring_copy_f32"
        assert lib.calls[-1][2:] == (mine, N, 77)
    assert exchanged == [group]
    assert ring.launches_ring_hop - before == CALLS * 2 * (m - 1)


@pytest.mark.parametrize("m", [2, 8])
def test_step_events_time_every_step(monkeypatch, m):
    """With ``step_events`` a list, each step of a call is enqueued between
    the two timing events that the loop appends, one pair a step, and the
    steps themselves are those of the untimed loop."""
    r = 0
    lib, _ = _fake_cuda_route(monkeypatch, m, r)
    events = []
    monkeypatch.setattr(ring, "step_events", events)
    chunk = -(-N // m)
    x = torch.zeros(N)
    for k in range(2):
        lib.calls.clear()
        ring._ring_group_cuda(x, None, object(), m, r, N, chunk)
        body = lib.calls[:-1]
        assert len(events) == (k + 1) * (2 * m - 1)
        assert len(body) == 3 * (2 * m - 1)
        for i, (a, b) in enumerate(events[k * (2 * m - 1):]):
            assert body[3 * i] == ("record", a)
            assert body[3 * i + 1][0] == "vq_ring_step"
            assert body[3 * i + 2] == ("record", b)
