"""The port's observability layer (``repro_torch.obs`` and its hooks) held
against ``repro.obs`` and the reference executors' instrumentation,
mirroring ``tests/test_obs.py``.

The unit tests of ``tests/test_obs.py`` run on the port's own copies of
the tracer, the metrics registry and the trace checker.  Then the hooks:
an observed ``MeshExecutor`` run equals a bare one bit for bit; the same
run in both packages (numpy inputs from a seed, the reference's round
lengths for eq. 9) gives the same metric names, labels and kinds, the
same counters exactly (``comm_*`` too, whatever the port's log folds),
the same histogram counts, distortions at ``rtol=1e-4``, the same
modeled tick-timeline spans exactly (name, start, duration, track and
attributes) and the same set of wall-span names (the reference's
``compile`` has no counterpart: eager PyTorch compiles nothing).  Every
port trace passes ``check_trace``.  The runs: sync delta, eq. 9, an
8 -> 4 -> 8 elastic run, a chaos run, a dynamic merge and a two-tier
hierarchical run.

Two differences are pinned rather than hidden.  The port scores eq. 9's
shared version every ``eval_every`` ticks as its loop passes them, one
"eval" collective each, where the reference reduces the stacked curve once
at the end, so the eq.-9 "eval" records carry the same bytes in
``n_evals`` calls against the reference's one.  And on the reference's
chunked publish path (an elastic run with ``checkpoint_every``) a chunk
program that JAX traces again on a cache hit appends its records a second
time, so the reference's ``comm_*`` (and its own ``last_comm``) count more
merges than it ran windows; the port's count one a window.
"""

import concurrent.futures
import json
import pathlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.engine import ChaosNetwork as JChaosNetwork
from repro.engine import ChaosSchedule as JSchedule
from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMesh
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.topology import Topology as JTopology
from repro_torch import comm, interop
from repro_torch.comm.api import CommLog, CommRecord
from repro_torch.engine import (ChaosNetwork, ChaosSchedule,
                                ElasticMeshExecutor, GeometricDelayNetwork,
                                InstantNetwork, Topology)
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.engine.sim import SimExecutor
from repro_torch.obs import (NULL_TRACER, CounterEvent, ExitFlush,
                             MetricsRegistry, SpanEvent, Tracer, check_trace,
                             format_metric, load_jsonl, load_trace)
from repro_torch.obs import check as obs_check
from repro_torch.serve.loadgen import run_load

torch.set_num_threads(1)

TAU, D, KAPPA = 10, 8, 16
RTOL, ATOL = 1e-4, 1e-6
REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Tracer (tests/test_obs.py, on the port's copy)
# ---------------------------------------------------------------------------

def test_wall_spans_nest_and_time_monotonically():
    tr = Tracer()
    with tr.span("outer", kind="test"):
        with tr.span("inner"):
            time.sleep(0.002)
        assert tr.open_spans == 1
    assert tr.open_spans == 0
    outer, = tr.spans("outer")
    inner, = tr.spans("inner")
    assert outer.attrs == {"kind": "test"}
    assert inner.start_us >= outer.start_us
    assert inner.dur_us >= 2_000 * 0.5          # slept 2ms (timer slack)
    assert outer.dur_us >= inner.dur_us
    assert inner.start_us + inner.dur_us <= outer.start_us + outer.dur_us + 1


def test_modeled_spans_and_counters():
    tr = Tracer()
    tr.add_span("compute", 0.0, 10.0, track="worker 0", window=0)
    tr.add_span("merge", 10.0, -3.0, track="worker 0")   # clamped to 0
    tr.counter("distortion", 1.5, ts_us=10.0)
    assert tr.spans("merge")[0].dur_us == 0.0
    assert tr.spans("compute")[0].process == Tracer.TICK_PROCESS
    c, = tr.counters("distortion")
    assert (c.value, c.ts_us) == (1.5, 10.0)


def test_null_tracer_is_inert():
    with NULL_TRACER.span("x") as ev:
        assert ev is None
    NULL_TRACER.add_span("y", 0.0, 1.0, track="t")
    NULL_TRACER.add_spans(1, lambda: [])
    NULL_TRACER.counter("z", 1.0)
    assert NULL_TRACER.spans() == [] and NULL_TRACER.counters() == []


def test_wall_spans_use_thread_name_as_track():
    tr = Tracer()

    def work():
        with tr.span("threaded"):
            pass

    t = threading.Thread(target=work, name="worker-7")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert tr.spans("threaded")[0].track == "worker-7"


def test_chrome_export_roundtrip_names_every_lane(tmp_path):
    tr = Tracer()
    with tr.span("run"):
        pass
    tr.add_span("window", 0.0, 5.0, track="worker 0")
    tr.add_span("merge", 2.0, 3.0, track="merge flat", tier="flat",
                wire_bytes=64)
    tr.counter("distortion", 2.0, ts_us=5.0)
    path = tmp_path / "out.trace.json"
    tr.export_chrome(str(path))
    events = load_trace(str(path))
    assert check_trace(events, expect_merge_tiers={"flat"},
                       expect_counters=["distortion"]) == []
    assert {e["ph"] for e in events} == {"M", "X", "C"}
    assert json.loads(path.read_text())["displayTimeUnit"] == "ms"


def test_unclosed_span_is_marked_and_flagged():
    tr = Tracer()
    cm = tr.span("dangling")
    cm.__enter__()                       # never exited
    (x,) = [e for e in tr.chrome_events() if e["ph"] == "X"]
    assert x["args"]["unclosed"] is True
    assert any("never closed" in e for e in check_trace(tr.chrome_events()))


def test_tracer_buffers_drop_oldest_with_count():
    t = Tracer(max_spans=5, max_counters=3)
    for i in range(12):
        t.add_span(f"s{i}", 0.0, 1.0, track="tk")
        t.counter("c", float(i))
    spans = t.spans()
    assert len(spans) == 5 and t.dropped_spans == 7
    assert [e.name for e in spans] == [f"s{i}" for i in range(7, 12)]
    assert len(t.counters()) == 3 and t.dropped_counters == 9
    assert [c.value for c in t.counters()] == [9.0, 10.0, 11.0]
    with t.span("w"):
        pass
    assert len(t.spans()) == 5 and t.dropped_spans == 8
    assert t.spans()[-1].name == "w"


def test_tracer_bounds_validate():
    with pytest.raises(ValueError):
        Tracer(max_spans=0)
    with pytest.raises(ValueError):
        Tracer(max_counters=0)


def test_exit_flush_requires_a_sink():
    with pytest.raises(ValueError):
        ExitFlush()


def test_exit_flush_writes_once_and_is_idempotent(tmp_path):
    t = Tracer()
    t.add_span("a", 0.0, 1.0, track="tk")
    reg = MetricsRegistry()
    reg.counter("x").inc(3)
    tp, mp = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    fl = ExitFlush(tracer=t, trace_path=tp, metrics=reg, metrics_path=mp,
                   run="r1")
    assert fl.flush() == {"trace": tp, "metrics": mp}
    assert [s["name"] for s in load_trace(tp) if s.get("ph") == "X"] == ["a"]
    rows = load_jsonl(mp)
    assert rows[-1]["name"] == "x" and rows[-1]["value"] == 3
    assert fl.flush() == {}
    assert len(load_jsonl(mp)) == len(rows)


def test_exit_flush_context_manager_flushes_on_exception(tmp_path):
    t = Tracer()
    t.add_span("died", 0.0, 1.0, track="tk")
    tp = str(tmp_path / "t.json")
    with pytest.raises(RuntimeError):
        with ExitFlush(tracer=t, trace_path=tp):
            raise RuntimeError("chaos kill")
    assert [s["name"] for s in load_trace(tp)
            if s.get("ph") == "X"] == ["died"]


# ---------------------------------------------------------------------------
# Tracer.add_spans: deferred blocks are the eager spans
# ---------------------------------------------------------------------------

def _block(lo, hi):
    return [SpanEvent(f"s{i}", float(i), 1.0, "ticks", "tk", {"i": i})
            for i in range(lo, hi)]


def test_deferred_block_equals_eager_spans_in_order():
    eager, lazy = Tracer(), Tracer()
    built = []
    for tr, deferred in ((eager, False), (lazy, True)):
        tr.add_span("first", 0.0, 1.0, track="tk")
        if deferred:
            tr.add_spans(4, lambda: built.append(1) or _block(0, 4))
        else:
            for ev in _block(0, 4):
                tr.add_span(ev.name, ev.start_us, ev.dur_us, track="tk",
                            **ev.attrs)
        tr.add_span("last", 9.0, 1.0, track="tk")
    assert built == []                   # nothing built before a read
    assert lazy.chrome_events() == eager.chrome_events()
    assert lazy.spans() == eager.spans() and built == [1]   # built once


@pytest.mark.parametrize("cap", [2, 5, 7])
def test_deferred_blocks_trim_as_eager_spans(cap):
    eager, lazy = Tracer(max_spans=cap), Tracer(max_spans=cap)
    for lo in (0, 3, 6):
        for ev in _block(lo, lo + 3):
            eager.add_span(ev.name, ev.start_us, ev.dur_us, track="tk",
                           **ev.attrs)
        lazy.add_spans(3, lambda lo=lo: _block(lo, lo + 3))
    assert lazy.spans() == eager.spans()
    assert lazy.dropped_spans == eager.dropped_spans == 9 - cap


def test_deferred_counters_equal_eager_and_trim_alike():
    eager, lazy = Tracer(max_counters=4), Tracer(max_counters=4)
    for lo in (0, 3):
        for i in range(lo, lo + 3):
            eager.counter("c", float(i), ts_us=float(i))
        lazy.add_counters(3, lambda lo=lo: [
            CounterEvent("c", float(i), float(i), "ticks")
            for i in range(lo, lo + 3)])
    assert lazy.counters() == eager.counters()
    assert lazy.dropped_counters == eager.dropped_counters == 2
    assert lazy.chrome_events() == eager.chrome_events()


def test_bulk_metrics_equal_one_by_one():
    values = np.concatenate([np.exp(np.random.default_rng(1).normal(
        0.0, 2.0, size=500)), [0.0, -1.0, 1e-13, 7.0]])
    one, bulk = MetricsRegistry(), MetricsRegistry()
    for v in values:
        one.histogram("h").observe(float(v))
        one.gauge("g").set(float(v))
    bulk.histogram("h").observe_many(values[:200])
    bulk.histogram("h").observe_many(values[200:])
    bulk.gauge("g").set_many(values)
    bulk.histogram("h").observe_many([])
    a, b = one.histogram("h"), bulk.histogram("h")
    assert a._buckets == b._buckets
    assert (a.count, a.min, a.max) == (b.count, b.min, b.max)
    np.testing.assert_allclose(b.total, a.total, rtol=1e-12)
    assert one.gauge("g").snapshot() == bulk.gauge("g").snapshot()


def test_deferred_block_of_the_wrong_size_raises():
    tr = Tracer()
    tr.add_spans(3, lambda: _block(0, 2))
    with pytest.raises(RuntimeError, match="built 2 spans, declared 3"):
        tr.spans()


# ---------------------------------------------------------------------------
# MetricsRegistry (tests/test_obs.py, on the port's copy)
# ---------------------------------------------------------------------------

def test_counter_and_gauge_semantics():
    reg = MetricsRegistry()
    reg.counter("wire", tier=0).inc(10)
    reg.counter("wire", tier=0).inc(5)
    reg.counter("wire", tier=1).inc(1)
    assert reg.counter("wire", tier=0).value == 15
    g = reg.gauge("depth")
    for v in (3.0, 1.0, 2.0):
        g.set(v)
    snap = g.snapshot()
    assert (snap["value"], snap["min"], snap["max"], snap["n"]) == \
        (2.0, 1.0, 3.0, 3)


def test_histogram_quantiles_track_numpy_within_bucket_error():
    samples = np.exp(np.random.default_rng(0).normal(0.0, 1.0, size=4000))
    h = MetricsRegistry().histogram("lat")
    for v in samples:
        h.observe(float(v))
    for q in (0.50, 0.99):
        exact = float(np.quantile(samples, q))
        assert abs(h.quantile(q) - exact) / exact < 0.06
    assert h.count == len(samples)
    np.testing.assert_allclose(h.mean, samples.mean(), rtol=1e-6)


def test_histogram_edge_cases():
    h = MetricsRegistry().histogram("x")
    assert h.quantile(0.5) == 0.0
    h.observe(7.0)
    assert h.quantile(0.0) == h.quantile(1.0) == 7.0
    h2 = MetricsRegistry().histogram("y")
    h2.observe(0.0)
    h2.observe(-1.0)
    assert h2.quantile(0.5) == 0.0
    assert (h2.min, h2.max) == (-1.0, 0.0)
    with pytest.raises(ValueError):
        h2.quantile(1.5)


def test_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("m", a=1)
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("m", a=1)
    reg.gauge("m", a=2)


def test_format_metric_and_summary_table():
    assert format_metric("wire", {}) == "wire"
    assert format_metric("wire", {"tier": 1, "tag": "merge"}) == \
        "wire{tag=merge, tier=1}"
    reg = MetricsRegistry()
    reg.counter("c").inc(2)
    reg.gauge("g").set(0.5)
    reg.histogram("h").observe(1.0)
    table = reg.summary_table()
    for needle in ("metric", "c", "g", "h", "p50", "p99"):
        assert needle in table


def test_jsonl_sink_appends_and_roundtrips(tmp_path):
    path = tmp_path / "metrics.jsonl"
    reg = MetricsRegistry()
    reg.counter("n").inc(1)
    assert reg.dump_jsonl(str(path), run="a") == 1
    reg.counter("n").inc(1)
    assert reg.dump_jsonl(str(path), run="b") == 1
    rows = load_jsonl(str(path))
    assert [(r["run"], r["value"]) for r in rows] == [("a", 1.0), ("b", 2.0)]
    reg.dump_jsonl(str(path), append=False)
    assert len(load_jsonl(str(path))) == 1


# ---------------------------------------------------------------------------
# check_trace (tests/test_obs.py, on the port's copy)
# ---------------------------------------------------------------------------

def _meta(pid, tid=None):
    if tid is None:
        return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"p{pid}"}}
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"t{tid}"}}


def _x(name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def test_check_trace_accepts_clean_nesting():
    assert check_trace([_meta(1), _meta(1, 1), _x("outer", 0.0, 10.0),
                        _x("inner", 2.0, 3.0), _x("later", 6.0, 4.0)]) == []


def test_check_trace_flags_each_violation():
    errs = check_trace([_meta(1), _meta(1, 1),
                        _x("merge", 0.0, 1.0, wire_bytes=8),
                        _x("merge", 2.0, 1.0, tier=0, wire_bytes=-4)])
    assert any("missing 'tier'" in e for e in errs)
    assert any("wire_bytes" in e for e in errs)
    errs = check_trace([_meta(1), _meta(1, 1),
                        _x("a", 0.0, 5.0), _x("b", 3.0, 5.0)])
    assert any("straddles" in e for e in errs)
    errs = check_trace([_x("a", 0.0, 1.0, pid=9, tid=9)])
    assert any("no process_name" in e for e in errs)
    assert any("no thread_name" in e for e in errs)
    errs = check_trace([{"ph": "B", "name": "a", "ts": 0, "pid": 1,
                         "tid": 1}])
    assert any("begin/end" in e for e in errs)
    errs = check_trace([_meta(1), _meta(1, 1), _x("a", 0.0, -1.0)])
    assert any("bad dur" in e for e in errs)
    errs = check_trace([{"ph": "C", "name": "c", "pid": 1, "tid": 0,
                         "args": {"c": 1.0}}])
    assert any("no numeric ts" in e for e in errs)


def test_check_trace_expectations():
    events = [_meta(1), _meta(1, 1),
              _x("merge", 0.0, 1.0, tier=0, wire_bytes=8),
              {"ph": "C", "name": "distortion", "ts": 1.0, "pid": 1,
               "tid": 0, "args": {"distortion": 2.0}}]
    assert check_trace(events, expect_merge_tiers={"0"},
                       expect_counters=["distortion"]) == []
    errs = check_trace(events, expect_merge_tiers={"0", "1"},
                       expect_counters=["codebook_divergence"])
    assert any("expected merge tiers ['1']" in e for e in errs)
    assert any("codebook_divergence" in e for e in errs)


def test_check_cli_exit_codes(tmp_path, capsys):
    tr = Tracer()
    tr.add_span("merge", 0.0, 1.0, track="t", tier="flat", wire_bytes=0)
    good = tmp_path / "good.json"
    tr.export_chrome(str(good))
    assert obs_check.main([str(good), "--expect-merge-tiers", "flat"]) == 0
    assert "OK" in capsys.readouterr().out
    assert obs_check.main([str(good), "--expect-merge-tiers", "0,1",
                           "--expect-counter", "distortion"]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "distortion" in out
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert obs_check.main([str(bad)]) == 1


def test_no_wall_clock_timing_under_the_port():
    """Span math and latencies use the monotonic clocks (the reference's
    test scans all of ``src/``; this one names the port's files)."""
    offenders = [str(p) for p in sorted((REPO / "src" / "repro_torch")
                                        .rglob("*.py"))
                 if "time.time(" in p.read_text()]
    assert offenders == []


# ---------------------------------------------------------------------------
# CommLog's metrics mirror
# ---------------------------------------------------------------------------

def _rec(tag="merge", calls=1, tier=None, wire=14):
    return CommRecord(op="sum", transport="xla", axis="workers",
                      participants=8, logical_bytes=8, wire_bytes=wire,
                      calls=calls, tag=tag, tier=tier)


def _counters(reg):
    return {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in reg.snapshot() if r["kind"] == "counter"}


def test_mirror_counts_folded_records_once_at_the_end():
    log, reg = CommLog(), MetricsRegistry()
    log.append(_rec())                   # before the attach: not mirrored
    log.attach_metrics(reg)
    mark = log.mark()
    for _ in range(5):
        log.append(_rec())
    log.append(_rec(tag="eval", wire=7))
    assert reg.snapshot() == []          # nothing until the mirror
    log.mirror_metrics()
    log.mirror_metrics()                 # idempotent
    want = CommLog.summarize(log.since(mark))["by_tag"]
    got = _counters(reg)
    for tag in ("merge", "eval"):
        labels = (("tag", tag), ("tier", "flat"), ("transport", "xla"))
        assert got[("comm_wire_bytes", labels)] == want[tag]["wire_bytes"]
        assert got[("comm_calls", labels)] == want[tag]["calls"]
        assert (got[("comm_logical_bytes", labels)]
                == want[tag]["logical_bytes"])
    # a mirrored record never folds again: a later repeat is a new record
    log.append(_rec())
    assert len(log.since(mark)) == 3


def test_mirror_backs_out_rewritten_records():
    log, reg = CommLog(), MetricsRegistry()
    log.attach_metrics(reg)
    mark = log.mark()
    for _ in range(4):
        log.append(_rec())
    log.append(_rec(tag="probe", wire=7))
    log.mirror_metrics()
    log.append(_rec(tag="eval", wire=3))   # after the mirror
    log.rewrite_since(mark, lambda r: (CommRecord(**{**r.__dict__,
                                                     "calls": 1})
                                       if r.tag == "merge" else r))
    log.rewrite_since(mark, lambda r: None if r.tag == "probe" else r)
    log.mirror_metrics()
    got = _counters(reg)
    merge = (("tag", "merge"), ("tier", "flat"), ("transport", "xla"))
    probe = (("tag", "probe"), ("tier", "flat"), ("transport", "xla"))
    evl = (("tag", "eval"), ("tier", "flat"), ("transport", "xla"))
    assert got[("comm_calls", merge)] == 1
    assert got[("comm_wire_bytes", merge)] == 14
    assert got[("comm_calls", probe)] == 0
    assert got[("comm_wire_bytes", evl)] == 3


# ---------------------------------------------------------------------------
# the hooks: observing changes no bit, and matches the reference
# ---------------------------------------------------------------------------

def _setup(m, n=200, seed=42, n_eval=100):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def _port(w0, data, eval_data):
    return interop.from_reference(w0, data, eval_data, device="cpu")


def _ref_lengths(m, n, fold=9):
    key = jax.random.fold_in(jax.random.PRNGKey(42), fold)
    return key, JGeometric(0.5).round_lengths(key, m, n // TAU + 2, TAU)


def _same_bits(a, b):
    return (torch.equal(a.distortion.view(torch.int32),
                        b.distortion.view(torch.int32))
            and torch.equal(a.w_shared.view(torch.int32),
                            b.w_shared.view(torch.int32))
            and torch.equal(a.wall_ticks, b.wall_ticks))


@pytest.mark.parametrize("scheme", ["delta", "async_delta"])
def test_observed_mesh_run_equals_bare_bitwise_and_trace_is_clean(scheme):
    m = 4
    ins = _port(*_setup(m))
    _, lengths = _ref_lengths(m, 200)
    kw = {"tau": TAU, "lengths": interop.lengths_from_reference(lengths)}
    bare = MeshExecutor(InstantNetwork(), device="cpu").run(scheme, *ins,
                                                            **kw)
    tr, reg = Tracer(), MetricsRegistry()
    obs = MeshExecutor(InstantNetwork(), tracer=tr, metrics=reg,
                       device="cpu").run(scheme, *ins, **kw)
    assert _same_bits(obs, bare)
    expect = (["distortion"] if scheme == "async_delta"
              else ["distortion", "codebook_divergence"])
    assert check_trace(tr.chrome_events(), expect_merge_tiers={"flat"},
                       expect_counters=expect) == []
    if scheme == "async_delta":
        assert reg.counter("async_rounds_total", scheme=scheme).value > 0
    else:
        assert reg.counter("windows_total", scheme=scheme).value == 20
        assert reg.gauge("codebook_divergence", scheme=scheme).n == 20
        assert {s.track for s in tr.spans("window")} == {
            f"worker {w}" for w in range(m)}


def test_divergence_kernel_plain_matches_the_reference_expression():
    """The divergence kernel's plain version (its wrapper's CPU route) is
    the reference's ``jnp.sum((w_fin - w_srd) ** 2)`` per worker
    (``repro/engine/mesh.py:590``)."""
    import jax.numpy as jnp

    from repro_torch.kernels import ops, vq_fused

    rng = np.random.default_rng(3)
    w_fin = rng.standard_normal((5, KAPPA, D)).astype(np.float32)
    w_srd = rng.standard_normal((KAPPA, D)).astype(np.float32)
    want = [float(jnp.sum((jnp.asarray(w) - jnp.asarray(w_srd)) ** 2))
            for w in w_fin]
    before = vq_fused.launches_divergence
    for fn in (ops.vq_divergence, vq_fused.vq_divergence):
        got = fn(torch.from_numpy(w_fin), torch.from_numpy(w_srd))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert vq_fused.launches_divergence == before    # CPU: no launch
    with pytest.raises(ValueError, match="vq_divergence takes"):
        ops.vq_divergence(torch.from_numpy(w_fin),
                          torch.from_numpy(w_srd[:, :4]))
    with pytest.raises(ValueError, match="vq_divergence takes"):
        ops.vq_divergence(torch.from_numpy(w_fin).double(),
                          torch.from_numpy(w_srd).double())


def _index(reg):
    return {(r["name"], tuple(sorted(r["labels"].items())), r["kind"]): r
            for r in reg.snapshot()}


def _modeled(tr):
    return sorted((s.name, s.start_us, s.dur_us, s.track,
                   tuple(sorted(s.attrs.items())))
                  for s in tr.spans() if s.process == "ticks")


def _wall_names(tr):
    return {s.name for s in tr.spans() if s.process == "host"} - {"compile"}


def _held_to_reference(tr, reg, jtr, jreg, *, eval_calls=None,
                       comm_exact=True):
    """Names, labels and kinds equal; counters exact; histogram counts
    equal, distortions at RTOL and divergences at RTOL, ATOL (the
    difference of two close codebooks cancels); modeled spans exact;
    wall-span names
    equal; counter series on the same timestamps; the trace clean.
    ``eval_calls``: the port's eq.-9 "eval" call count; ``comm_exact``
    False skips the ``comm_*`` values (the module docstring's two
    differences)."""
    ours, theirs = _index(reg), _index(jreg)
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        name, labels, kind = key
        got = ours[key]
        if kind == "counter":
            if name.startswith("comm_") and not comm_exact:
                continue
            if (name == "comm_calls" and eval_calls is not None
                    and dict(labels)["tag"] == "eval"):
                assert got["value"] == eval_calls, key
            else:
                assert got["value"] == want["value"], key
        elif kind == "histogram":
            assert got["count"] == want["count"], key
            if name == "distortion":
                for f in ("mean", "min", "max"):
                    np.testing.assert_allclose(got[f], want[f], rtol=RTOL,
                                               err_msg=str(key))
        else:
            assert got["n"] == want["n"], key
            if name == "tier1_frac":
                assert got["value"] == want["value"]
            elif name == "codebook_divergence":
                for f in ("value", "min", "max"):
                    np.testing.assert_allclose(got[f], want[f], rtol=RTOL,
                                               atol=ATOL, err_msg=str(key))
    assert _modeled(tr) == _modeled(jtr)
    assert _wall_names(tr) == _wall_names(jtr)
    series = {c.name for c in jtr.counters()}
    assert {c.name for c in tr.counters()} == series
    for name in series:
        got, want = tr.counters(name), jtr.counters(name)
        assert [c.ts_us for c in got] == [c.ts_us for c in want], name
        if name == "distortion":
            np.testing.assert_allclose([c.value for c in got],
                                       [c.value for c in want], rtol=RTOL)
        elif name == "codebook_divergence":
            np.testing.assert_allclose([c.value for c in got],
                                       [c.value for c in want], rtol=RTOL,
                                       atol=ATOL)
        else:
            assert [c.value for c in got] == [c.value for c in want], name
    assert check_trace(tr.chrome_events()) == []


def _observed(ex_cls, *args, jax_cls, jargs=(), **kw):
    tr, reg, jtr, jreg = Tracer(), MetricsRegistry(), JTracer(), JRegistry()
    ours = ex_cls(*args, tracer=tr, metrics=reg, device="cpu", **kw)
    theirs = jax_cls(*jargs, tracer=jtr, metrics=jreg,
                     **{k: v for k, v in kw.items() if k != "max_workers"})
    return ours, theirs, (tr, reg, jtr, jreg)


def test_sync_delta_run_matches_reference_obs():
    w0, data, eval_data = _setup(4)
    ours, theirs, obs = _observed(MeshExecutor, InstantNetwork(),
                                  jax_cls=JMesh, jargs=(None, "workers",
                                                        JInstant()))
    ours.run("delta", *_port(w0, data, eval_data), tau=TAU)
    theirs.run("delta", w0, data, eval_data, tau=TAU)
    _held_to_reference(*obs)
    assert obs[1].counter("windows_total", scheme="delta").value == 20


def test_dynamic_merge_matches_reference_obs():
    """Re-priced merge records: the mirror backs the rewrite out."""
    w0, data, eval_data = _setup(4)
    kw = {"merge": "dynamic", "divergence_thresh": 1e-3, "max_stale": 4}
    ours, theirs, obs = _observed(MeshExecutor, InstantNetwork(),
                                  jax_cls=JMesh,
                                  jargs=(None, "workers", JInstant()), **kw)
    ours.run("delta", *_port(w0, data, eval_data), tau=TAU)
    theirs.run("delta", w0, data, eval_data, tau=TAU)
    _held_to_reference(*obs)
    reg = obs[1]
    trig = reg.counter("divergence_trigger", scheme="delta").value
    assert 0 < trig < 20
    assert reg.counter("merge_skipped_total", scheme="delta").value == \
        20 - trig


def test_async_run_matches_reference_obs():
    m, n = 4, 200
    w0, data, eval_data = _setup(m, n=n)
    key, lengths = _ref_lengths(m, n)
    ours, theirs, obs = _observed(MeshExecutor, GeometricDelayNetwork(0.5),
                                  jax_cls=JMesh,
                                  jargs=(None, "workers", JGeometric(0.5)))
    ours.run("async_delta", *_port(w0, data, eval_data), tau=TAU,
             lengths=interop.lengths_from_reference(lengths))
    theirs.run("async_delta", w0, data, eval_data, tau=TAU, key=key)
    _held_to_reference(*obs, eval_calls=n // 10)
    rounds = int((np.cumsum(np.asarray(lengths), axis=1) <= n).sum())
    assert obs[1].counter("async_rounds_total",
                          scheme="async_delta").value == rounds


@pytest.mark.parametrize("checkpoint_every", [None, 5])
def test_elastic_8_4_8_run_matches_reference_obs(tmp_path, checkpoint_every):
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    from repro_torch.checkpoint import Checkpointer

    w0, data, eval_data = _setup(8)
    schedule = [(7, 4), (14, 8)]
    tr, reg, jtr, jreg = Tracer(), MetricsRegistry(), JTracer(), JRegistry()
    ours = ElasticMeshExecutor(
        schedule, network=InstantNetwork(), tracer=tr, metrics=reg,
        checkpointer=Checkpointer(str(tmp_path / "t")),
        checkpoint_every=checkpoint_every, device="cpu")
    theirs = JElastic(schedule, network=JInstant(), tracer=jtr,
                      metrics=jreg,
                      checkpointer=JCheckpointer(str(tmp_path / "j")),
                      checkpoint_every=checkpoint_every)
    res = ours.run("delta", *_port(w0, data, eval_data), tau=TAU)
    theirs.run("delta", w0, data, eval_data, tau=TAU)
    _held_to_reference(tr, reg, jtr, jreg,
                       comm_exact=checkpoint_every is None)
    windows = len(res.distortion)
    assert reg.counter("windows_total", scheme="delta").value == windows
    assert reg.counter("comm_calls", tag="merge", tier="flat",
                       transport="xla").value == windows
    assert reg.counter("resize_events").value == len(ours.resize_events) == 2
    assert reg.counter("late_delta_points").value == sum(
        e.late_points for e in ours.resize_events) == 40
    assert [(s.attrs["old_m"], s.attrs["new_m"]) for s in tr.spans("resize")
            ] == [(e.old_m, e.new_m) for e in ours.resize_events]
    if checkpoint_every:
        saves = [s for s in tr.spans("checkpoint") if s.attrs.get("periodic")]
        assert reg.counter("periodic_checkpoints").value == len(saves) > 0


def test_chaos_run_matches_reference_obs():
    """Kills as resizes and the quorum merge's late matrix.  The
    reference counts a kill twice in ``chaos_kills``: once at its resize
    and once as a scheduled event of the segment that starts there."""
    m, n = 8, 400
    w0, data, eval_data = _setup(m, n=n)
    spec = "7:kill=2,slow=1,part=1"
    sched = ChaosSchedule.from_spec(spec, windows=n // TAU, m=m, hosts=2)
    jsched = JSchedule.from_spec(spec, windows=n // TAU, m=m, hosts=2)
    tr, reg, jtr, jreg = Tracer(), MetricsRegistry(), JTracer(), JRegistry()
    ours = ElasticMeshExecutor(
        [], network=ChaosNetwork(InstantNetwork(), sched), chaos=sched,
        merge="quorum", tracer=tr, metrics=reg, device="cpu")
    theirs = JElastic([], network=JChaosNetwork(JInstant(), jsched),
                      chaos=jsched, merge="quorum", tracer=jtr, metrics=jreg)
    ours.run("delta", *_port(w0, data, eval_data), tau=TAU)
    theirs.run("delta", w0, data, eval_data, tau=TAU)
    _held_to_reference(tr, reg, jtr, jreg)
    kills = len(sched.kill_events)
    assert reg.counter("chaos_kills").value == 2 * kills
    assert reg.counter("chaos_late_worker_windows").value == \
        ours.last_late_worker_windows
    assert [s.attrs["cause"] for s in tr.spans("resize")] == \
        ["chaos_kill"] * kills


def test_hier_metrics_mirror_is_single_counted():
    """The registry is attached at the top level only, so the mirrored
    per-tier counters equal the run's summary and the reference's."""
    m = 8
    w0, data, eval_data = _setup(m)
    topo = Topology.from_spec(m, hosts=2)
    jtopo = JTopology.from_spec(m, hosts=2)
    reg, jreg = MetricsRegistry(), JRegistry()
    ex = MeshExecutor(InstantNetwork(), transport=comm.HierarchicalTransport(
        "xla", "xla", topology=topo), metrics=reg, device="cpu")
    ex.run("delta", *_port(w0, data, eval_data), tau=TAU)
    jex = JMesh(topology=jtopo, network=JInstant(), metrics=jreg,
                transport=jcomm.HierarchicalTransport(
                    tier0="xla", tier1="xla", host_axis=jtopo.host_axis,
                    worker_axis=jtopo.worker_axis))
    jex.run("delta", w0, data, eval_data, tau=TAU)
    merge = ex.last_comm["by_tag"]["merge"]
    assert set(merge["by_tier"]) == {0, 1}
    for tier, t in merge["by_tier"].items():
        c = reg.counter("comm_wire_bytes", tag="merge", tier=tier,
                        transport="xla")
        assert c.value == t["wire_bytes"] == jreg.counter(
            "comm_wire_bytes", tag="merge", tier=tier,
            transport="xla").value
    assert _counters(reg) == _counters(jreg)


def test_sim_executor_obs_names_match_reference():
    from repro.engine import SimExecutor as JSim

    w0, data, eval_data = _setup(4)
    tr, reg, jtr, jreg = Tracer(), MetricsRegistry(), JTracer(), JRegistry()
    SimExecutor(InstantNetwork(), tracer=tr, metrics=reg, device="cpu").run(
        "delta", *_port(w0, data, eval_data), tau=TAU)
    JSim(JInstant(), tracer=jtr, metrics=jreg).run("delta", w0, data,
                                                   eval_data, tau=TAU)
    assert set(_index(reg)) == set(_index(jreg))
    assert [c.ts_us for c in tr.counters("distortion")] == [
        c.ts_us for c in jtr.counters("distortion")]
    assert _wall_names(tr) == _wall_names(jtr) == {"run"}


# ---------------------------------------------------------------------------
# loadgen (tests/test_obs.py, on the port's run_load)
# ---------------------------------------------------------------------------

class _Resp:
    def __init__(self, version):
        self.version = version


class _StubStore:
    def __init__(self, version=3):
        self.version = version


class _StubService:
    """Duck-typed service: synchronous submit with optional service time."""

    def __init__(self, service_s=0.0, fail=False, version=3):
        self.store = _StubStore(version)
        self.service_s = service_s
        self.fail = fail

    def submit(self, q):
        fut = concurrent.futures.Future()
        if self.fail:
            fut.set_exception(RuntimeError("stub refusal"))
            return fut
        if self.service_s:
            time.sleep(self.service_s)
        fut.set_result(_Resp(self.store.version))
        return fut


def test_loadgen_measures_from_scheduled_arrival():
    tr = Tracer()
    rep = run_load(_StubService(service_s=0.002), n_requests=20, d=4,
                   tick_s=0.0, tracer=tr)
    assert rep.failed == 0 and rep.requests == 20
    assert rep.p99_ms > 1.5 * rep.p50_ms > 0.0
    assert rep.p99_ms >= 0.5 * 20 * 2.0
    assert {s.name for s in tr.spans()} == {"load", "submit", "collect"}
    assert check_trace(tr.chrome_events()) == []


def test_loadgen_all_failed_reports_zero_percentiles():
    reg = MetricsRegistry()
    rep = run_load(_StubService(fail=True), n_requests=5, d=4, metrics=reg)
    assert rep.failed == 5
    assert rep.p50_ms == rep.p99_ms == rep.mean_ms == 0.0
    assert rep.qps == 0.0
    assert reg.counter("serve_load_failed").value == 5
    assert reg.histogram("serve_latency_ms").count == 0


def test_loadgen_single_sample_percentiles_coincide():
    reg = MetricsRegistry()
    rep = run_load(_StubService(version=9), n_requests=1, d=4, metrics=reg)
    assert rep.p50_ms == rep.p99_ms == rep.mean_ms
    assert rep.versions_min == rep.versions_max == 9
    assert rep.versions_monotonic and rep.n_versions == 1
    assert rep.staleness_max == 0
    assert reg.counter("serve_requests").value == 1
    assert reg.histogram("serve_latency_ms").count == 1
    assert reg.gauge("serve_staleness").n == 1
