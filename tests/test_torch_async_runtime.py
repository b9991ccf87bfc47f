"""The port's real-thread runtime (``repro_torch.core.async_runtime``) and
its executor (``repro_torch.engine.threads``), held against
``repro.core.async_runtime`` / ``repro.engine.threads`` and mirroring
``tests/test_async_runtime.py``.

A worker's round, ``worker_round`` (one window-kernel launch; its plain
version on the CPU), equals ``repro.core.vq.window_displacement`` at
``rtol=1e-4, atol=1e-6`` with the same prototypes moved (no assignment
flip).  At M = 1 the step reservation gives the reference's
``default_steps(1 .. 3*tau)`` over three rounds.  ``BlobStore`` versions
and its atomic ``apply`` under 8 x 200 writers.  The reference's three
statistical tests at its sizes (m=4, n=1500, d=6, kappa=12, 1.5 s): the
distortion falls, a 50x straggler lags, communication delays are
tolerated.  The inbox's bound holds, its peak depth recorded.
``ThreadExecutor`` refuses the sync schemes, its ``wall_ticks``
are seconds, and ``async_rounds_total`` is the sum of the pushes; the
launcher's refusals exit 2.  Inputs are numpy draws from a seed, through
``repro_torch.interop``, on the CPU.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vq as jvq
from repro_torch import interop
from repro_torch.core import async_runtime, vq
from repro_torch.engine import get_executor
from repro_torch.launch import train
from repro_torch.obs import MetricsRegistry, Tracer, check_trace

torch.set_num_threads(1)

TAU = 10
RTOL, ATOL = 1e-4, 1e-6
INBOX = async_runtime.INBOX_PER_WORKER


def _setup(m=4, n=1500, d=6, kappa=12, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, d))).astype(np.float32)
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)].copy()
    w0, data, _ = interop.from_reference(w0, data, data[:, :1],
                                         device="cpu")
    return data, w0


@pytest.mark.parametrize("t0", [0, 37, 5000])
def test_worker_round_matches_window_displacement(t0):
    data, w0 = _setup(m=1, n=200, d=8, kappa=16)
    zwin = data[0, :TAU]
    delta, w_end = async_runtime.worker_round(w0, zwin, t0)
    j_delta, j_end = jvq.window_displacement(
        jnp.asarray(w0.numpy()), jnp.asarray(zwin.numpy()),
        jnp.asarray(t0, jnp.int32))
    np.testing.assert_allclose(w_end.numpy(), np.asarray(j_end), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(delta.numpy(), np.asarray(j_delta),
                               rtol=RTOL, atol=ATOL)
    # the same prototypes moved: no assignment flipped between packages
    np.testing.assert_array_equal(delta.abs().sum(1).numpy() > 0,
                                  np.abs(np.asarray(j_delta)).sum(1) > 0)
    assert torch.equal(delta, w0 - w_end)


def test_step_reservation_at_m1_is_the_reference_sequence(monkeypatch):
    """One worker reserves tau consecutive global steps a round: its
    rounds' steps are the reference's one-a-point draws, 1, 2, 3, ..."""
    seen = []
    real = async_runtime.worker_round

    def spy(w, zwin, t0, **kw):
        seen.append(t0)
        return real(w, zwin, t0, **kw)

    monkeypatch.setattr(async_runtime, "worker_round", spy)
    data, w0 = _setup(m=1, n=100)
    async_runtime.run_async_vq(data, w0, tau=TAU, duration_s=0.2)
    assert seen[:3] == [0, TAU, 2 * TAU]
    eps = torch.cat([vq.default_steps(torch.arange(t + 1, t + TAU + 1))
                     for t in seen[:3]])
    want = jvq.default_steps(jnp.arange(1, 3 * TAU + 1))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(want))


def test_rows_wrap_at_n():
    stream = torch.arange(7, dtype=torch.float32)[:, None]
    got = async_runtime._rows(stream, 5, 10)
    assert got[:, 0].tolist() == [5, 6, 0, 1, 2, 3, 4, 5, 6, 0]
    assert async_runtime._rows(stream, 9, 3)[:, 0].tolist() == [2, 3, 4]


def test_blob_store_versioning():
    store = async_runtime.BlobStore(torch.zeros(2, 2))
    v0, _ = store.get()
    v1 = store.put(torch.ones(2, 2))
    assert v1 == v0 + 1
    v, val = store.get()
    assert v == v1 and float(val[0, 0]) == 1.0
    val += 1.0                           # a clone: the store is untouched
    assert float(store.get()[1][0, 0]) == 1.0


def test_blob_store_apply_is_atomic_under_contention():
    """A bare get() -> put() pair drops concurrent updates; ``apply`` must
    lose none of them, even with a short switch interval."""
    store = async_runtime.BlobStore(torch.zeros(4))
    writers, per_writer = 8, 200

    def hammer():
        for _ in range(per_writer):
            store.apply(lambda w: w + 1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    version, value = store.get()
    assert version == writers * per_writer
    assert torch.equal(value, torch.full((4,), float(writers * per_writer)))


def test_async_runtime_converges():
    data, w0 = _setup()
    w, stats, trace = async_runtime.run_async_vq(data, w0, tau=TAU,
                                                 duration_s=1.5)
    assert trace[-1][1] < trace[0][1]          # distortion decreased
    assert all(s.pushes > 0 for s in stats)    # every worker participated
    assert sum(s.points for s in stats) > 100
    assert all(s.points == TAU * s.pushes for s in stats)


def test_async_runtime_tolerates_straggler():
    """One 50x-slow worker must not stop global progress."""
    data, w0 = _setup()
    w, stats, trace = async_runtime.run_async_vq(
        data, w0, tau=TAU, duration_s=1.5, straggler={0: 50.0})
    assert trace[-1][1] < trace[0][1]
    fast = [s.points for i, s in enumerate(stats) if i != 0]
    assert max(fast) > stats[0].points          # others ran ahead
    assert min(fast) > 0


def test_async_runtime_with_comm_delays():
    data, w0 = _setup()
    w, stats, trace = async_runtime.run_async_vq(data, w0, tau=TAU,
                                                 duration_s=1.5,
                                                 comm_delay_s=0.01)
    assert trace[-1][1] < trace[0][1]


@pytest.mark.parametrize("per_worker", [INBOX, 0])
def test_inbox_bound_and_its_peak(monkeypatch, per_worker):
    """While the reducer is held up, the workers fill the inbox to its bound
    and wait (``per_worker`` 0: no bound, as the reference's queue, and the
    backlog passes it); ``inbox_peak`` shows the depth, and every pushed
    delta is merged before the final read."""
    real = async_runtime.BlobStore.apply
    applied = [0]

    def first_one_slow(self, fn):
        applied[0] += 1
        if applied[0] == 1:
            time.sleep(0.4)
        return real(self, fn)

    monkeypatch.setattr(async_runtime.BlobStore, "apply", first_one_slow)
    monkeypatch.setattr(async_runtime, "INBOX_PER_WORKER", per_worker)
    data, w0 = _setup()
    _, stats, _ = async_runtime.run_async_vq(data, w0, tau=TAU,
                                             duration_s=0.6)
    peak, m = max(s.inbox_peak for s in stats), len(stats)
    if per_worker:
        assert peak == per_worker * m
    else:
        assert peak > INBOX * m
    assert applied[0] == sum(s.pushes for s in stats)


def test_a_failing_worker_stops_the_run_and_raises(monkeypatch):
    def boom(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(async_runtime, "worker_round", boom)
    data, w0 = _setup(m=2, n=100)
    with pytest.raises(RuntimeError, match="launch failed"):
        async_runtime.run_async_vq(data, w0, tau=TAU, duration_s=5.0)


def test_thread_executor_refuses_sync_schemes_and_reports_seconds():
    data, w0 = _setup(n=300)
    tr, reg = Tracer(), MetricsRegistry()
    ex = get_executor("thread", duration_s=0.5, tracer=tr, metrics=reg,
                      device="cpu")
    for scheme in ("average", "delta"):
        with pytest.raises(ValueError, match="only runs 'async_delta'"):
            ex.run(scheme, w0, data, data, tau=TAU)
    res = ex.run("async_delta", w0, data, data, tau=TAU,
                 generator=torch.Generator(), lengths=torch.ones(1))
    secs = res.wall_ticks
    assert secs.dtype == torch.float32 and float(secs[0]) == 0.0
    assert bool((secs[1:] > secs[:-1]).all()) and float(secs[-1]) < 5.0
    assert len(res.distortion) == len(secs)
    pushes = sum(s.pushes for s in ex.last_stats)
    assert pushes > 0
    assert reg.counter("async_rounds_total",
                       scheme="async_delta").value == pushes
    assert reg.counter("stale_reads_total",
                       scheme="async_delta").value == sum(
        s.stale_reads for s in ex.last_stats)
    assert reg.histogram("distortion", scheme="async_delta").count == len(
        secs)
    assert reg.histogram("run_wall_s", executor="thread",
                         scheme="async_delta").count == 1
    # the samples' seconds on the wall timeline, in us (secs is f32)
    np.testing.assert_allclose([c.ts_us for c in tr.counters("distortion")],
                               secs.double().numpy() * 1e6, rtol=1e-6)
    assert check_trace(tr.chrome_events()) == []


@pytest.mark.parametrize("extra", [
    ["--network", "geometric"],
    ["--network", "fixed"],
    ["--transport", "ring"],
    ["--hosts", "2"],
    ["--scheme", "delta"],
])
def test_launcher_thread_refusals_exit_2(extra, capsys):
    argv = ["--mode", "vq", "--executor", "thread", "--scheme",
            "async_delta", "--workers", "4", "--points", "100",
            "--duration-s", "0.2", "--device", "cpu"] + extra
    assert train.main(argv) == 2
    assert "error:" in capsys.readouterr().out


def test_launcher_thread_run_prints_seconds(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    rc = train.main(["--mode", "vq", "--executor", "thread", "--scheme",
                     "async_delta", "--workers", "2", "--points", "200",
                     "--duration-s", "0.3", "--device", "cpu", "--trace",
                     str(trace), "--metrics", str(metrics)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "  s      0.0  C = " in out and "async_rounds_total" in out
    assert trace.is_file() and metrics.is_file()
