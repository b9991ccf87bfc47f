"""The port's quantization service held against ``repro.serve``.

Mirrors the one-device cases of ``tests/test_serve.py``: the versioned
store, the ``direct`` lookup, the micro-batching service and the open-loop
load generator, on the CPU (the lookup's assign kernel takes its plain
version for CPU tensors).  Inputs are N(0, 1) from numpy, fed to both
packages; assignments must be equal and min distances within
``rtol=1e-5``, the reference's own serving bar.  Flushes are asserted by
kind and count, not by wall-clock bounds.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.serve import CodebookStore as JStore
from repro.serve import QuantizeService as JService
from repro.serve import ShardedLookup as JLookup
from repro_torch import interop
from repro_torch.engine import GeometricDelayNetwork
from repro_torch.kernels import vq_assign
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (CodebookStore, QuantizeService, ShardedLookup,
                               arrival_gaps_s, lookup, run_load)

torch.set_num_threads(1)

D, KAPPA = 16, 48
CPU = "cpu"


def _codebook(kappa=KAPPA, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (kappa, d)).astype(np.float32)


def _queries(n, d=D, seed=100):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _lookup():
    return ShardedLookup(device=CPU)


def _assert_matches_ref(resp, z, w):
    ar, mr = jref.vq_assign_ref(jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_array_equal(resp.assign, np.asarray(ar))
    np.testing.assert_allclose(resp.mindist, np.asarray(mr), rtol=1e-5)


# ---------------------------------------------------------------------------
# CodebookStore
# ---------------------------------------------------------------------------

def test_store_versions_strictly_monotonic():
    store = CodebookStore(device=CPU)
    assert store.version == 0 and len(store) == 0
    with pytest.raises(LookupError):
        store.latest()
    w = _codebook()
    s1 = store.publish(w, step=10)
    s2 = store.publish(2 * w, step=20)
    assert (s1.version, s2.version) == (1, 2)
    assert store.latest() is s2
    assert store.get(1) is s1 and store.get(99) is None
    with pytest.raises(ValueError):
        s1.w[0, 0] = 123.0          # snapshots are immutable
    assert torch.equal(s2.w_device, torch.from_numpy(2 * w))
    # publisher() plugs into an on_window hook; a tensor publishes too
    store.publisher()(7, torch.from_numpy(3 * w))
    assert store.version == 3 and store.latest().step == 7
    np.testing.assert_array_equal(store.latest().w, 3 * w)


def test_store_history_bounded_and_wait_for():
    store = CodebookStore(_codebook(), keep=3, device=CPU)
    for i in range(6):
        store.publish(_codebook(seed=i))
    assert store.version == 7 and len(store) == 3
    assert store.get(1) is None and store.get(7) is not None
    assert store.wait_for(7, timeout=0.01)
    assert not store.wait_for(99, timeout=0.01)
    with pytest.raises(ValueError):
        CodebookStore(keep=0, device=CPU)
    with pytest.raises(ValueError):
        store.publish(np.zeros(3))  # not (kappa, d)


def test_store_concurrent_publish_no_torn_reads():
    """w filled with its own version number makes a torn snapshot
    visible, on the host copy and on the device copy."""
    store = CodebookStore(np.full((4, 4), 1.0, np.float32), device=CPU)
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            snap = store.latest()
            if not (np.all(snap.w == float(snap.version))
                    and bool(torch.all(snap.w_device == snap.version))):
                torn.append(snap.version)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)    # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for v in range(2, 200):
            store.publish(np.full((4, 4), float(v), np.float32))
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not torn and store.version == 199


def test_store_publish_does_not_freeze_callers_array():
    w = _codebook().copy()
    store = CodebookStore(device=CPU)
    store.publish(w)
    w[0, 0] = 42.0  # the caller keeps a writable array...
    assert store.latest().w[0, 0] != 42.0  # ...and the snapshot a copy
    assert float(store.latest().w_device[0, 0]) != 42.0
    t = torch.from_numpy(_codebook(seed=3))
    store.publish(t)
    t[0, 0] = 42.0
    assert store.latest().w[0, 0] != 42.0


# ---------------------------------------------------------------------------
# ShardedLookup
# ---------------------------------------------------------------------------

def test_lookup_direct_matches_reference():
    look = _lookup()
    z, w = _queries(37), _codebook()
    a, m = look.assign(z, w)
    assert a.dtype == torch.int32 and a.device.type == "cpu"
    ja, jm = JLookup(n_devices=1).assign(jnp.asarray(z), jnp.asarray(w))
    ar, mr = jref.vq_assign_ref(jnp.asarray(z), jnp.asarray(w))
    for want_a, want_m in ((ja, jm), (ar, mr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))
        np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=1e-5)
    assert look.plan(KAPPA, D) == "direct" and look.batch_multiple() == 1
    # a tensor codebook, as the service passes it, gives the same bits
    a2, m2 = look.assign(torch.from_numpy(z), torch.from_numpy(w))
    assert torch.equal(a2, a) and torch.equal(m2, m)


def test_lookup_validation(monkeypatch):
    with pytest.raises(ValueError, match="unknown lookup mode"):
        ShardedLookup(mode="psum", device=CPU)
    with pytest.raises(ValueError, match="n_devices"):
        ShardedLookup(n_devices=2, device=CPU)
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        ShardedLookup(mode="shard_batch", device=CPU)
    with pytest.raises(ValueError, match="matching d"):
        _lookup().assign(_queries(8, d=4), _codebook())
    # several devices: the sharded plans wait for torch.distributed
    monkeypatch.setattr(lookup, "device_count", lambda device: 2)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        ShardedLookup(device=CPU)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        ShardedLookup(n_devices=2, mode="shard_kappa", device=CPU)
    assert ShardedLookup(n_devices=1, device=CPU).plan(KAPPA, D) == "direct"


# ---------------------------------------------------------------------------
# QuantizeService
# ---------------------------------------------------------------------------

def test_service_matches_reference_for_pinned_version():
    w = _codebook()
    z_single = _queries(1)[0]                 # (d,) single-vector form
    z_bulk = _queries(29, seed=5)
    with QuantizeService(CodebookStore(w, device=CPU), _lookup(),
                         max_delay_s=1e-3) as svc:
        r1 = svc.quantize(z_single)
        r2 = svc.quantize(z_bulk)
    with JService(JStore(w), JLookup(n_devices=1), max_delay_s=1e-3) as jsvc:
        j1 = jsvc.quantize(z_single)
        j2 = jsvc.quantize(z_bulk)
    for ours, theirs, z in ((r1, j1, z_single[None]), (r2, j2, z_bulk)):
        np.testing.assert_array_equal(ours.assign, theirs.assign)
        np.testing.assert_allclose(ours.mindist, theirs.mindist, rtol=1e-5)
        _assert_matches_ref(ours, z, w)
        assert ours.assign.dtype == np.int32
    assert r1.version == r2.version == 1
    assert r1.batch_rows == 1 and r2.batch_rows == 29
    assert svc.stats.warmups == 1


def test_service_deadline_flushes_partial_batch():
    store = CodebookStore(_codebook(), device=CPU)
    svc = QuantizeService(store, _lookup(), max_batch=10_000,
                          max_delay_s=0.05)
    with svc:
        futs = [svc.submit(_queries(1, seed=i)[0]) for i in range(3)]
        resps = [f.result(timeout=10) for f in futs]
    # far from full, so only the deadline can have flushed
    assert svc.stats.deadline_flushes >= 1 and svc.stats.full_flushes == 0
    assert all(r.version == 1 for r in resps)
    assert svc.stats.requests == 3 and svc.stats.rows == 3


def test_service_full_batch_flushes_before_deadline():
    store = CodebookStore(_codebook(), device=CPU)
    svc = QuantizeService(store, _lookup(), max_batch=64, max_delay_s=30.0)
    with svc:
        futs = [svc.submit(_queries(16, seed=i)) for i in range(4)]
        for f in futs:
            f.result(timeout=10)
    # 64 pending rows fill max_batch: one full flush, no 30 s deadline
    assert svc.stats.flushes == svc.stats.full_flushes == 1
    assert svc.stats.deadline_flushes == 0 and svc.stats.mean_fill == 64


def test_service_pads_to_alignment():
    svc = QuantizeService(CodebookStore(_codebook(), device=CPU), _lookup(),
                          max_delay_s=1e-3, batch_align=128)
    with svc:
        svc.quantize(_queries(3, seed=9))
    assert svc.stats.padded_rows == 125  # 3 -> one aligned 128 block


def test_service_empty_store_fails_request_not_service():
    store = CodebookStore(device=CPU)
    with QuantizeService(store, _lookup(), max_delay_s=1e-3) as svc:
        with pytest.raises(LookupError):
            svc.quantize(_queries(1)[0])
        # the flush loop survives the fault; a publish heals the service
        store.publish(_codebook())
        assert svc.quantize(_queries(1)[0]).version == 1
    assert svc.stats.failed == 1 and svc.stats.warmups == 0


class _FailingLookup(ShardedLookup):
    def assign(self, z, w):
        raise RuntimeError("vq_assign_f32: CUDA error 1 at launch")


def test_service_flush_error_reaches_its_futures():
    """A kernel's launch error is the flush's answer, never the plain
    version's; the flush thread lives on."""
    store = CodebookStore(_codebook(), device=CPU)
    svc = QuantizeService(store, _FailingLookup(device=CPU), warmup=False,
                          max_batch=10_000, max_delay_s=0.01)
    with svc:
        futs = [svc.submit(_queries(1, seed=i)[0]) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="at launch"):
                f.result(timeout=10)
        svc.lookup = _lookup()
        assert svc.quantize(_queries(1)[0]).version == 1
    assert svc.stats.failed == 3 and svc.stats.requests == 1


def test_service_submit_validation_and_lifecycle():
    store = CodebookStore(_codebook(), device=CPU)
    svc = QuantizeService(store, _lookup())
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(_queries(1)[0])
    with svc:
        with pytest.raises(ValueError, match="rows, d"):
            svc.submit(np.zeros((2, 3, 4)))
        with pytest.raises(RuntimeError, match="already running"):
            svc.start()
    svc.stop()                      # stopping twice is harmless
    with pytest.raises(ValueError, match="max_delay_s"):
        QuantizeService(store, _lookup(), max_delay_s=-1)
    with pytest.raises(ValueError, match="max_batch"):
        QuantizeService(store, _lookup(), max_batch=0)
    with pytest.raises(ValueError, match="batch_align"):
        QuantizeService(store, _lookup(), batch_align=0)


def test_service_survives_cancelled_future():
    """cancel() on a queued request must not kill the flush thread or the
    requests coalesced into the same batch."""
    store = CodebookStore(_codebook(), device=CPU)
    with QuantizeService(store, _lookup(), max_batch=10_000,
                         max_delay_s=0.05) as svc:
        doomed = svc.submit(_queries(1)[0])
        assert doomed.cancel()
        resp = svc.submit(_queries(2, seed=3)).result(timeout=10)
        assert resp.version == 1
        assert svc.quantize(_queries(1, seed=4)[0]).version == 1


def test_service_hot_swap_under_concurrent_load():
    """Concurrent publishes never tear a response: every answer matches the
    reference oracle on the exact version it reports, and the versions a
    client sees only move forward."""
    n_versions, n_clients, n_reqs = 30, 4, 25
    store = CodebookStore(_codebook(seed=1), keep=n_versions + 1, device=CPU)
    results: dict[int, list] = {i: [] for i in range(n_clients)}
    errors: list[Exception] = []
    published = threading.Event()

    with QuantizeService(store, _lookup(), max_delay_s=5e-4) as svc:
        def publisher():
            for v in range(2, n_versions + 2):
                store.publish(_codebook(seed=v))
                time.sleep(1e-3)
            published.set()

        def client(i):
            try:
                j = 0
                # keep asking until a request submitted after the last
                # publish has come back, so the load overlaps the swaps and
                # meets the last version however the threads are scheduled
                after_last = False
                while j < n_reqs or not after_last:
                    after_last = published.is_set()
                    z = _queries(3, seed=1000 + i * 10_000 + j)
                    results[i].append((z, svc.quantize(z)))
                    j += 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = ([threading.Thread(target=publisher)]
                   + [threading.Thread(target=client, args=(i,))
                      for i in range(n_clients)])
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    assert not errors
    served = set()
    for i in range(n_clients):
        versions = [r.version for _, r in results[i]]
        assert versions == sorted(versions)
        served.update(versions)
        for z, r in results[i]:
            snap = store.get(r.version)
            assert snap is not None, "served a version the store never had"
            _assert_matches_ref(r, z, snap.w)
    assert n_versions + 1 in served
    assert len(served) > 1, "load never overlapped a hot swap"


# ---------------------------------------------------------------------------
# loadgen
# ---------------------------------------------------------------------------

def test_loadgen_geometric_arrivals_and_report():
    p = 0.5
    gaps = arrival_gaps_s(GeometricDelayNetwork(p), 20_000, tick_s=1e-3,
                          generator=torch.Generator().manual_seed(7))
    assert gaps.shape == (20_000,) and np.all(gaps >= 1e-3)  # round >= 1
    # 1 + Geometric(p) ticks: mean 1 + (1 - p) / p = 2 ticks
    assert abs(gaps.mean() / 1e-3 - (1 + (1 - p) / p)) < 0.05

    store = CodebookStore(_codebook(), device=CPU)
    with QuantizeService(store, _lookup(), max_delay_s=1e-3) as svc:
        rep = run_load(svc, n_requests=50, d=D, rows_per_request=2,
                       network=GeometricDelayNetwork(p), tick_s=1e-4,
                       generator=torch.Generator().manual_seed(7), sample=10)
    assert rep.failed == 0 and rep.requests == 50 and rep.rows == 100
    assert rep.qps > 0 and rep.p50_ms <= rep.p99_ms
    assert rep.versions_min == rep.versions_max == 1
    assert rep.versions_monotonic and rep.staleness_max == 0
    assert "50 req" in rep.summary()
    assert len(rep.samples) == 10
    for z, resp in rep.samples:
        assert z.shape == (2, D)
        _assert_matches_ref(resp, z, store.latest().w)
    with pytest.raises(ValueError, match="n_requests"):
        run_load(svc, n_requests=0, d=D)


# ---------------------------------------------------------------------------
# CLI, interop and devices
# ---------------------------------------------------------------------------

def test_serve_cli_vq_on_cpu(capsys):
    before = vq_assign.launches_assign
    rc = serve_cli.main(["--mode", "vq", "--smoke", "--requests", "40",
                         "--dim", "8", "--kappa", "8", "--tick-ms", "0",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 failed" in out and "plan=direct" in out
    assert "warmups=1" in out
    assert vq_assign.launches_assign == before   # CPU: the plain version
    assert serve_cli.main(["--train-publish", "--publish-every", "0",
                           "--device", "cpu"]) == 2
    assert "error: --publish-every" in capsys.readouterr().out
    assert serve_cli.main(["--kappa", "500", "--device", "cpu"]) == 2
    run = serve_cli.run_vq(serve_cli.parse_args(
        ["--requests", "20", "--tick-ms", "0", "--device", "cpu"]),
        codebook=torch.from_numpy(_codebook(kappa=8, d=32)), sample=5)
    assert run.rc == 0 and run.stats.requests == 20
    assert run.store.latest().w.shape == (8, 32)
    assert len(run.report.samples) == 5


def test_codebook_from_reference_publishes():
    w = _codebook()
    t = interop.codebook_from_reference(jnp.asarray(w), device=CPU)
    assert t.dtype == torch.float32 and t.shape == (KAPPA, D)
    np.testing.assert_array_equal(
        CodebookStore(t, device=CPU).latest().w, w)
    with pytest.raises(ValueError, match="dims"):
        interop.codebook_from_reference(w[0], device=CPU)


def test_serve_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodebookStore(_codebook())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedLookup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--smoke"])
