"""Training while serving (``repro_torch.launch.serve --train-publish``) held
against the reference's ``repro.launch.serve --train-publish``.

The trainer is an ``ElasticMeshExecutor`` with the reference's schedule (M
to M/2 at a third of the windows, back to M at two thirds) publishing
through ``on_window``: its ``(window, w)`` publications equal the
reference executor's on the same numpy inputs at ``rtol=1e-4,
atol=1e-6``, at the same windows.  The reference CLI smoke
(``tests/test_serve.py``'s ``test_serve_cli_train_publish_smoke``) runs on
the port with ``--device cpu``: exit 0, "trainer published", monotonic
versions, one publication per ``on_window`` call plus the initial one;
its ``--trace`` and ``--metrics`` files are written and the trace passes
``check_trace`` with flush, load and trainer-window spans.  A trainer that
fails exits 1.
"""

import numpy as np
import pytest
import torch

from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import InstantNetwork as JInstant
from repro_torch import interop
from repro_torch.engine import ElasticMeshExecutor, InstantNetwork
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import check_trace, load_jsonl, load_trace

torch.set_num_threads(1)

TAU, D, KAPPA = 10, 8, 16
RTOL, ATOL = 1e-4, 1e-6


def _setup(m=8, n=200, seed=42, n_eval=100):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


@pytest.mark.parametrize("publish_every", [1, 3])
def test_trainer_publications_match_reference(publish_every):
    w0, data, eval_data = _setup()
    n_windows = data.shape[1] // TAU
    schedule = [(max(1, n_windows // 3), 4), (max(2, 2 * n_windows // 3), 8)]
    ours, theirs = [], []
    ElasticMeshExecutor(
        schedule, network=InstantNetwork(), max_workers=8,
        publish_every=publish_every,
        on_window=lambda wi, w: ours.append((wi, w.clone())),
        device="cpu").run("delta", *interop.from_reference(
            w0, data, eval_data, device="cpu"), tau=TAU)
    JElastic(schedule, network=JInstant(), publish_every=publish_every,
             on_window=lambda wi, w: theirs.append((wi, np.asarray(w)))
             ).run("delta", w0, data, eval_data, tau=TAU)
    assert [wi for wi, _ in ours] == [wi for wi, _ in theirs]
    assert len(ours) > 3
    for (_, w), (_, jw) in zip(ours, theirs):
        np.testing.assert_allclose(w.numpy(), jw, rtol=RTOL, atol=ATOL)


def test_serve_cli_train_publish_smoke(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    args = serve_cli.parse_args([
        "--mode", "vq", "--smoke", "--requests", "30", "--dim", "8",
        "--kappa", "8", "--train-publish", "--points", "100", "--tick-ms",
        "0.2", "--device", "cpu", "--trace", str(trace), "--metrics",
        str(metrics)])
    calls = []
    real = ElasticMeshExecutor.run

    def counted_run(self, *a, **kw):
        hook = self.on_window
        self.on_window = lambda wi, w: (calls.append(wi), hook(wi, w))
        return real(self, *a, **kw)

    ElasticMeshExecutor.run = counted_run
    try:
        run = serve_cli.run_vq(args, keep=1000)
    finally:
        ElasticMeshExecutor.run = real
    out = capsys.readouterr().out
    assert run.rc == 0
    assert "trainer published" in out and "0 failed" in out
    assert run.report.versions_monotonic and run.report.failed == 0
    assert run.store.version == 1 + len(calls)
    assert calls == sorted(calls)
    assert len(run.store) == run.store.version        # every snapshot kept
    events = load_trace(str(trace))
    assert check_trace(events, expect_spans=["flush", "load", "window",
                                             "resize"],
                       expect_merge_tiers={"flat"}) == []
    names = {r["name"] for r in load_jsonl(str(metrics))}
    assert {"serve_latency_ms", "serve_batch_fill", "serve_queue_depth",
            "windows_total", "resize_events", "comm_wire_bytes"} <= names


def test_serve_cli_trainer_failure_exits_1(monkeypatch, capsys):
    def boom(self, *a, **kw):
        raise RuntimeError("trainer died")

    monkeypatch.setattr(ElasticMeshExecutor, "run", boom)
    rc = serve_cli.main(["--mode", "vq", "--smoke", "--requests", "10",
                         "--dim", "8", "--kappa", "8", "--train-publish",
                         "--points", "100", "--device", "cpu"])
    assert rc == 1
    assert "trainer died" in capsys.readouterr().out


def test_serve_cli_refuses_bad_publish_every(capsys):
    assert serve_cli.main(["--mode", "vq", "--train-publish",
                           "--publish-every", "0", "--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().out
