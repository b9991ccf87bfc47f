"""The port's comm dry run (``repro_torch.launch.dryrun --comm``), the two
sweep read-outs it was missing (``sparse_reduction``, ``ring_parity``), the
VQ examples (``examples/*_torch.py``) and the mesh run's wall, on the CPU.

* ``dryrun.main(["--comm", ...])`` exits 0 and its byte fields equal the
  committed ``BENCH_comm.json`` and ``BENCH_hier.json`` figures (shape
  arithmetic); the adapt cells' fixed-merge bytes equal ``BENCH_adapt.json``
  and its dynamic cells are held to the file's per-merge prices, as
  ``tests/test_torch_sweep.py`` holds them.  The LM flags write the LM
  cells' records (``tests/test_torch_roofline_lm.py`` holds their
  contents); a ``paper_vq`` cell with an LM shape, or no mode, exits 2.
* ``sweep.sparse_reduction`` and ``sweep.ring_parity`` equal the
  reference's on the same cell dicts.
* Each example runs with its size constants cut and prints its table.
* ``MeshExecutor.run``'s and ``ElasticMeshExecutor.run``'s walls, which
  ``run_wall_s`` and the profiler read, start after a device sync and end
  after one: a fake sync that sleeps is outside the wall at the start and
  inside it at the end.
"""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from repro.comm import sweep as jsweep
from repro_torch import device as device_lib
from repro_torch.comm import sweep
from repro_torch.engine import ElasticMeshExecutor, InstantNetwork
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.launch import dryrun
from repro_torch.obs import MetricsRegistry, Profiler

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _bench(name):
    return [r for r in json.loads((REPO / name).read_text())["results"]
            if r.get("kind") == "cell"]


#: a record of another run that ``--out`` already holds: kept, merged by key
OTHER = {"arch": "kept", "shape": "x", "mesh": "1x1"}


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "dryrun_comm.json"
    out.write_text(json.dumps([OTHER]))
    rc = dryrun.main(["--comm", "--device", "cpu", "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_dryrun_comm_exits_0_with_every_cell(dry):
    rc, recs = dry
    assert rc == 0
    # merged into what --out held
    assert recs[0] == OTHER and len(recs) == 22
    assert [sum(r["arch"] == a for r in recs)
            for a in ("comm", "comm_hier", "comm_adapt")] == [9, 6, 6]


@pytest.mark.parametrize("transport", sweep.TRANSPORTS)
@pytest.mark.parametrize("scheme", sweep.SCHEMES)
def test_dryrun_comm_bytes_equal_bench_comm(dry, scheme, transport):
    got = next(r for r in dry[1] if r["arch"] == "comm"
               and r["shape"] == scheme and r["transport"] == transport)
    want = next(c for c in _bench("BENCH_comm.json")
                if c["scheme"] == scheme and c["transport"] == transport)
    for key in ("m", "n", "d", "kappa", "tau", "merge_wire_bytes",
                "merge_logical_bytes"):
        assert got[key] == want[key], key
    if transport == "sparse":
        assert got["sparse_frac"] == want["sparse_frac"]


@pytest.mark.parametrize("variant", ["hier_dense", "hier_sparse"])
@pytest.mark.parametrize("scheme", sweep.SCHEMES)
def test_dryrun_hier_bytes_equal_bench_hier(dry, scheme, variant):
    got = next(r for r in dry[1] if r["arch"] == "comm_hier"
               and r["shape"] == scheme and r["transport"] == variant)
    want = next(c for c in _bench("BENCH_hier.json")
                if c["scheme"] == scheme and c["variant"] == variant)
    for key in ("hosts", "workers_per_host", "m", "n", "merge_wire_bytes",
                "tier0_wire_bytes", "tier1_wire_bytes"):
        assert got[key] == want[key], key
    assert got["bitmatch_flat"] is (variant == "hier_dense")


def test_dryrun_adapt_cells_held_to_bench_adapt(dry):
    bench = _bench("BENCH_adapt.json")
    for got in (r for r in dry[1] if r["arch"] == "comm_adapt"):
        want = next(c for c in bench if c["merge"] == got["merge"]
                    and c["quant"] == got["quant"])
        if got["merge"] == "fixed":
            for key in ("merge_wire_bytes", "probe_wire_bytes",
                        "total_wire_bytes", "n_triggered"):
                assert got[key] == want[key], key
        else:
            per_merge = want["merge_wire_bytes"] // want["n_triggered"]
            assert got["merge_wire_bytes"] == got["n_triggered"] * per_merge
            assert got["probe_wire_bytes"] == want["probe_wire_bytes"]
            assert got["wire_vs_fixed"] <= 1.0


def test_dryrun_records_name_their_cells(dry):
    for r in dry[1][1:]:
        assert r["status"] == "ok" and r["m"] == 8 and r["d"] == 8
        assert r["mesh"] in ("8x1", "2x4")


@pytest.mark.parametrize("argv,code,item", [
    (["--arch", "olmoe_1b_7b", "--shape", "train_4k"], 0, "1 cells: 1 ok"),
    (["--all"], 0, "80 cells: 64 ok, 16 skipped, 0 failed"),
    (["--multi-pod", "--comm"], 0, "comm cells on cpu"),
    (["--both-meshes"], 2, "--arch and --shape"),
    (["--arch", "paper_vq", "--shape", "train_4k"], 2, "vq_stream"),
    (["--arch", "paper_vq", "--all"], 0, "80 cells: 64 ok"),
    ([], 2, "--comm"),
])
def test_dryrun_lm_and_paper_vq_flags_exit_2(argv, code, item, capsys,
                                             tmp_path):
    """The LM flags run the LM cells (``--comm`` first, as the reference;
    ``--all`` takes every arch, ``--arch paper_vq`` too); a layout flag
    with no cell, a paper_vq cell with an LM shape, or no mode at all,
    exits 2."""
    out = ["--out", str(tmp_path / "records.json")]
    assert dryrun.main(argv + ["--device", "cpu"] + out) == code
    assert item in capsys.readouterr().out
    if code == 0:
        assert json.loads((tmp_path / "records.json").read_text())


CELL_SETS = {
    "BENCH_comm.json": [c for c in _bench("BENCH_comm.json")],
    "a slower ring, a lossless sparse": [
        {"scheme": s, "transport": t, "merge_wire_bytes": b, "wall_s": w}
        for s in sweep.SCHEMES
        for t, b, w in (("xla", 17_920, 0.5), ("ring", 17_920, 0.75),
                        ("sparse", 17_920, 0.25))],
    "zero sparse wire": [
        {"scheme": s, "transport": t, "merge_wire_bytes": b, "wall_s": w}
        for s in sweep.SCHEMES
        for t, b, w in (("xla", 10, 0.0), ("ring", 10, 1e-3),
                        ("sparse", 0, 2.0))],
}


@pytest.mark.parametrize("case", list(CELL_SETS))
def test_sparse_reduction_and_ring_parity_equal_the_reference(case):
    cells = CELL_SETS[case]
    assert sweep.sparse_reduction(cells) == jsweep.sparse_reduction(cells)
    assert sweep.ring_parity(cells) == jsweep.ring_parity(cells)


def test_sparse_reduction_reads_the_bench_comm_cells():
    cells = _bench("BENCH_comm.json")
    reduction = next(r for r in json.loads(
        (REPO / "BENCH_comm.json").read_text())["results"]
        if r.get("kind") == "sparse_reduction")["reduction"]
    assert sweep.sparse_reduction(cells) == reduction == 4.0


# ---------------------------------------------------------------------------
# the examples, cut to CPU size
# ---------------------------------------------------------------------------

EXAMPLES = {
    "quickstart": ({"M": 4, "N": 300}, "wall tick"),
    "mesh_vq": ({"M": 4, "N": 200}, "|mesh - sim|"),
    "elastic_vq": ({"M0": 4, "N": 300, "SCHEDULE": ((5, 2), (10, 4))},
                   "relative gap"),
    "serve_vq": ({"M0": 4, "N": 150, "N_REQUESTS": 60}, "final served"),
    "cloud_async_vq": ({"M": 2, "N": 200, "DURATION_S": 0.3},
                       "points/worker"),
}


def _example(stem):
    path = REPO / "examples" / f"{stem}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{stem}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("stem", list(EXAMPLES))
def test_example_runs_on_the_cpu_and_prints_its_table(stem, monkeypatch,
                                                      capsys):
    mod = _example(stem)
    cut, marker = EXAMPLES[stem]
    for name, value in cut.items():
        assert hasattr(mod, name), name
        monkeypatch.setattr(mod, name, value)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert marker in out
    if stem == "mesh_vq":
        # the stacked executor replays the oracles
        rows = [line.split() for line in out.splitlines()]
        gaps = [float(r[-1]) for r in rows if len(r) == 5 and r[1] == "mesh"]
        assert len(gaps) == 3 and max(gaps) < 1e-6
    if stem == "elastic_vq":
        assert "M 4 -> 2" in out and "M 2 -> 4" in out


def test_examples_default_to_the_card():
    for stem in EXAMPLES:
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(stem).main([])


# ---------------------------------------------------------------------------
# the run's wall ends at a device sync
# ---------------------------------------------------------------------------

SLEEP_S = 0.05


def _slow_sync(monkeypatch):
    """Replace ``device.synchronize`` by a sleep of SLEEP_S; returns the
    devices it was called with."""
    calls = []

    def fake(dev):
        calls.append(dev)
        time.sleep(SLEEP_S)

    monkeypatch.setattr(device_lib, "synchronize", fake)
    return calls


@pytest.mark.parametrize("executor", ["mesh", "elastic"])
def test_run_wall_starts_and_ends_at_a_device_sync(executor, monkeypatch):
    w0, data, eval_data = sweep.make_inputs(4, 100, 8, 16)
    reg = MetricsRegistry()
    prof = Profiler(metrics=reg)
    if executor == "mesh":
        ex = MeshExecutor(InstantNetwork(), metrics=reg, profiler=prof,
                          device="cpu")
    else:
        ex = ElasticMeshExecutor([(4, 2)], InstantNetwork(), metrics=reg,
                                 profiler=prof, device="cpu")
    calls = _slow_sync(monkeypatch)
    t0 = time.perf_counter()
    ex.run("delta", w0, data, eval_data, tau=10)
    outer = time.perf_counter() - t0
    # mesh: one sync before the wall, one at its end; elastic: and two
    # around the resize, inside the wall
    assert len(calls) == (2 if executor == "mesh" else 4)
    assert all(dev == torch.device("cpu") for dev in calls)
    hist = reg.histogram("run_wall_s", executor=ex.name, scheme="delta")
    assert hist.count == 1
    wall = hist.total
    assert (len(calls) - 1) * SLEEP_S <= wall <= outer - SLEEP_S
    # run_wall_s and the profiler read the one wall
    (a,) = prof.attributions
    assert a["wall_s"] == wall
