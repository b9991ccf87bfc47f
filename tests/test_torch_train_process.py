"""The launchers with one worker a process: ``launch.train.main`` and the
``paper_vq`` dry run in a 2-rank gloo world under a torchrun-like
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set by the test; the
world itself is ``process_group.spawn``'s, on a ``FileStore``).

Rank 0 prints one summary and every rank exits with the run's code: the
sparse transport (flat and as tier 1), the quorum and dynamic merges,
chaos without kills, the tier-1 controller and the observed and profiled
run (rank 0 writes the files) exit 0, and so do ``--resize`` and a chaos
kill (the elastic executor over the world; rank 0 prints the resize
events).  The dry run's cells run at
a shrunk shape (its module constants set in the ranks) and must print
every rank's record.
"""

import json

import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro_torch.distributed import process_group
from repro_torch.launch import dryrun, train
from repro_torch.obs import check

torch.set_num_threads(1)

BASE = ["--mode", "vq", "--executor", "mesh", "--points", "200", "--dim",
        "8", "--kappa", "16", "--device", "cpu"]
TWO = BASE + ["--workers", "2"]
ARGVS = [TWO + ["--scheme", "delta", "--transport", "ring"],
         TWO + ["--transport", "sparse"],
         TWO + ["--quorum", "--network", "geometric", "--p-delay", "0.2"],
         BASE + ["--workers", "3"],
         TWO + ["--executor", "sim"],
         TWO + ["--chaos", "7:kill=1"],
         TWO + ["--resize", "10:1"],
         TWO + ["--merge", "dynamic", "--divergence-thresh", "0.001"],
         TWO + ["--hosts", "2"],
         TWO + ["--hosts", "2", "--chaos", "7:slow=1,part=1"],
         TWO + ["--hosts", "2", "--tier1-frac", "auto"]]
#: the observed and profiled run, its files in a directory of the test's
OBSERVED = TWO + ["--transport", "ring"]
VQ_SIZES = (64, 16, 10, 256)
DRY = len(ARGVS) + 1          # the dry runs' outputs follow the runs'


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("observed")
    return {k: str(d / name) for k, name in (
        ("trace", "trace.json"), ("metrics", "metrics.jsonl"),
        ("profile", "prof.json"))}


@pytest.fixture(scope="module")
def world(files):
    observed = OBSERVED + [x for k in ("trace", "metrics", "profile")
                           for x in (f"--{k}", files[k])]
    return process_group.spawn(worlds.launcher, 2, ARGVS + [observed],
                               VQ_SIZES, device="cpu")


def test_process_run_prints_one_summary_and_exits_0(world):
    code0, out0 = world[0][0]
    code1, out1 = world[1][0]
    assert code0 == code1 == 0
    assert out0.count("done: C(final)=") == 1
    assert "one worker a process" in out0
    # 20 windows of the 16 x 8 displacement; two ranks: wire == logical
    assert "comm[ring]: merge wire 10,240 B / logical 10,240 B" in out0
    assert "launches per rank:" in out0
    assert out1 == ""                       # rank 0 prints
    stacked = train.main(BASE + ["--workers", "2", "--scheme", "delta",
                                 "--transport", "ring"])
    assert stacked == 0


@pytest.mark.parametrize("i,needle", [(3, "must equal the world size 2"),
                                      (4, "runs in one process")])
def test_refused_combinations_exit_2(world, i, needle):
    for r in range(2):
        assert world[r][i][0] == 2
    assert needle in world[0][i][1]


@pytest.mark.parametrize("i,needles", [
    (5, ["chaos: seed=7: kill@", "resize @window", "M 2 -> 1",
         "late points merged: 10"]),
    (6, ["resize @window 10: M 2 -> 1 (late points merged: 10"])])
def test_elastic_runs_exit_0_with_rank_0s_resize_lines(world, i, needles):
    for r in range(2):
        assert world[r][i][0] == 0
    out = world[0][i][1]
    assert out.count("done: C(final)=") == 1
    assert "one worker a process" in out and "launches per rank:" in out
    for needle in needles:
        assert needle in out
    assert world[1][i][1] == ""                # rank 0 prints


@pytest.mark.parametrize("i,needles", [
    (1, ["comm[sparse]: merge wire 160 B / logical 10,240 B"]),
    (2, ["quorum: late worker-windows 3"]),
    (7, ["probe: wire"]),
    (8, ["tier 0 (intra-host): wire 0 B", "tier 1 (inter-host): wire"]),
    (9, ["chaos: seed=7", "quorum: late worker-windows"]),
    (10, ["tier-1 frac after each chunk: ["])])
def test_cloud_runs_exit_0_with_rank_0s_summary(world, i, needles):
    for r in range(2):
        assert world[r][i][0] == 0
    out = world[0][i][1]
    assert out.count("done: C(final)=") == 1
    assert "one worker a process" in out and "launches per rank:" in out
    for needle in needles:
        assert needle in out
    assert world[1][i][1] == ""                # rank 0 prints


def test_observed_run_writes_rank_0s_files(world, files):
    i = len(ARGVS)
    for r in range(2):
        assert world[r][i][0] == 0
    out = world[0][i][1]
    assert "profile (roofline attribution):" in out
    with open(files["trace"]) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert check.check_trace(events, expect_spans=["merge", "window"]) == []
    with open(files["metrics"]) as f:
        lines = [json.loads(x) for x in f]
    # one rank wrote: one windows_total line, 20 windows
    total = [x for x in lines if x["name"] == "windows_total"]
    assert len(total) == 1 and total[0]["value"] == 20
    with open(files["profile"]) as f:
        prof = json.load(f)
    (rec,) = prof["attributions"]
    assert rec["m"] == 2 and rec["workers_per_device"] == 2
    assert rec["n_windows"] == 20


def test_paper_vq_dry_run_over_the_world(world):
    code, out = world[0][DRY]
    assert code == 0
    for shape, mesh in (("vq_stream", "2"), ("vq_batch", "2x1")):
        for r in range(2):
            assert f"OK   paper_vq x {shape} [{mesh}] rank {r}:" in out
    assert "peak device memory not measured" in out
    # vq_stream: one dense reduce of the 64 x 16 displacement over 2 ranks
    assert "comm wire 4,096 B / logical 4,096 B (1 calls)" in out
    code, out = world[0][DRY + 1]
    assert code == 0
    for r in range(2):
        assert f"OK   paper_vq x vq_batch [1x2] rank {r}:" in out
    assert world[1][DRY][1] == ""


def test_paper_vq_dry_run_in_one_process(monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "VQ_KAPPA", 64)
    monkeypatch.setattr(dryrun, "VQ_D", 16)
    monkeypatch.setattr(dryrun, "VQ_BATCH", 128)
    assert dryrun.main(["--arch", "paper_vq", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK   paper_vq x vq_stream [1] rank 0:" in out
    assert "OK   paper_vq x vq_batch [1x1] rank 0:" in out
    assert '"dominant"' in out
    rec = dryrun.run_vq_cell("vq_batch", dev=torch.device("cpu"))
    assert rec["points"] == 128 and rec["wire_bytes"] == 0
    assert np.isfinite(list(v for k, v in rec["terms"].items()
                            if k != "dominant")).all()
