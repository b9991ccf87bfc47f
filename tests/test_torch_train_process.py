"""The launchers with one worker a process: ``launch.train.main`` and the
``paper_vq`` dry run in a 2-rank gloo world under a torchrun-like
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set by the test; the
world itself is ``process_group.spawn``'s, on a ``FileStore``).

Rank 0 prints one summary and every rank exits with the run's code; the
combinations that wait for ROADMAP item 9c exit 2 naming it.  The dry
run's cells run at a shrunk shape (its module constants set in the ranks)
and must print every rank's record.
"""

import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro_torch.distributed import process_group
from repro_torch.launch import dryrun, train

torch.set_num_threads(1)

BASE = ["--mode", "vq", "--executor", "mesh", "--points", "200", "--dim",
        "8", "--kappa", "16", "--device", "cpu"]
ARGVS = [BASE + ["--workers", "2", "--scheme", "delta", "--transport",
                 "ring"],
         BASE + ["--workers", "2", "--transport", "sparse"],
         BASE + ["--workers", "2", "--quorum"],
         BASE + ["--workers", "3"],
         BASE + ["--workers", "2", "--executor", "sim"]]
VQ_SIZES = (64, 16, 10, 256)


@pytest.fixture(scope="module")
def world():
    return process_group.spawn(worlds.launcher, 2, ARGVS, VQ_SIZES,
                               device="cpu")


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


@pytest.mark.parametrize("i,needle", [(1, "item 9c"), (2, "item 9c"),
                                      (3, "must equal the world size 2"),
                                      (4, "runs in one process")])
def test_refused_combinations_exit_2(world, i, needle):
    for r in range(2):
        assert world[r][i][0] == 2
    assert needle in world[0][i][1]


def test_paper_vq_dry_run_over_the_world(world):
    code, out = world[0][5]
    assert code == 0
    for shape, mesh in (("vq_stream", "2"), ("vq_batch", "2x1")):
        for r in range(2):
            assert f"OK   paper_vq x {shape} [{mesh}] rank {r}:" in out
    assert "peak device memory not measured" in out
    # vq_stream: one dense reduce of the 64 x 16 displacement over 2 ranks
    assert "comm wire 4,096 B / logical 4,096 B (1 calls)" in out
    code, out = world[0][6]
    assert code == 0
    for r in range(2):
        assert f"OK   paper_vq x vq_batch [1x2] rank {r}:" in out
    assert world[1][5][1] == ""


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
