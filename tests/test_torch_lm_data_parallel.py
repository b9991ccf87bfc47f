"""Data-parallel LM training (``launch.train --mode lm --data-axis 2``) in
a 2-rank gloo world, held against the one-process run.

  * ``run_lm`` over the (2, 1) grid, f32 smoke configs (granite, and olmoe,
    whose load-balance loss sums its router statistics over the data
    group): every step's loss and grad norm and the final params == the
    one-process run on the whole batch (rtol 1e-5; atol 1e-6 x max for the
    losses and grad norms, 1e-5 x max for the params: AdamW divides each
    gradient entry by its own root mean square, so the rounding of an
    entry whose gradient is near 0 becomes a relative gap of its step, as
    ``tests/test_torch_train_step.py`` explains), on both ranks; rank 0
    prints the lines, rank 1 nothing;
  * the launcher under a torchrun-like environment: a straight run
    checkpointing every 2 steps, its last checkpoint moved aside (a
    crash), ``--resume`` from step 2 under the world: the new last
    checkpoint == the moved one bit for bit and the step lines equal;
  * ``--data-axis 1`` in the world of 2: rank 1 is past the grid, takes
    no part and exits 0.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro_torch.configs import registry
from repro_torch.distributed import process_group
from repro_torch.launch import train

torch.set_num_threads(1)

ARCHS = ("granite_8b", "olmoe_1b_7b")
STEPS = 4
BASE = ["--mode", "lm", "--steps", str(STEPS), "--batch", "8",
        "--seq-len", "16", "--log-every", "2", "--seed", "0", "--device",
        "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    ck = tmp / "ck"
    launcher = ["--smoke", "--data-axis", "2", "--ckpt-every", "2",
                "--ckpt-dir", str(ck)] + BASE
    ins = {"archs": ARCHS, "argv": BASE,
           "launcher": [launcher, "drop", launcher + ["--resume"],
                        ["--smoke", "--data-axis", "1"] + BASE],
           "drop": str(ck / f"step_{STEPS:09d}"),
           "keep": str(tmp / "kept")}
    outs = process_group.spawn(worlds.lm_data_parallel, 2, ins,
                               device="cpu")
    return ins, outs


def _close(got, want, atol_rel=1e-6):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=atol_rel * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_equals_one_process(runs, arch):
    _, outs = runs
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype=torch.float32)
    one = train.run_lm(train.parse_args(BASE + ["--arch", arch]), cfg=cfg)
    want = worlds._tree_np(one.state["params"])
    for rank, out in enumerate(outs):
        got = out[arch]
        _close(got["losses"], one.losses.numpy())
        _close(got["gnorms"], one.grad_norms.numpy())
        flat_got, flat_want = [], []

        def walk(a, b):
            if isinstance(a, dict):
                for k in sorted(a):
                    walk(a[k], b[k])
            else:
                flat_got.append(a)
                flat_want.append(b)

        walk(got["params"], want)
        for a, b in zip(flat_got, flat_want):
            _close(a, b, atol_rel=1e-5)
        if rank == 0:
            assert "mesh={'data': 2, 'model': 1}" in got["log"]
            assert f"done: {STEPS} steps" in got["log"]
        else:
            assert got["log"] == ""
    # the ranks hold one state
    np.testing.assert_array_equal(outs[0][arch]["losses"],
                                  outs[1][arch]["losses"])


def test_launcher_resume_under_the_world(runs):
    ins, outs = runs
    (c1, log1), (c2, log2), _ = outs[0]["launcher"]
    assert c1 == c2 == 0
    assert [c for c, _ in outs[1]["launcher"]] == [0, 0, 0]
    assert all(text == "" for _, text in outs[1]["launcher"])
    assert "resumed from step 2" in log2 and "done: 2 steps" in log2

    def line(text):
        return [x.split("  tok/s")[0] for x in text.splitlines()
                if x.startswith(f"step {STEPS:5d}")]

    assert line(log1) and line(log1) == line(log2)
    kept, new = Path(ins["keep"]), Path(ins["drop"])
    names = sorted(p.name for p in kept.iterdir())
    assert names == sorted(p.name for p in new.iterdir())
    for name in names:
        if name.endswith(".npy"):
            a, b = np.load(kept / name), np.load(new / name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_ranks_past_the_grid_take_no_part(runs):
    _, outs = runs
    code0, log0 = outs[0]["launcher"][2]
    code1, log1 = outs[1]["launcher"][2]
    assert code0 == code1 == 0
    assert "mesh={'data': 1, 'model': 1}" in log0 and log1 == ""
