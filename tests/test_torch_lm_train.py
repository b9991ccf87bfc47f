"""LM training through the port's launcher and checkpoints, on the CPU.

  * The checkpoint format carries the LM train state (params, the
    ``AdamState`` named tuple, ``step``) across packages: the reference's
    ``repro.checkpoint.Checkpointer`` writes it and the port restores it
    bit for bit, and the reverse, in f32 and in bf16.
  * ``launch.train`` defaults to ``--mode lm``, as the reference's does;
    ``--mode lm --smoke --device cpu`` prints the reference's lines and its
    loss falls; ``--resume`` continues bit for bit: a run to 2N steps
    checkpointing at N, whose step-2N checkpoint is then removed (a crash
    after step N), resumes at N and ends on the uninterrupted run's bits;
    an encoder-decoder arch exits 2, and ``--data-axis 2`` in one process
    clamps to 1 (data parallelism over a world:
    ``tests/test_torch_lm_data_parallel.py``).
  * ``examples/train_lm_torch.py`` runs its failure and restart at a cut
    size (its model cut to 2 layers of 64, 16 steps).
"""

import dataclasses
import importlib.util
import os
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
from repro.configs import registry as jreg
from repro.optim import optimizers as joptim
from repro.training import steps as jsteps
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training import steps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARCH = "granite_8b"


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes, so equal means equal to the bit."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().reshape(-1).view(np.uint16)
        return x.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x).reshape(-1)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint8)


def _same_bits(got, want) -> None:
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"leaf {i}")


def _stepped_reference(dtype):
    """The reference's LM train state after one AdamW step (moments and
    count moved off their zeros)."""
    jcfg = dataclasses.replace(jreg.get_smoke_config(ARCH), dtype=dtype)
    opt = joptim.adamw(1e-3)
    state = jsteps.init_train_state(jcfg, opt, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 8)).astype(np.int32))
    state, _ = jax.jit(jsteps.make_train_step(jcfg, opt))(
        state, {"tokens": toks, "labels": toks})
    return state


def _port_target(dtype):
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH), dtype=dtype)
    return steps.init_train_state(tcfg, optimizers.adamw(1e-3), 1,
                                  device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_train_state_restores_in_the_port_bitwise(tmp_path, dtype):
    jstate = _stepped_reference(getattr(jnp, dtype))
    JCheckpointer(str(tmp_path)).save(1, jstate)
    got = Checkpointer(str(tmp_path)).restore(
        1, _port_target(getattr(torch, dtype)), device="cpu")
    assert isinstance(got["opt_state"], optimizers.AdamState)
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    _same_bits(got, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_train_state_restores_in_the_reference_bitwise(tmp_path, dtype):
    jstate = _stepped_reference(getattr(jnp, dtype))
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype=getattr(torch, dtype))
    params = interop.params_from_reference(jstate["params"], tcfg,
                                           device="cpu")
    opt = optimizers.adamw(1e-3)
    tstate = {"params": params, "opt_state": opt.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 8)).astype(np.int32))
    tstate, _ = steps.make_train_step(tcfg, opt)(
        tstate, {"tokens": toks, "labels": toks})
    Checkpointer(str(tmp_path)).save(4, tstate)
    target = jax.tree.map(jnp.zeros_like, jstate)
    got = JCheckpointer(str(tmp_path)).restore(4, target)
    _same_bits(tstate, got)
    names = __import__("json").load(open(
        tmp_path / "step_000000004" / "manifest.json"))["names"]
    assert "opt_state/.mu/blocks/wq" in names


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _args(*extra):
    return train.parse_args(["--smoke", "--device", "cpu", "--seq-len", "16",
                             "--batch", "4", "--log-every", "4", *extra])


def test_mode_defaults_to_lm_and_the_loss_falls(capsys):
    assert train.parse_args([]).mode == "lm"
    assert train.parse_args([]).arch == "granite_8b"
    assert train.main(["--smoke", "--device", "cpu", "--steps", "40",
                       "--seq-len", "32", "--lr", "3e-3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("arch=granite-8b-smoke device=cpu")
    losses = [float(x) for x in re.findall(r"step +\d+  loss ([\d.]+)  "
                                          r"gnorm [\d.]+  tok/s [\d,]+", out)]
    assert len(losses) == 4 and losses[-1] < losses[0] - 0.2, losses
    assert re.search(r"done: 40 steps in [\d.]+s", out)


def test_resume_continues_bit_for_bit(tmp_path, capsys):
    n = 4
    straight = train.run_lm(_args("--steps", str(2 * n)))
    ckpt = str(tmp_path / "ck")
    first = train.run_lm(_args("--steps", str(2 * n), "--ckpt-every",
                               str(n), "--ckpt-dir", ckpt))
    assert Checkpointer(ckpt).all_steps() == [n, 2 * n]
    shutil.rmtree(os.path.join(ckpt, f"step_{2 * n:09d}"))   # a crash
    resumed = train.run_lm(_args("--steps", str(2 * n), "--ckpt-every",
                                 str(n), "--ckpt-dir", ckpt, "--resume"))
    out = capsys.readouterr().out
    assert f"resumed from step {n}" in out
    assert resumed.start == n and first.start == 0
    for a, b in ((first, straight), (resumed, straight)):
        for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
            assert torch.equal(x, y)
    assert torch.equal(straight.losses[n:], resumed.losses)
    assert int(resumed.state["step"]) == 2 * n


@pytest.mark.parametrize("argv,code,why", [
    (["--data-axis", "2", "--steps", "2", "--log-every", "1"], 0,
     "mesh={'data': 1, 'model': 1}"),
    (["--arch", "whisper_tiny"], 2, "encoder-decoder"),
    (["--steps", "0"], 2, ">= 1"),
])
def test_lm_refusals_exit_2(argv, code, why, capsys):
    """The two refusals left exit 2; ``--data-axis 2`` in one process
    clamps to the one device there is and prints the mesh, as the
    reference's ``make_host_mesh`` does."""
    assert train.main(["--smoke", "--device", "cpu", *argv]) == code
    out = capsys.readouterr().out
    assert out.startswith("error:" if code else "arch=") and why in out


def test_lm_mode_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def _example(stem):
    path = REPO / "examples" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_example_fails_and_restarts_on_the_cpu(monkeypatch, capsys):
    mod = _example("train_lm_torch")
    full = mod.make_100m()
    # the reference example's model, field for field
    want = _example("train_lm").make_100m()
    assert full.n_params() == want.n_params()
    assert {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
            if f.name != "dtype"} == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)
        if f.name != "dtype"}
    monkeypatch.setattr(mod, "make_100m", lambda: dataclasses.replace(
        full, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256))
    monkeypatch.setattr(mod, "LOG_EVERY", 4)
    monkeypatch.setattr(mod, "CKPT_EVERY", 4)
    final = mod.main(["--steps", "16", "--batch", "4", "--seq-len", "16",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "--- simulated failure at step 8; restarting from 8 ---" in out
    assert np.isfinite(final) and "final loss" in out
