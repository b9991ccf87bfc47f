"""The port's ``Checkpointer`` (``repro_torch.checkpoint``) held to the
reference's on-disk format: round trips of f32, 0-d int64, bf16 and
float8 leaves; the atomic ``.tmp`` rename, retention and ``latest_step``;
refusals; async writes; checkpoints written by either package restored by
the other, narrow floats bit for bit; and the port resuming the
reference's elastic checkpoint, held to the reference's own resumed run at
``rtol=1e-4, atol=1e-6``.
"""

import json
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
from repro.engine import ElasticMeshExecutor as JElastic
from repro.engine import InstantNetwork as JInstant
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer
from repro_torch.engine import ElasticMeshExecutor, InstantNetwork

torch.set_num_threads(1)

TAU, D, KAPPA = 10, 8, 16
RTOL, ATOL = 1e-4, 1e-6
NARROW = [(torch.bfloat16, ml_dtypes.bfloat16, "bfloat16"),
          (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn, "float8_e4m3fn"),
          (torch.float8_e5m2, ml_dtypes.float8_e5m2, "float8_e5m2")]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w_srd": torch.from_numpy(rng.standard_normal((4, 3)).astype(
            np.float32)),
        "t": np.asarray(123, np.int64),
        "opt": [torch.arange(5, dtype=torch.int32),
                (np.float32(2.5), torch.tensor(7))],
        "bf": torch.from_numpy(rng.standard_normal(6).astype(
            np.float32)).to(torch.bfloat16),
        "none": None,
    }


def _setup(m, n=400, seed=42, n_eval=200):
    rng = np.random.default_rng(seed)
    centers = rng.random((10, D)).astype(np.float32)
    data = (centers[rng.integers(0, 10, size=(m, n))]
            + 0.05 * rng.standard_normal((m, n, D))).astype(np.float32)
    w0 = data.reshape(-1, D)[rng.choice(m * n, KAPPA, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def test_round_trip_f32_int64_and_nested(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(3, tree)
    got = ck.restore(3, tree, device="cpu")
    assert torch.equal(got["w_srd"], tree["w_srd"])
    assert got["t"].shape == () and got["t"].dtype == torch.int64
    assert int(got["t"]) == 123
    assert torch.equal(got["opt"][0], tree["opt"][0])
    assert isinstance(got["opt"][1], tuple) and float(got["opt"][1][0]) == 2.5
    assert int(got["opt"][1][1]) == 7 and got["none"] is None
    assert torch.equal(got["bf"].view(torch.int16),
                       tree["bf"].view(torch.int16))
    manifest = json.loads((tmp_path / "step_000000003" /
                           "manifest.json").read_text())
    assert manifest["names"] == ["bf", "opt/0", "opt/1/0", "opt/1/1", "t",
                                 "w_srd"]
    assert manifest["dtypes"] == ["bfloat16", "int32", "float32", "int64",
                                  "int64", "float32"]
    assert manifest["shapes"] == [[6], [5], [], [], [], [4, 3]]


@pytest.mark.parametrize("torch_dtype,np_dtype,name", NARROW)
def test_round_trip_narrow_floats_bitwise(tmp_path, torch_dtype, np_dtype,
                                          name):
    x = torch.linspace(-3.0, 3.0, 37).to(torch_dtype)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": x})
    stored = np.load(tmp_path / "step_000000001" / "leaf_00000.npy")
    assert stored.dtype == (np.uint16 if name == "bfloat16" else np.uint8)
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == [name]
    got = ck.restore(1, {"x": x}, device="cpu")["x"]
    assert got.dtype == torch_dtype
    assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))


# ---------------------------------------------------------------------------
# the atomic rename, retention, refusals, async writes
# ---------------------------------------------------------------------------

def test_tmp_never_listed_keep_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None and ck.all_steps() == []
    os.makedirs(tmp_path / "step_000000009.tmp")   # a crash mid-save
    (tmp_path / "step_000000009.tmp" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_000000008")       # no manifest yet
    assert ck.all_steps() == []
    for step in (1, 2, 5):
        ck.save(step, {"w": torch.full((2,), float(step))})
    assert ck.all_steps() == [2, 5] and ck.latest_step() == 5
    assert not (tmp_path / "step_000000001").exists()
    got = ck.restore(2, {"w": torch.zeros(2)}, device="cpu")
    assert torch.equal(got["w"], torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="keep"):
        Checkpointer(str(tmp_path), keep=0)


def test_restore_refuses_mismatched_leaves(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3), "b": np.zeros((), np.int64)})
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(1, {"a": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"a": torch.zeros(4), "b": np.zeros((), np.int64)},
                   device="cpu")


def test_save_async_snapshots_and_wait_surfaces_errors(tmp_path):
    ck = Checkpointer(str(tmp_path / "ok"))
    w = torch.ones(3)
    ck.save_async(1, {"w": w})
    w.add_(1.0)          # after the call: the snapshot is already taken
    ck.wait()
    got = ck.restore(1, {"w": w}, device="cpu")["w"]
    assert torch.equal(got, torch.ones(3))

    bad = Checkpointer(str(tmp_path / "gone"))
    shutil.rmtree(bad.dir)
    (tmp_path / "gone").write_text("not a directory")
    bad.save_async(1, {"w": torch.ones(1)})
    with pytest.raises(OSError):
        bad.wait()


# ---------------------------------------------------------------------------
# either package restores the other's checkpoints
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    bf = jnp.asarray(rng.standard_normal(7).astype(np.float32),
                     jnp.bfloat16)
    tree = {"w_srd": jnp.asarray(w), "t": np.asarray(9, np.int64),
            "bf": bf, "seq": [jnp.arange(3), (jnp.float32(1.5),)]}
    JCheckpointer(str(tmp_path)).save(4, tree)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    target = {"w_srd": torch.zeros(5, 4), "t": np.zeros((), np.int64),
              "bf": torch.zeros(7, dtype=torch.bfloat16),
              "seq": [torch.zeros(3), (torch.zeros(()),)]}
    got = ck.restore(4, target, device="cpu")
    assert torch.equal(got["w_srd"], torch.from_numpy(w))
    assert int(got["t"]) == 9
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf"].view(torch.int16).numpy(),
                                  np.asarray(bf).view(np.int16))
    assert got["seq"][0].tolist() == [0, 1, 2]
    assert float(got["seq"][1][0]) == 1.5


@pytest.mark.parametrize("torch_dtype,np_dtype,name", NARROW)
def test_port_checkpoint_restores_in_the_reference(tmp_path, torch_dtype,
                                                   np_dtype, name):
    x = torch.linspace(-2.0, 2.0, 11).to(torch_dtype)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = {"w": w, "x": x, "t": np.asarray(5, np.int64),
            "pair": (torch.ones(2), [torch.zeros(1)])}
    Checkpointer(str(tmp_path / "port")).save(2, tree)
    jck = JCheckpointer(str(tmp_path / "port"))
    target = {"w": jnp.zeros((3, 4)), "x": jnp.zeros(11, np_dtype),
              "t": np.zeros((), np.int64),
              "pair": (jnp.zeros(2), [jnp.zeros(1)])}
    got = jck.restore(2, target)
    np.testing.assert_array_equal(np.asarray(got["w"]), w.numpy())
    assert np.asarray(got["x"]).dtype == np_dtype
    np.testing.assert_array_equal(
        np.asarray(got["x"]).view(np.uint8), x.view(torch.uint8).numpy())
    assert int(got["t"]) == 5
    # the same tree through the reference writes the same manifest
    jtree = {"w": jnp.asarray(w.numpy()),
             "x": jnp.asarray(np.asarray(got["x"])),
             "t": np.asarray(5, np.int64),
             "pair": (jnp.ones(2), [jnp.zeros(1)])}
    JCheckpointer(str(tmp_path / "ref")).save(2, jtree)
    mine, theirs = (json.loads((tmp_path / sub / "step_000000002" /
                                "manifest.json").read_text())
                    for sub in ("port", "ref"))
    assert mine == theirs


# ---------------------------------------------------------------------------
# the port resumes the reference's elastic checkpoint
# ---------------------------------------------------------------------------

def test_port_resumes_the_reference_elastic_checkpoint(tmp_path):
    w0, data, eval_data = _setup(4)
    jck = JCheckpointer(str(tmp_path))
    JElastic([(10, 2)], network=JInstant(), checkpointer=jck).run(
        "delta", w0, data, eval_data, tau=TAU)
    jck.wait()
    assert jck.latest_step() == 10
    ref = JElastic([(10, 2)], network=JInstant(), checkpointer=jck,
                   resume=True).run("delta", w0, data, eval_data, tau=TAU)
    ex = ElasticMeshExecutor([(10, 2)], network=InstantNetwork(),
                             checkpointer=Checkpointer(str(tmp_path)),
                             resume=True, device="cpu")
    got = ex.run("delta", *interop.from_reference(w0, data, eval_data,
                                                  device="cpu"), tau=TAU)
    assert ex.resize_events == []
    assert got.distortion.shape == np.asarray(ref.distortion).shape
    np.testing.assert_allclose(got.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.w_shared.numpy(), np.asarray(ref.w_shared),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.wall_ticks.numpy(),
                                  np.asarray(ref.wall_ticks))
