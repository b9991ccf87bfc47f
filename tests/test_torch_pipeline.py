"""GPipe stages (``training.pipeline``) in a 2-rank gloo world, held against
the plain loss and the reference's ``make_pp_loss_fn`` on a (2, 1, 1) CPU
mesh.

The granite smoke config in f32 at 4 layers (2 stages of 2), its params
from the reference's ``init``, 8 x 16 tokens:
  * the pipelined loss on every rank == the plain port's (rtol 1e-5) and
    the reference's pipelined loss, at 4 and at 2 microbatches;
  * each rank's grads (its stage's block leaves, the replicated embedding,
    head and final norm whole) == the plain port's (rtol 1e-4, atol 1e-5 x
    max);
  * one ``"eval"`` record of the masked loss sum over 2 participants;
  * ``stage_param_specs`` == the reference's (its second assignment);
  * the reference's own pipelined gradient against its plain one, pinned
    (ROADMAP "Reference caveats").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.configs import registry as jreg
from repro.distributed import sharding as jsharding
from repro.models.api import get_api as jget_api
from repro.training import pipeline as jpipeline
from repro_torch.configs import registry
from repro_torch.distributed import process_group, sharding
from repro_torch.models.api import get_api
from repro_torch.training import pipeline, steps

torch.set_num_threads(1)

B, T, LAYERS = 8, 16, 4
MICRO = (4, 2)
#: the reference's pipelined grads against the plain port's, max |gap| over
#: max |grad| of a leaf: 1.1e-6 in f32 on the installed JAX (its bf16 grads
#: differ from its plain bf16 ones by 2.2%, rounding only)
PINNED_REF_PP_GAP = 1e-4


def _close(got, want, rtol=1e-4, atol_rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _jcfg():
    return dataclasses.replace(jreg.get_smoke_config("granite_8b"),
                               dtype=jnp.float32, n_layers=LAYERS)


@pytest.fixture(scope="module")
def setup():
    jcfg = _jcfg()
    params = jax.tree.map(np.asarray,
                          jget_api(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:].copy()}
    ins = {"params": params, "batch": batch, "layers": LAYERS,
           "n_micro": MICRO}
    outs = process_group.spawn(worlds.pipeline_runs, 2, ins, device="cpu")
    cfg = dataclasses.replace(registry.get_smoke_config("granite_8b"),
                              dtype=torch.float32, n_layers=LAYERS)
    loss, grads = steps.loss_and_grads(get_api(cfg).loss_fn,
                                       worlds._tree_t(params),
                                       worlds._tree_t(batch))
    return jcfg, ins, outs, float(loss), worlds._tree_np(grads)


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipelined_loss_equals_plain_and_reference(setup, n_micro):
    jcfg, ins, outs, loss, _ = setup
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
    fn = jpipeline.make_pp_loss_fn(jcfg, mesh, n_micro=n_micro)
    with mesh:
        ref = float(jax.jit(fn)(ins["params"], ins["batch"]))
    assert ref == pytest.approx(loss, rel=1e-5)
    for out in outs:
        assert out[n_micro]["loss"] == pytest.approx(loss, rel=1e-5)
        assert out[n_micro]["loss"] == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipelined_grads_equal_plain(setup, n_micro):
    _, _, outs, _, grads = setup
    per = LAYERS // 2
    for rank, out in enumerate(outs):
        got = out[n_micro]["grads"]
        for key in ("embed", "final_norm", "lm_head"):
            _close(got[key], grads[key])
        for name, g in got["blocks"].items():
            assert g.shape[0] == per
            _close(g, grads["blocks"][name][rank * per:(rank + 1) * per])


def test_loss_rides_the_dense_transport_as_eval(setup):
    _, _, outs, _, _ = setup
    for out in outs:
        (rec,) = out[MICRO[0]]["records"]
        assert (rec.tag, rec.op, rec.participants) == ("eval", "sum", 2)
        assert rec.logical_bytes == 4       # one f32 a worker


def test_stage_param_specs_equal_the_reference():
    for shape, axes in (((2, 1, 1), ("pod", "data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        class Mesh:
            axis_names = axes
            devices = np.empty(shape)

        for fsdp in (False, True):
            want = jpipeline.stage_param_specs(
                jreg.get_smoke_config("granite_8b"),
                jsharding.param_specs(jreg.get_smoke_config("granite_8b"),
                                      Mesh(), use_fsdp=fsdp))
            got = pipeline.stage_param_specs(
                registry.get_smoke_config("granite_8b"),
                sharding.param_specs(registry.get_smoke_config("granite_8b"),
                                     dict(zip(axes, shape)), use_fsdp=fsdp))
            assert {k: tuple(v) for k, v in got["blocks"].items()} == {
                k: tuple(v) for k, v in want["blocks"].items()}
            assert all(tuple(got[k]) == tuple(want[k])
                       for k in got if k != "blocks")


def test_pipeline_refuses_what_it_cannot_split():
    moe = registry.get_smoke_config("olmoe_1b_7b")

    class Groups:
        def size(self, axis):
            return 2

    with pytest.raises(ValueError, match="dense"):
        pipeline.make_pp_loss_fn(moe, Groups(), n_micro=2)
    odd = dataclasses.replace(registry.get_smoke_config("granite_8b"),
                              n_layers=3)
    with pytest.raises(ValueError, match="stages"):
        pipeline.make_pp_loss_fn(odd, Groups(), n_micro=2)


def test_reference_pipelined_gradient_gap_is_pinned(setup):
    """The reference's ``jax.grad`` of its pipelined loss against its plain
    loss's, leaf by leaf, as the installed JAX gives it (ROADMAP
    "Reference caveats"); the port's equals the plain one above."""
    jcfg, ins, _, _, grads = setup
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
    fn = jpipeline.make_pp_loss_fn(jcfg, mesh, n_micro=MICRO[0])
    with mesh:
        got = jax.jit(jax.grad(fn))(ins["params"], ins["batch"])
    gaps = {}
    for key in ("embed", "final_norm", "lm_head"):
        a = np.asarray(got[key], np.float32)
        gaps[key] = float(np.abs(a - grads[key]).max()
                          / np.abs(grads[key]).max())
    for name, g in got["blocks"].items():
        a = np.asarray(g, np.float32)
        b = grads["blocks"][name]
        gaps[name] = float(np.abs(a - b).max() / np.abs(b).max())
    assert all(np.isfinite(v) for v in gaps.values())
    assert max(gaps.values()) < PINNED_REF_PP_GAP, gaps
