"""Expert parallelism (``models.blocks.moe_apply_ep``) in a 2-rank gloo
world, held against the plain ``moe_apply`` and the reference's
``moe_apply_ep`` on a ("model",) CPU mesh of 2.

The olmoe smoke config in f32, its params from the reference's ``init``:
  * layer 0's MoE on a random (B, T, D) block: every rank's output == the
    plain port's and the reference's EP output (rtol 1e-5); under a random
    cotangent, the grads of ``x`` and the router (whole on every rank) and
    of the rank's experts (its slice) == the plain port's (rtol 1e-5,
    atol 1e-6 x max);
  * the whole model under ``RunOptions.moe_ep``: loss, logits and every
    grad == the plain port's (rtol 1e-4, atol 1e-5 x max);
  * each rank's expert leaves == its slice under the reference's
    ``param_specs`` on the (1, 2) mesh;
  * the reference's own EP gradient against the plain function's.  On the
    installed JAX the reference's ``moe_apply_ep`` runs on a ("model",)
    mesh of 2 CPU devices (its gradient under ``jax.set_mesh``) but not on
    a (1, 2) ("data", "model") one: its partial-manual ``shard_map``
    refuses the out_specs there ("out_specs refers to 'data'").  Both are
    pinned here (ROADMAP "Reference caveats"); the reference's outputs
    above come from the ("model",) mesh.
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
from repro.models import blocks as jblocks
from repro.models.api import get_api as jget_api
from repro_torch.distributed import process_group
from repro_torch.models import blocks, common
from repro_torch.models.api import get_api
from repro_torch.training import steps

torch.set_num_threads(1)

B, T = 2, 8
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jreg.get_smoke_config("olmoe_1b_7b"),
                               dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jget_api(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:].copy()}
    ins = {"params": params, "x": x, "r": r, "batch": batch}
    outs = process_group.spawn(worlds.moe_ep_runs, 2, ins, device="cpu")
    return jcfg, ins, outs


def _plain(ins):
    """The plain port, one process: layer 0's MoE, its grads, and the
    whole model's loss, logits and grads."""
    cfg = worlds._ep_config("olmoe_1b_7b")
    params = worlds._tree_t(ins["params"])
    p0 = {k: common.layer_slice(params["blocks"], 0)[k].detach()
          .requires_grad_() for k in ("router", *EXPERT_LEAVES)}
    x = torch.from_numpy(ins["x"]).requires_grad_()
    y = blocks.moe_apply(cfg, p0, x)
    grads = torch.autograd.grad((y * torch.from_numpy(ins["r"])).sum(),
                                [x, *p0.values()])
    batch = worlds._tree_t(ins["batch"])
    loss, mgrads = steps.loss_and_grads(get_api(cfg).loss_fn, params, batch)
    with torch.no_grad():
        logits = get_api(cfg).forward(params, batch)
    return y.detach().numpy(), [g.numpy() for g in grads], float(loss), \
        logits.numpy(), worlds._tree_np(mgrads)


def test_ep_block_equals_plain_and_reference(setup):
    jcfg, ins, outs = setup
    y, grads, *_ = _plain(ins)
    mesh = jax.make_mesh((2,), ("model",))
    p0 = {k: jnp.asarray(ins["params"]["blocks"][k][0])
          for k in ("router", *EXPERT_LEAVES)}
    y_ref = np.asarray(jblocks.moe_apply_ep(jcfg, p0, jnp.asarray(ins["x"]),
                                            mesh))
    _close(y, y_ref, 1e-5, 1e-6)
    e_loc = jcfg.n_experts // 2
    for rank, out in enumerate(outs):
        _close(out["y"], y, 1e-5, 1e-6)
        _close(out["y"], y_ref, 1e-5, 1e-6)
        gx, grouter, *gw = out["grads"]
        _close(gx, grads[0], 1e-5, 1e-6)
        _close(grouter, grads[1], 1e-5, 1e-6)
        for got, want in zip(gw, grads[2:]):
            _close(got, want[rank * e_loc:(rank + 1) * e_loc], 1e-5, 1e-6)


def test_ep_model_equals_plain(setup):
    _, ins, outs = setup
    _, _, loss, logits, mgrads = _plain(ins)
    e_loc = worlds._ep_config("olmoe_1b_7b").n_experts // 2
    for rank, out in enumerate(outs):
        assert out["loss"] == pytest.approx(loss, rel=1e-5)
        _close(out["logits"], logits, 1e-4, 1e-5)
        for key in ("embed", "final_norm", "lm_head"):
            _close(out["model_grads"][key], mgrads[key], 1e-4, 1e-5)
        for name, got in out["model_grads"]["blocks"].items():
            want = mgrads["blocks"][name]
            if name in EXPERT_LEAVES:
                want = want[:, rank * e_loc:(rank + 1) * e_loc]
            _close(got, want, 1e-4, 1e-5)


def test_each_rank_holds_its_slice_under_the_reference_specs(setup):
    jcfg, ins, outs = setup

    class Mesh:
        axis_names = ("data", "model")
        devices = np.empty((1, 2))

    specs = jsharding.param_specs(jcfg, Mesh(), use_fsdp=False)["blocks"]
    e_loc = jcfg.n_experts // 2
    for rank, out in enumerate(outs):
        for name in EXPERT_LEAVES:
            assert tuple(specs[name]) == (None, "model", None, None)
            want = ins["params"]["blocks"][name][:, rank * e_loc:
                                                 (rank + 1) * e_loc]
            np.testing.assert_array_equal(out["shard"][name], want)


def test_reference_ep_gradient_equals_plain_on_a_model_mesh(setup):
    """The reference's gradient of its EP block == the plain function's on
    a ("model",) mesh under ``jax.set_mesh``; on a (1, 2) ("data",
    "model") mesh the installed JAX refuses the reference's shard_map."""
    jcfg, ins, _ = setup
    p0 = {k: jnp.asarray(ins["params"]["blocks"][k][0])
          for k in ("router", *EXPERT_LEAVES)}
    x, r = jnp.asarray(ins["x"]), jnp.asarray(ins["r"])
    mesh = jax.make_mesh((2,), ("model",))

    def ep(x, p):
        return jnp.sum(jblocks.moe_apply_ep(jcfg, p, x, mesh) * r)

    def plain(x, p):
        return jnp.sum(jblocks.moe_apply(jcfg, p, x) * r)

    with jax.set_mesh(mesh):
        got = jax.grad(ep, argnums=(0, 1))(x, p0)
    want = jax.grad(plain, argnums=(0, 1))(x, p0)
    _close(got[0], want[0], 1e-5, 1e-6)
    for k in p0:
        _close(got[1][k], want[1][k], 1e-5, 1e-6)
    with pytest.raises(ValueError, match="out_specs"):
        jblocks.moe_apply_ep(jcfg, p0, x,
                             jax.make_mesh((1, 2), ("data", "model")))
