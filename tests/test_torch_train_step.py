"""The port's train step held against ``repro.training.steps`` on the CPU.

For each of the ten ``smoke_config()``s in f32, the reference's ``init``
makes the params, ``interop.params_from_reference`` carries them across,
and the same numpy batches go through both packages:

  * one step's loss and every grad leaf (autograd against
    ``jax.value_and_grad``) at ``rtol=1e-4``, ``atol=1e-5 * max|g|``;
  * the params after 3 SGD steps at the same tolerance;
  * under AdamW, the loss of each of 3 steps at ``rtol=1e-4`` and the
    params at ``rtol=1e-4``, except entries whose reference gradient was
    below ``TINY_GRAD * max|g|`` at some step: Adam divides a gradient by
    its own root mean square, so a relative gap in the gradient becomes
    the same relative gap in a step of size ``lr``, and the gradient
    comparison above allows an entry at ``1e-3 * max|g|`` a 1% gap
    (``atol=1e-5 * max|g|``).  The entries past ``rtol=1e-4`` had
    gradients of 1e-8 to 2.2e-4 of the leaf's largest at some step (OLMoE
    and InternVL2 the largest ratios).

The reference's step is ``make_train_step``'s body, ``value_and_grad``,
``clip_by_global_norm`` and ``optimizer.update``, each jitted, so each
config compiles its model once; for granite-8b the whole jitted
``make_train_step`` is held too.

Also the reference's trainability contract (``tests/test_archs.py``): the
port's loss falls by 0.2 in 30 AdamW steps on the Markov pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import get_api as jget_api
from repro.optim import optimizers as joptim
from repro.training import steps as jsteps
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.models.api import get_api
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training import steps

torch.set_num_threads(1)

B, T, N_STEPS = 2, 8, 3
RTOL, ATOL_REL = 1e-4, 1e-5
TINY_GRAD = 1e-3


def _batch(cfg, seed: int) -> dict:
    """numpy inputs: tokens, next-token labels (the last one -1, masked),
    and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    batch = {"tokens": toks[:, :T], "labels": labels}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_leaves(got, want, what: str, masks=None) -> None:
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, i)
        atol = ATOL_REL * max(float(np.abs(b).max()), 1e-30)
        if masks is not None:
            a, b = a[masks[i]], b[masks[i]]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=f"{what} leaf {i}")


class Pair:
    def __init__(self, arch: str):
        self.jcfg = jreg.get_smoke_config(arch)
        self.tcfg = registry.get_smoke_config(arch)
        japi = jget_api(self.jcfg)
        self.jparams = japi.init(jax.random.PRNGKey(0))
        self.tparams = interop.params_from_reference(self.jparams, self.tcfg,
                                                     device="cpu")
        self.value_and_grad = jax.jit(jax.value_and_grad(japi.loss_fn))
        self.loss_fn = get_api(self.tcfg).loss_fn

    def step_fn(self, jopt, *, whole: bool = False):
        """The reference's train step: ``make_train_step`` jitted whole,
        or its body from this pair's compiled ``value_and_grad``."""
        if whole:
            return jax.jit(jsteps.make_train_step(self.jcfg, jopt))
        clip = jax.jit(lambda g: joptim.clip_by_global_norm(g, 1.0))
        update = jax.jit(jopt.update)

        def step(state, batch):
            loss, grads = self.value_and_grad(state["params"], batch)
            grads, gnorm = clip(grads)
            params, opt_state = update(grads, state["opt_state"],
                                       state["params"])
            return ({"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1},
                    {"loss": loss, "grad_norm": gnorm})
        return step


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Pair(arch)
        return cache[arch]
    return get


def _states(pr, jopt, topt):
    jstate = {"params": pr.jparams, "opt_state": jopt.init(pr.jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": pr.tparams, "opt_state": topt.init(pr.tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    return jstate, tstate


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_loss_and_grads_equal_reference(pairs, arch):
    pr = pairs(arch)
    batch = _batch(pr.tcfg, 1)
    jloss, jgrads = pr.value_and_grad(pr.jparams, _jax(batch))
    tloss, tgrads = steps.loss_and_grads(pr.loss_fn, pr.tparams,
                                         _torch(batch))
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    for g, p in zip(tree_leaves(tgrads), tree_leaves(pr.tparams)):
        assert g.dtype == p.dtype and g.shape == p.shape
    _close_leaves(tgrads, jgrads, f"{arch} grads")


WHOLE = [(arch, False) for arch in registry.ARCH_IDS] + [
    ("granite_8b", True)]
WHOLE_IDS = [f"{a}{'-whole' if w else ''}" for a, w in WHOLE]


@pytest.mark.parametrize("arch,whole", WHOLE, ids=WHOLE_IDS)
def test_sgd_steps_equal_reference(pairs, arch, whole):
    pr = pairs(arch)
    jopt, topt = joptim.sgd(0.1), optimizers.sgd(0.1)
    jstep = pr.step_fn(jopt, whole=whole)
    tstep = steps.make_train_step(pr.tcfg, topt)
    jstate, tstate = _states(pr, jopt, topt)
    for s in range(N_STEPS):
        batch = _batch(pr.tcfg, 10 + s)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
    assert int(tstate["step"]) == N_STEPS
    _close_leaves(tstate["params"], jstate["params"], f"{arch} sgd params")


@pytest.mark.parametrize("arch,whole", WHOLE, ids=WHOLE_IDS)
def test_adamw_steps_equal_reference(pairs, arch, whole):
    pr = pairs(arch)
    jopt, topt = joptim.adamw(1e-3), optimizers.adamw(1e-3)
    jstep = pr.step_fn(jopt, whole=whole)
    tstep = steps.make_train_step(pr.tcfg, topt)
    jstate, tstate = _states(pr, jopt, topt)
    masks = None
    for s in range(N_STEPS):
        batch = _batch(pr.tcfg, 20 + s)
        _, jgrads = pr.value_and_grad(jstate["params"], _jax(batch))
        tiny = [np.abs(_np(g)) < TINY_GRAD * np.abs(_np(g)).max()
                for g in jax.tree.leaves(jgrads)]
        masks = ([~t for t in tiny] if masks is None
                 else [m & ~t for m, t in zip(masks, tiny)])
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL, err_msg=f"{arch} step {s}")
    assert sum(int(m.sum()) for m in masks) > 0.5 * sum(m.size
                                                         for m in masks)
    _close_leaves(tstate["params"], jstate["params"], f"{arch} adamw params",
                  masks=masks)


def test_loss_decreases_on_learnable_data():
    cfg = registry.get_smoke_config("granite_8b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    opt = optimizers.adamw(3e-3)
    step = steps.make_train_step(cfg, opt)
    state = steps.init_train_state(cfg, opt, 0, device="cpu")
    losses = []
    for i in range(30):
        state, metrics = step(state, lm_batch(dcfg, i, device="cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses
