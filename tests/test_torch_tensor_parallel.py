"""The LM's placement as a program (``models.common.Placed``): tensor
parallelism over 'model' with the residual stream sequence-parallel, FSDP
over 'data' and the batch over it, in a gloo world of 4 ranks on the CPU
(one thread a rank), held against the one-process port and the reference.

Four smoke configs in f32 (granite-8b: GQA 8/2, so on 4 ranks the query
heads split and each rank takes its K/V groups; olmoe-1b-7b: experts over
'model'; mamba2-2.7b: d_inner and the SSM heads; whisper-tiny: the encoder,
cross-attention and the tied vocabulary-parallel head), their params from
the reference's ``init``, a (4, 8) batch, on the layouts (data 1, model 2)
(twice, on ranks 0-1 and 2-3), (1, 4) and (2, 2), FSDP off and on:

  * each rank's loss, its logits (its batch rows, every vocabulary column)
    and its synced gradient shards (``training.steps.sync_grads``) == the
    one-process port's loss, logits and its gradients' slices under
    ``sharding.param_specs`` at rtol=1e-4, atol=1e-6 x max;
  * the reference's jitted loss under its own ``set_run_options(mesh=...)``
    on a (2, 2) mesh of the 8 CPU devices (``tests/conftest.py``), its
    params and batch placed by its ``param_specs`` / ``batch_specs``,
    agrees with the port's at the same tolerance;
  * greedy decoding over the sequence-split cache (``cache_specs``: the
    positions over 'model'; the new token's K/V written on the one rank
    that holds its position, the ranks' softmax combined by all-reduces)
    gives the one-process port's tokens, and a step past the whole cache
    raises;
  * in bf16 on (data 2, model 1), where the vocabulary does not split, the
    loss is the f32 cross-entropy of the bf16 logits;
  * the collectives a rank recorded over the loss, the sync and the clip,
    over a prefill and over one decode step == ``distributed.hlo_analysis
    .lower_cell``'s figure for the same step or cell, lowered on ``meta``
    shards with each stack cut to one layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_worlds as worlds
from repro.configs import registry as jreg
from repro.distributed import sharding as jsharding
from repro.models import common as jcommon
from repro.models.api import get_api as jget_api
from repro_torch.configs import registry
from repro_torch.distributed import hlo_analysis, process_group, sharding
from repro_torch.models import blocks, common
from repro_torch.models.api import get_api
from repro_torch.training import steps

torch.set_num_threads(1)

ARCHS = ("granite_8b", "olmoe_1b_7b", "mamba2_2p7b", "whisper_tiny")
B, T = 4, 8
MAX_LEN, DECODE_STEPS = 16, 3
RTOL, ATOL = 1e-4, 1e-6


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)


def _jcfg(arch):
    return dataclasses.replace(jreg.get_smoke_config(arch),
                               dtype=jnp.float32)


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:].copy()}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def world():
    ins = {"archs": ARCHS, "params": {}, "batch": {}, "max_len": MAX_LEN,
           "decode_steps": DECODE_STEPS}
    for i, arch in enumerate(ARCHS):
        jcfg = _jcfg(arch)
        ins["params"][arch] = jax.tree.map(
            np.asarray, jget_api(jcfg).init(jax.random.PRNGKey(i)))
        ins["batch"][arch] = _batch(jcfg, i)
    outs = process_group.spawn(worlds.tensor_parallel_runs, 4, ins,
                               device="cpu")
    return ins, outs


def _one_process(ins, arch):
    """The one-process port: loss, grads, logits, greedy tokens."""
    cfg = worlds._ep_config(arch)
    api = get_api(cfg)
    params = worlds._tree_t(ins["params"][arch])
    batch = worlds._tree_t(ins["batch"][arch])
    loss, grads = steps.loss_and_grads(api.loss_fn, params, batch)
    with torch.no_grad():
        logits = api.forward(params, batch)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    toks, *_ = worlds._greedy(api, params, prompt, MAX_LEN, DECODE_STEPS)
    return cfg, float(loss), grads, logits.numpy(), toks.numpy()


def _rows(x, run):
    """The batch rows of ``run``'s rank: the data coord's share."""
    n = B // run["sizes"]["data"]
    d = run["coords"]["data"]
    return x[d * n:(d + 1) * n]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_loss_logits_and_grads_equal_one_process(world, arch):
    ins, outs = world
    cfg, loss, grads, logits, _ = _one_process(ins, arch)
    seen = 0
    for rank, out in enumerate(outs):
        for (a, layout, fsdp), run in out.items():
            if a != arch or layout == "bf16":
                continue
            what = f"{arch} {layout} fsdp={fsdp} rank {rank}"
            assert run["loss"] == pytest.approx(loss, rel=RTOL), what
            _close(run["logits"], _rows(logits, run), what)
            specs = sharding.param_specs(cfg, run["sizes"], use_fsdp=fsdp)
            want = sharding.local_tree(grads, specs, run["sizes"],
                                       run["coords"])
            for (name, got), (_, w) in zip(
                    _flat(run["grads"]), _flat(worlds._tree_np(want))):
                _close(got, w, f"{what} grad {name}")
            seen += 1
    assert seen == 4 * 3 * 2      # every rank, every layout, FSDP both ways


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_loss_under_its_mesh_agrees(world, arch):
    """The reference's loss with its activation constraints on a (2, 2)
    ("data", "model") mesh == the port's placed loss on the same layout."""
    ins, outs = world
    jcfg = _jcfg(arch)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = jax.tree.map(jnp.asarray, ins["params"][arch])
    batch = {k: jnp.asarray(v) for k, v in ins["batch"][arch].items()}
    pspecs = jsharding.param_specs(jcfg, mesh, use_fsdp=False)
    bspecs = jsharding.batch_specs(jcfg, mesh, batch)
    jcommon.set_run_options(mesh=mesh, seq_parallel=True)
    try:
        with mesh:
            ref = float(jax.jit(
                jget_api(jcfg).loss_fn,
                in_shardings=(jsharding.named(mesh, pspecs),
                              jsharding.named(mesh, bspecs)))(params, batch))
    finally:
        jcommon.set_run_options(mesh=None)
    for out in outs:
        run = out[(arch, "2x2", False)]
        assert run["loss"] == pytest.approx(ref, rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_sequence_split_cache_gives_equal_tokens(world, arch):
    ins, outs = world
    *_, toks = _one_process(ins, arch)
    for rank, out in enumerate(outs):
        for layout in worlds.TP_GRIDS:
            run = out[(arch, layout, False)]
            np.testing.assert_array_equal(run["tokens"], _rows(toks, run),
                                          err_msg=f"{arch} {layout} {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_past_the_split_cache_raises(world, arch):
    """A decode step at ``cur_len`` = the whole cache's length raises
    ValueError on every rank, as the one-process step does; a cache with
    no positions (mamba2's) has no such bound."""
    _, outs = world
    for rank, out in enumerate(outs):
        for layout in worlds.TP_GRIDS:
            assert out[(arch, layout, False)]["past_the_cache"] is (
                arch != "mamba2_2p7b"), (layout, rank)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_placed_loss_is_f32_cross_entropy(world, arch):
    """bf16 on (data 2, model 1), where the vocabulary does not split:
    each rank's loss == the one-process bf16 logits of its rows, their
    cross-entropy in f32 (the logits cast before ``logsumexp``), plus
    the MoE's load-balance loss of the whole batch."""
    ins, outs = world
    cfg = dataclasses.replace(worlds._ep_config(arch), dtype=torch.bfloat16)
    api = get_api(cfg)
    params = worlds.as_dtypes(cfg, worlds._tree_t(ins["params"][arch]))
    seen = 0
    for out in outs:
        for (a, layout, _), run in out.items():
            if a != arch or layout != "bf16":
                continue
            batch = {k: torch.from_numpy(_rows(v, run))
                     for k, v in ins["batch"][arch].items()}
            with torch.no_grad():
                logits = api.forward(params, batch).float()
            want = float(common.cross_entropy(logits, batch["labels"]))
            if cfg.family == "moe":   # the whole batch's router statistics
                toks = torch.from_numpy(ins["batch"][arch]["tokens"])
                want += 0.01 * float(blocks.moe_aux_loss(
                    cfg, params["blocks"]["router"][0],
                    F.embedding(toks, params["embed"]), common.placed(cfg)))
            assert run["loss"] == pytest.approx(want, rel=RTOL), run["coords"]
            seen += 1
    assert seen == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_live_prefill_and_decode_collectives_equal_the_lowered_cells(
        world, arch):
    """The bytes by kind each rank recorded over the live prefill and over
    its first decode step on the split cache == ``lower_cell``'s for a
    prefill cell and a decode cell of the same shapes, on every layout."""
    _, outs = world
    cfg = worlds._ep_config(arch)
    pre = registry.ShapeCell("smoke", "prefill", T, B)
    dec = registry.ShapeCell("smoke", "decode", MAX_LEN, B)
    for rank, out in enumerate(outs):
        for layout in worlds.TP_GRIDS:
            run = out[(arch, layout, False)]
            for cell, got in ((pre, run["prefill_bytes"]),
                              (dec, run["decode_bytes"])):
                low = hlo_analysis.lower_cell(cfg, cell, run["sizes"],
                                              use_fsdp=False,
                                              coords=run["coords"])
                assert low["bytes_by_kind"] == got, (layout, rank, cell.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_live_collectives_equal_the_lowered_step(world, arch):
    """The bytes by kind each rank recorded over the live loss, sync and
    clip == ``lower_cell``'s for the same step (one layer a stack, times
    its count), on every layout."""
    _, outs = world
    cfg = worlds._ep_config(arch)
    cell = registry.ShapeCell("smoke", "train", T, B)
    for (a, layout, fsdp), run in outs[0].items():
        if a != arch or layout == "bf16":
            continue
        low = hlo_analysis.lower_cell(cfg, cell, run["sizes"],
                                      use_fsdp=fsdp)
        assert low["bytes_by_kind"] == run["bytes"], (layout, fsdp)
        assert low["loops"] == sorted(hlo_analysis.stacks(cfg))
