"""The dry run's collective term: ``distributed.hlo_analysis`` on the port's
placed program lowered over a recording layout, held against a hand count
and against the reference's ``analyze_collectives`` of its compiled
program on the 8 CPU devices of ``tests/conftest.py``.

  * smoke granite-8b in f32 at (data 2, model 4), a (8, 16) batch: the
    recorded bytes by kind == the Megatron pattern counted by hand below;
  * the DP-only layout (data 8, model 1): the port's total == the
    reference's compiled train step's, each being the f32 gradient's
    all-reduce (4 B a parameter) plus two scalar reductions (the
    reference's: the loss's sum and its token count over 'data'; the port's:
    the loss's mean, in the gradient's bucket, and the clip's norm);
  * the TP layouts: the port moves no more than the reference's program,
    and within 2x of it where GSPMD partitions the blocks as Megatron does
    (``WITHIN_2X``).  Where it does not (``CAVEATS``, ROADMAP "Reference
    caveats"), the reference all-gathers the attention or expert weights
    (or reshards the SSD scan) in each forward, twice under its remat, and
    all-reduces its row-parallel partials whole where the port
    reduce-scatters them: the port moves under half its bytes.  The test
    holds each side of that line, so a change of either partitioner
    shows; ``-s`` prints every ratio.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.distributed import hlo_analysis as jhlo
from repro.distributed import sharding as jsharding
from repro.models import common as jcommon
from repro.optim import optimizers as joptim
from repro.training import steps as jsteps
from repro_torch.configs import registry
from repro_torch.distributed import hlo_analysis

B, T = 8, 16
F32 = 4

#: (arch, data, model, fsdp): port / reference within 2x
WITHIN_2X = (("granite_8b", 2, 2, False), ("granite_8b", 2, 4, False))
#: port under half the reference's bytes: GSPMD gathers the attention
#: weights (granite on (1, 4), whisper), the experts' (olmoe) or reshards
#: the SSD scan with all-to-alls (mamba2), then again in its remat
CAVEATS = (("granite_8b", 1, 4, False), ("granite_8b", 2, 4, True),
           ("olmoe_1b_7b", 2, 4, False), ("mamba2_2p7b", 1, 4, False),
           ("whisper_tiny", 2, 2, False))


def _cfg(arch):
    return dataclasses.replace(registry.get_smoke_config(arch),
                               dtype=torch.float32)


def _port(arch, data, model, fsdp=False) -> dict:
    return hlo_analysis.lower_cell(
        _cfg(arch), registry.ShapeCell("smoke", "train", T, B),
        {"data": data, "model": model}, use_fsdp=fsdp)


def _reference(arch, data, model, fsdp=False) -> dict:
    """``analyze_collectives`` of the reference's compiled train step
    (AdamW, the clip), params and batch placed by its specs, its
    activation constraints on."""
    cfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype=jnp.float32)
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = jsharding.param_specs(cfg, mesh, use_fsdp=fsdp)
    opt = joptim.adamw(joptim.cosine_schedule(3e-4))
    state = jax.eval_shape(lambda: jsteps.init_train_state(
        cfg, opt, jax.random.PRNGKey(0)))
    sspecs = {"params": pspecs,
              "opt_state": jsharding.opt_specs_like(pspecs,
                                                    state["opt_state"]),
              "step": JP()}
    batch = {k: jax.ShapeDtypeStruct((B, T), jnp.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = jax.ShapeDtypeStruct(
            (B, cfg.encoder_frames, cfg.d_model), jnp.float32)
    bspecs = jsharding.batch_specs(cfg, mesh, batch)
    jcommon.set_run_options(mesh=mesh, seq_parallel=True)
    try:
        with mesh:
            hlo = jax.jit(
                jsteps.make_train_step(cfg, opt),
                in_shardings=(jsharding.named(mesh, sspecs),
                              jsharding.named(mesh, bspecs)),
                out_shardings=(jsharding.named(mesh, sspecs), None),
            ).lower(state, batch).compile().as_text()
    finally:
        jcommon.set_run_options(mesh=None)
    return jhlo.analyze_collectives(hlo)


def test_granite_bytes_equal_the_megatron_hand_count():
    """(data 2, model 4): b = 4 rows a rank, T = 16 positions (t = 4 a
    rank), D = 128, f32.  granite's 8 query heads split, its 2 K/V heads do
    not (wk / wv whole), d_ff 384 and the 512-word vocabulary split."""
    cfg = _cfg("granite_8b")
    b, t_all, d, tp = B // 2, T, cfg.d_model, 4
    t = t_all // tp
    whole = b * t_all * d * F32          # a gathered (b, T, D) stream
    shard = b * t * d * F32              # a (b, t, D) shard
    sub_blocks = 2 * cfg.n_layers        # attention and MLP a layer
    # each sub-block: forward all-gather in, reduce-scatter out; backward
    # the reduce-scatter of the input's partials, the all-gather of the
    # output's gradient
    ag = sub_blocks * 2 * whole
    rs = sub_blocks * 2 * shard
    # the vocabulary-parallel embedding (a partial: reduce-scatter, its
    # gradient all-gathered) and the head (its input gathered, the
    # gradient's partials reduce-scattered)
    ag += 2 * whole
    rs += 2 * shard
    # the vocabulary-parallel loss: the row max, then the sum and the gold
    ar = b * t_all * F32 + 2 * b * t_all * F32
    # the gradient sync: leaves whole on 'model' (norms, wk, wv) summed over
    # 'model' then 'data'; the split leaves and the loss over 'data'
    L, hkv_dh = cfg.n_layers, cfg.n_kv_heads * cfg.head_dim
    whole_leaves = 2 * L * d + d + 2 * L * d * hkv_dh
    split_leaves = (2 * L * d * d + 3 * L * d * cfg.d_ff
                    + 2 * cfg.vocab * d) // tp
    ar += 2 * whole_leaves * F32 + (split_leaves + 1) * F32
    ar += 2 * F32                        # the clip's norm over both axes
    got = _port("granite_8b", 2, 4)
    assert got["bytes_by_kind"] == {"all-gather": ag, "reduce-scatter": rs,
                                    "all-reduce": ar}
    assert got["total_bytes"] == ag + rs + ar == 1_038_092
    assert got["loops"] == [("blocks", 2)]
    assert got["count_by_kind"] == {"all-gather": 10, "reduce-scatter": 10,
                                    "all-reduce": 7}


def test_dp_only_bytes_equal_the_references():
    cfg = _cfg("granite_8b")
    port = _port("granite_8b", 8, 1)
    ref = _reference("granite_8b", 8, 1)
    grads = F32 * cfg.n_params()
    scalars = 2 * F32
    assert port["total_bytes"] - scalars == grads
    assert ref["total_bytes"] - scalars == grads
    assert port["bytes_by_kind"] == {"all-reduce": grads + scalars}


@pytest.mark.parametrize("case", WITHIN_2X + CAVEATS,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}"
                         + ("-fsdp" if c[3] else ""))
def test_tp_bytes_against_the_reference(case):
    port = _port(*case)["total_bytes"]
    ref = _reference(*case)["total_bytes"]
    ratio = port / ref
    print(f"\n{case}: port {port:,} B, reference {ref:,} B, "
          f"ratio {ratio:.3f}")
    assert 0 < port <= ref
    if case in WITHIN_2X:
        assert 2 * port >= ref
    else:
        assert 2 * port < ref
