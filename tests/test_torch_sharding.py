"""The placement specs (``distributed.sharding``, ``models.common``'s rules)
held against the reference's ``repro/distributed/sharding.py``.

  * ``param_specs`` for all ten published configs on (16, 16), (2, 16, 16),
    (2, 4), (4, 2) and (2, 2, 2), FSDP on and off, and ``opt_specs_like``,
    entry for entry; ``batch_specs`` and ``cache_specs`` for every
    applicable (arch x shape) cell's inputs and decode cache.  The
    reference reads only a mesh's ``axis_names`` and ``devices.shape``, so
    a small object with those two stands in for the production meshes;
  * the counterparts of ``tests/test_distributed.py:34-60``;
  * ``local_shard`` and ``gather_shards`` round trips in a 4-rank gloo world
    on a (2, 2) grid, and ``local_shard`` refusing a dim that does not
    split;
  * ``Checkpointer.restore(..., placement=)``: the reference's olmoe smoke
    state written under a (4, 2) mesh restores under (2, 2), each
    coordinate's leaves == its ``local_shard`` (the reference's
    ``tests/test_distributed.py:134``), and the port's own checkpoint alike;
  * ``device_bytes`` against the reference's compiled
    ``memory_analysis().argument_size_in_bytes`` for a smoke train cell
    with FSDP on a (2, 4) mesh and a smoke decode cell on (2, 2, 2), on the
    CPU devices.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
from repro.configs import registry as jreg
from repro.distributed import sharding as jsharding
from repro.optim import optimizers as joptim
from repro.training import steps as jsteps
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.distributed import process_group, sharding
from repro_torch.launch import dryrun
from repro_torch.models.api import get_api
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import AdamState, SGDState, tree_leaves
from repro_torch.training import steps

torch.set_num_threads(1)

LAYOUTS = [((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model")),
           ((2, 4), ("data", "model")),
           ((4, 2), ("data", "model")),
           ((2, 2, 2), ("pod", "data", "model"))]
LAYOUT_IDS = ["x".join(map(str, s)) for s, _ in LAYOUTS]


class FakeMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _norm(tree):
    """A spec tree as nested dicts / tuples of plain tuples."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_param_specs_equal_the_reference(arch, layout):
    shape, axes = layout
    for fsdp in (False, True):
        want = jsharding.param_specs(jreg.get_config(arch),
                                     FakeMesh(shape, axes), use_fsdp=fsdp)
        got = sharding.param_specs(registry.get_config(arch),
                                   dict(zip(axes, shape)), use_fsdp=fsdp)
        assert _norm(got) == _norm(want), (arch, layout, fsdp)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    for shape, axes in LAYOUTS:
        mesh, sizes = FakeMesh(shape, axes), dict(zip(axes, shape))
        for cell, jcell in zip(registry.SHAPES, jreg.SHAPES):
            if not registry.cell_applicable(cfg, cell)[0]:
                continue
            got = sharding.batch_specs(cfg, sizes,
                                       registry.input_specs(cfg, cell))
            want = jsharding.batch_specs(jcfg, mesh,
                                         jreg.input_specs(jcfg, jcell))
            assert _norm(got) == _norm(want), (arch, cell.name, shape)
            if cell.kind == "train":
                continue
            dec = registry.ShapeCell(cell.name, "decode", cell.seq_len,
                                     cell.global_batch)
            jdec = jreg.ShapeCell(cell.name, "decode", cell.seq_len,
                                  cell.global_batch)
            got = sharding.cache_specs(cfg, sizes,
                                       registry.cache_shapes(cfg, dec))
            want = jsharding.cache_specs(jcfg, mesh,
                                         jreg.cache_shapes(jcfg, jdec))
            assert _norm(got) == _norm(want), (arch, cell.name, shape)


def test_long_context_cache_folds_dp_into_the_sequence():
    """long_500k's b = 1 cache: the DP axes join 'model' on the sequence
    (reference lines 150-162)."""
    cfg = registry.get_config("hymba_1p5b")
    cell = next(c for c in registry.SHAPES if c.name == "long_500k")
    specs = sharding.cache_specs(cfg, {"pod": 2, "data": 16, "model": 16},
                                 registry.cache_shapes(cfg, cell))
    assert tuple(specs["k"]) == (None, None, ("pod", "data", "model"), None,
                                 None)


def test_opt_specs_like_mirror_the_params():
    cfg = registry.get_smoke_config("granite_8b")
    pspecs = sharding.param_specs(cfg, {"data": 2, "model": 4},
                                  use_fsdp=True)
    params = get_api(cfg).init(0, device="meta")
    adam = sharding.opt_specs_like(pspecs, optimizers.adamw(1e-3).init(
        params))
    assert isinstance(adam, AdamState)
    assert adam.mu is pspecs and adam.nu is pspecs and adam.count == ()
    for momentum, want in ((0.9, pspecs), (0.0, None)):
        sgd = sharding.opt_specs_like(pspecs, optimizers.sgd(
            0.1, momentum=momentum).init(params))
        assert isinstance(sgd, SGDState) and sgd.momentum is want
    with pytest.raises(TypeError):
        sharding.opt_specs_like(pspecs, object())


def test_param_specs_divisibility_policy():
    """Heads sharded only where they divide; the MLP always; norms
    replicated (``tests/test_distributed.py:34``)."""
    sizes = {"data": 2, "model": 4}
    specs = sharding.param_specs(registry.get_smoke_config("granite_8b"),
                                 sizes, use_fsdp=False)
    assert specs["blocks"]["wq"] == sharding.P(None, None, "model")
    assert specs["blocks"]["attn_norm"] == sharding.P(None, None)
    assert specs["blocks"]["w_gate"][2] == "model"
    specs2 = sharding.param_specs(registry.get_smoke_config("starcoder2_7b"),
                                  sizes, use_fsdp=False)
    assert specs2["blocks"]["wq"] == sharding.P(None, None, None)
    assert specs2["blocks"]["w_gate"] == sharding.P(None, None, "model")


def test_param_specs_fsdp_adds_data_axis():
    """``tests/test_distributed.py:54``: wq (L, D, H*Dh) takes TP on dim 2
    and FSDP on dim 1."""
    specs = sharding.param_specs(registry.get_smoke_config("granite_8b"),
                                 {"data": 2, "model": 4}, use_fsdp=True)
    assert specs["blocks"]["wq"] == sharding.P(None, "data", "model")


def test_rules_from_groups_and_mappings():
    from repro_torch.models import common
    from repro_torch.topology import Groups
    groups = Groups(axes=("pod", "data", "model"), shape=(2, 4, 2),
                    members=(), coords=(), groups=())
    r = common.make_rules(groups, use_fsdp=True)
    assert (r.tp, r.fsdp, r.dp, r.tp_size, r.fsdp_size) == (
        "model", "data", ("pod", "data"), 2, 4)
    r = common.make_rules({"data": 8}, use_fsdp=False)
    assert (r.tp, r.fsdp, r.dp, r.tp_size) == (None, None, ("data",), 1)
    assert common.axis_ok(8, 4) and not common.axis_ok(6, 4)
    assert not common.axis_ok(8, 0)


# ---------------------------------------------------------------------------
# acting on the specs
# ---------------------------------------------------------------------------

ROUND_TRIP = {
    "both_on_rows": ((8, 6), (("data", "model"), None)),
    "model_then_data": ((4, 6), ("model", "data")),
    "model_data_cols": ((3, 8), (None, ("model", "data"))),
    "data_only": ((6, 5), ("data", None)),
    "whole": ((3, 5), (None, None)),
}


@pytest.fixture(scope="module")
def round_trips():
    rng = np.random.default_rng(7)
    ins = {k: (rng.standard_normal(shape).astype(np.float32), spec)
           for k, (shape, spec) in ROUND_TRIP.items()}
    return ins, process_group.spawn(worlds.shard_round_trips, 4, ins,
                                    device="cpu")


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_local_shard_and_gather_round_trip(round_trips, name):
    ins, outs = round_trips
    x, spec = ins[name]
    sizes = {"data": 2, "model": 2}
    for rank, out in enumerate(outs):
        local, whole = out[name]
        np.testing.assert_array_equal(whole, x)
        coords = {"data": rank // 2, "model": rank % 2}
        want = sharding.local_shard(torch.from_numpy(x), sharding.P(*spec),
                                    sizes, coords).numpy()
        np.testing.assert_array_equal(local, want)
    # the row-major order over a tuple of axes, the first outermost
    if name == "both_on_rows":
        for rank, out in enumerate(outs):
            np.testing.assert_array_equal(out[name][0],
                                          x[2 * rank:2 * rank + 2])


def test_local_shard_refuses_what_does_not_split():
    x = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_shard(x, sharding.P("data", None), {"data": 4},
                             {"data": 0})
    with pytest.raises(ValueError, match="entries"):
        sharding.local_shard(x, sharding.P("data"), {"data": 2}, {"data": 0})
    assert sharding.local_shard(x, sharding.P(None, None), {}, {}) is x


def _state_specs(cfg, sizes, opt_state):
    pspecs = sharding.param_specs(cfg, sizes, use_fsdp=False)
    return {"params": pspecs,
            "opt_state": sharding.opt_specs_like(pspecs, opt_state),
            "step": sharding.P()}


def _check_restored(ck, step, whole, cfg, sizes):
    specs = _state_specs(cfg, sizes, whole["opt_state"])
    for d in range(sizes["data"]):
        for m in range(sizes["model"]):
            coords = {"data": d, "model": m}
            got = ck.restore(step, whole, device="cpu",
                             placement=sharding.Placement(specs, sizes,
                                                          coords))
            want = [sharding.local_shard(x, s, sizes, coords)
                    for x, s in zip(tree_leaves(whole),
                                    sharding.spec_leaves(specs))]
            got = tree_leaves(got)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_across_layouts_from_the_reference(tmp_path):
    """The reference's olmoe smoke state placed on a (4, 2) mesh and
    saved; the port restores it under (2, 2), every coordinate."""
    jcfg = jreg.get_smoke_config("olmoe_1b_7b")
    jstate = jsteps.init_train_state(jcfg, joptim.adamw(1e-3),
                                     jax.random.PRNGKey(0))
    mesh_a = jax.make_mesh((4, 2), ("data", "model"))
    specs_a = jsharding.param_specs(jcfg, mesh_a, use_fsdp=False)
    state_specs = {"params": specs_a,
                   "opt_state": jsharding.opt_specs_like(
                       specs_a, jstate["opt_state"]),
                   "step": jax.sharding.PartitionSpec()}
    placed = jax.device_put(jstate, jsharding.named(mesh_a, state_specs))
    JCheckpointer(str(tmp_path)).save(7, placed)
    cfg = registry.get_smoke_config("olmoe_1b_7b")
    whole = {"params": interop.params_from_reference(jstate["params"], cfg,
                                                     device="cpu")}
    whole["opt_state"] = AdamState(
        mu=interop.params_from_reference(jstate["opt_state"].mu, cfg,
                                         device="cpu"),
        nu=interop.params_from_reference(jstate["opt_state"].nu, cfg,
                                         device="cpu"),
        count=torch.tensor(int(jstate["opt_state"].count),
                           dtype=torch.int32))
    whole["step"] = torch.tensor(int(jstate["step"]), dtype=torch.int32)
    _check_restored(Checkpointer(str(tmp_path)), 7, whole, cfg,
                    {"data": 2, "model": 2})


def test_restore_across_layouts_of_the_ports_own(tmp_path):
    cfg = registry.get_smoke_config("olmoe_1b_7b")
    opt = optimizers.adamw(1e-3)
    state = steps.init_train_state(cfg, opt, 3, device="cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(5, state)
    _check_restored(ck, 5, state, cfg, {"data": 2, "model": 2})
    _check_restored(ck, 5, state, cfg, {"data": 4, "model": 2})


# ---------------------------------------------------------------------------
# device bytes against XLA's argument sizes
# ---------------------------------------------------------------------------

TRAIN_CELL = ("train_smoke", "train", 32, 8)
DECODE_CELL = ("decode_smoke", "decode", 64, 8)


def _xla_train_argument_bytes(mesh, cell) -> int:
    jcfg = jreg.get_smoke_config("granite_8b")
    pspecs = jsharding.param_specs(jcfg, mesh, use_fsdp=True)
    opt = joptim.adamw(joptim.cosine_schedule(3e-4))
    state = jax.eval_shape(lambda: jsteps.init_train_state(
        jcfg, opt, jax.random.PRNGKey(0)))
    state_specs = {"params": pspecs,
                   "opt_state": jsharding.opt_specs_like(
                       pspecs, state["opt_state"]),
                   "step": jax.sharding.PartitionSpec()}
    batch = jreg.input_specs(jcfg, cell)
    bspecs = jsharding.batch_specs(jcfg, mesh, batch)
    step = jsteps.make_train_step(jcfg, opt)
    with mesh:
        compiled = jax.jit(
            step, in_shardings=(jsharding.named(mesh, state_specs),
                                jsharding.named(mesh, bspecs)),
            donate_argnums=(0,)).lower(state, batch).compile()
    return compiled.memory_analysis().argument_size_in_bytes


def _xla_decode_argument_bytes(mesh, cell) -> int:
    jcfg = jreg.get_smoke_config("granite_8b")
    pspecs = jsharding.param_specs(jcfg, mesh, use_fsdp=False)
    from repro.models.api import get_api as jget_api
    params = jax.eval_shape(jget_api(jcfg).init, jax.random.PRNGKey(0))
    cache = jreg.cache_shapes(jcfg, cell)
    tokens = jreg.input_specs(jcfg, cell)["tokens"]
    cspecs = jsharding.cache_specs(jcfg, mesh, cache)
    tspec = jsharding.batch_specs(jcfg, mesh, {"tokens": tokens})["tokens"]
    step = jsteps.make_serve_step(jcfg)
    with mesh:
        compiled = jax.jit(
            step, in_shardings=(jsharding.named(mesh, pspecs),
                                jsharding.named(mesh, cspecs),
                                jax.sharding.NamedSharding(mesh, tspec)),
            donate_argnums=(1,)).lower(params, cache, tokens).compile()
    return compiled.memory_analysis().argument_size_in_bytes


def _port_argument_bytes(cell, sizes, *, use_fsdp) -> int:
    cfg = registry.get_smoke_config("granite_8b")
    args = dryrun.cell_arguments(cfg, cell, sizes, use_fsdp=use_fsdp)
    return sum(sharding.device_bytes(t, s, sizes)
               for k, (t, s) in args.items() if k != "cache_out")


@pytest.mark.devices(8)
def test_device_bytes_equal_xla_argument_bytes_train_fsdp():
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    want = _xla_train_argument_bytes(mesh, jreg.ShapeCell(*TRAIN_CELL))
    got = _port_argument_bytes(registry.ShapeCell(*TRAIN_CELL),
                               {"data": 2, "model": 4}, use_fsdp=True)
    assert got == want


@pytest.mark.devices(8)
def test_device_bytes_equal_xla_argument_bytes_decode():
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    want = _xla_decode_argument_bytes(mesh, jreg.ShapeCell(*DECODE_CELL))
    got = _port_argument_bytes(registry.ShapeCell(*DECODE_CELL),
                               {"pod": 2, "data": 2, "model": 2},
                               use_fsdp=False)
    assert got == want


def test_device_bytes_counts_quantized_and_scalar_leaves():
    sizes = {"data": 2, "model": 4}
    cfg = registry.get_smoke_config("granite_8b")
    cell = registry.ShapeCell(*DECODE_CELL)
    plain = dryrun.cell_arguments(cfg, cell, sizes, use_fsdp=False)
    quant = dryrun.cell_arguments(cfg, cell, sizes, use_fsdp=False,
                                  quantized=True)
    pb = sharding.device_bytes(*plain["params"], sizes)
    qb = sharding.device_bytes(*quant["params"], sizes)
    assert 0 < qb < pb           # int8 weights, f32 scales replicated
    assert sharding.device_bytes({"n": 7}, {"n": sharding.P()}, sizes) == 4
    whole = torch.empty((8, 6), device="meta")
    assert sharding.device_bytes(whole, sharding.P(("data", "model"), None),
                                 sizes) == 1 * 6 * 4


def test_window_cell_adds_the_merge_state():
    cfg = registry.get_smoke_config("granite_8b")
    cell = registry.ShapeCell(*TRAIN_CELL)
    sizes = {"pod": 2, "data": 2, "model": 2}
    base = dryrun.cell_arguments(cfg, cell, sizes, use_fsdp=False)
    for merge, extra in (("async_delta", "delta_prev"),
                         ("delta_sparse", "residual"), ("delta", None)):
        got = dryrun.cell_arguments(cfg, cell, sizes, use_fsdp=False,
                                    window=True, merge=merge, tau=3)
        state, specs = got["state"]
        assert (extra in state) == (extra is not None)
        batch, bspecs = got["batch"]
        assert batch["tokens"].shape == (3, *base["batch"][0][
            "tokens"].shape)
        assert tuple(bspecs["tokens"]) == (None, ("pod", "data"), None)
        if extra:
            assert specs[extra] is specs["params"]
            for a, b in zip(tree_leaves(state[extra]),
                            tree_leaves(state["params"])):
                assert a.shape == b.shape and a.dtype == torch.float32
