"""The port's own model contracts, its registry, init and int8
quantization, on the CPU.

Mirrors ``tests/test_substrates.py``'s serving-parity and quantization
cases and ``tests/test_model_properties.py`` on the port's own init, at
their tolerances: prefill-by-decode == forward, prefill fills the cache
exactly, causality, batch independence, a finite loss on any tokens, MoE
capacity monotone, deterministic decode.  Against the reference:
``quantize_tree``'s ``q`` and ``scale`` bit for bit; every config's fields,
``n_params`` and ``active_params``; ``input_specs`` and ``cache_shapes`` of
every applicable (arch, shape) cell; init's leaf names, shapes and dtypes
(the random streams differ; the truncated normal's std and +-2 sigma cut
hold within a stated statistical tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import quantization as jquant
from repro.models.api import get_api as jget_api
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.models import quantization
from repro_torch.models.api import get_api
from repro_torch.training import steps

torch.set_num_threads(1)

CPU = "cpu"
SEED = 5


def _tokens(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)).astype(
        np.int32))


def _model(arch, **replace):
    cfg = registry.get_smoke_config(arch)
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    api = get_api(cfg)
    return cfg, api, api.init(SEED, device=CPU)


def _frames(cfg, b, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32))


# ---------------------------------------------------------------------------
# serving parity (tests/test_substrates.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_2p7b",
                                  "hymba_1p5b", "whisper_tiny"])
def test_prefill_by_decode_matches_forward(arch):
    """Teacher-forcing T tokens through decode_step reproduces forward()'s
    logits: the KV / SSM cache math is exact."""
    cfg, api, params = _model(arch)
    B, T = 2, 8
    toks = _tokens(cfg, B, T)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = _frames(cfg, B)
    ref = api.forward(params, batch)
    cache = api.init_cache(params, batch, T)
    outs = []
    for t in range(T):
        lg, cache = api.decode_step(params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(ref.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_2p7b",
                                  "hymba_1p5b", "olmoe_1b_7b"])
def test_prefill_fills_cache_exactly(arch):
    """prefill(T) then G decode steps == T+G teacher-forced decode steps
    (MoE at ample capacity: dropping is the one legitimate divergence)."""
    cfg, api, params = _model(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        api = get_api(cfg)
    B, T, G = 2, 8, 4
    toks = _tokens(cfg, B, T + G)
    cache = api.init_cache(params, {"tokens": toks}, T + G)
    ref = []
    for t in range(T + G):
        lg, cache = api.decode_step(params, cache, toks[:, t:t + 1])
        ref.append(lg[:, 0])
    logits0, cache2 = api.prefill(params, {"tokens": toks[:, :T]}, T + G)
    assert cache2["cur_len"] == T
    np.testing.assert_allclose(logits0.numpy(), ref[T - 1].numpy(),
                               rtol=3e-3, atol=3e-3)
    for t in range(T, T + G):
        lg, cache2 = api.decode_step(params, cache2, toks[:, t:t + 1])
        np.testing.assert_allclose(lg[:, 0].numpy(), ref[t].numpy(),
                                   rtol=3e-3, atol=3e-3)


def test_decode_past_the_cache_raises():
    cfg, api, params = _model("granite_8b")
    toks = _tokens(cfg, 2, 4)
    _, cache = api.prefill(params, {"tokens": toks}, 4)
    with pytest.raises(ValueError, match="cache holds 4"):
        api.decode_step(params, cache, toks[:, :1])
    with pytest.raises(ValueError, match="past max_len"):
        api.prefill(params, {"tokens": toks}, 3)


def test_ssd_prompt_past_a_chunk_must_be_a_multiple_of_it():
    """The reference asserts t % min(128, t) == 0 in ``ssd_train``."""
    cfg, api, params = _model("mamba2_2p7b")
    assert api.forward(params, {"tokens": _tokens(cfg, 1, 256)}).shape == (
        1, 256, cfg.vocab)
    with pytest.raises(ValueError, match="SSD chunk"):
        api.forward(params, {"tokens": _tokens(cfg, 1, 130)})


# ---------------------------------------------------------------------------
# model properties (tests/test_model_properties.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_2p7b",
                                  "hymba_1p5b"])
def test_causality(arch):
    """Changing token t+1.. must not change logits at positions <= t."""
    cfg, api, params = _model(arch)
    B, T, t_cut = 2, 12, 5
    toks = _tokens(cfg, B, T)
    toks2 = toks.clone()
    toks2[:, t_cut + 1:] = (toks[:, t_cut + 1:] + 7) % cfg.vocab
    l1 = api.forward(params, {"tokens": toks})
    l2 = api.forward(params, {"tokens": toks2})
    np.testing.assert_allclose(l1[:, :t_cut + 1].numpy(),
                               l2[:, :t_cut + 1].numpy(), rtol=2e-3,
                               atol=2e-3)
    assert float((l1[:, t_cut + 1:] - l2[:, t_cut + 1:]).abs().max()) > 1e-4


def test_batch_independence():
    """Row b's logits don't depend on other rows."""
    cfg, api, params = _model("granite_8b")
    toks = _tokens(cfg, 3, 10)
    full = api.forward(params, {"tokens": toks})
    solo = api.forward(params, {"tokens": toks[1:2]})
    np.testing.assert_allclose(full[1:2].numpy(), solo.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("seed,t", [(0, 4), (1, 8), (2, 16), (3, 4),
                                    (4, 8), (5, 16), (6, 8), (7, 16)])
def test_loss_finite_any_tokens(seed, t):
    """CE stays finite for arbitrary token patterns (repeats included)."""
    cfg, api, params = _model("granite_8b")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab if seed % 2 else 3,
                                         (2, t)).astype(np.int32))
    loss = api.loss_fn(params, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("seed", range(6))
def test_moe_capacity_monotone(seed):
    """A higher capacity_factor keeps more routed mass: the MoE output moves
    toward the dropless limit (cf 8) monotonically."""
    base = registry.get_smoke_config("olmoe_1b_7b")
    params = get_api(base).init(seed, device=CPU)
    toks = _tokens(base, 2, 16, seed=seed + 1)
    outs = {}
    for cf in (0.5, 1.25, 8.0):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        outs[cf] = get_api(cfg).forward(params, {"tokens": toks})
    d_low = float((outs[0.5] - outs[8.0]).abs().mean())
    d_mid = float((outs[1.25] - outs[8.0]).abs().mean())
    assert d_mid <= d_low + 1e-6


def test_moe_top_k_breaks_ties_lowest_index_first():
    """``jax.lax.top_k``'s order on ties, which decides the unit order and
    so which units a full expert drops."""
    from repro_torch.models import blocks
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = blocks._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_decode_deterministic():
    cfg, api, params = _model("hymba_1p5b")
    toks = _tokens(cfg, 2, 1)
    c1 = api.init_cache(params, {"tokens": toks}, 4)
    c2 = api.init_cache(params, {"tokens": toks}, 4)
    l1, _ = api.decode_step(params, c1, toks)
    l2, _ = api.decode_step(params, c2, toks)
    assert torch.equal(l1, l2)


# ---------------------------------------------------------------------------
# int8 weight-only quantization
# ---------------------------------------------------------------------------

def _leaves(tree, name=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{name}/{k}")
        return out
    return [(name, tree)]


@pytest.mark.parametrize("arch", ["granite_8b", "olmoe_1b_7b",
                                  "mamba2_2p7b", "whisper_tiny"])
def test_quantize_tree_equals_reference_bit_for_bit(arch):
    """q and scale of every quantized leaf == the reference's, over 2-D
    (a mamba leaf's scale runs over L), 3-D and 4-D (MoE) leaves."""
    jcfg = jreg.get_smoke_config(arch)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    params = interop.params_from_reference(
        jparams, registry.get_smoke_config(arch), device=CPU)
    got = quantization.quantize_tree(params, min_size=64)
    want = jquant.quantize_tree(jparams, min_size=64)
    want_leaves = dict(_leaves(jax.tree.map(
        lambda x: x, want, is_leaf=lambda x: isinstance(
            x, jquant.QuantizedLeaf))))
    n = 0
    for name, leaf in _leaves(got):
        ref = want_leaves[name]
        if isinstance(leaf, quantization.QuantizedLeaf):
            assert isinstance(ref, jquant.QuantizedLeaf), name
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q))
            assert leaf.scale.shape == ref.scale.shape, name
            np.testing.assert_array_equal(
                leaf.scale.numpy().view(np.int32),
                np.asarray(ref.scale).view(np.int32), err_msg=name)
            n += 1
        else:
            assert not isinstance(ref, jquant.QuantizedLeaf), name
    assert n >= 5
    port_q = interop.quantized_from_reference(
        want, registry.get_smoke_config(arch), device=CPU)
    for (name, a), (_, b) in zip(_leaves(port_q), _leaves(got)):
        if isinstance(a, quantization.QuantizedLeaf):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            assert a.dtype == b.dtype, name


def test_quantize_roundtrip_error_small():
    _, _, params = _model("granite_8b")
    qp = quantization.quantize_tree(params, min_size=64)
    err = quantization.quantization_error(params, qp)
    assert 0 < err < 0.02


def test_quantized_decode_close_to_full_precision():
    cfg, api, params = _model("granite_8b")
    qp = quantization.quantize_tree(params, min_size=64)
    toks = _tokens(cfg, 2, 1)
    full = steps.make_serve_step(cfg)
    quant = steps.make_serve_step(cfg, quantized=True)
    lf, _ = full(params, api.init_cache(params, {"tokens": toks}, 8), toks)
    lq, _ = quant(qp, api.init_cache(params, {"tokens": toks}, 8), toks)
    corr = np.corrcoef(lf.numpy().ravel(), lq.numpy().ravel())[0, 1]
    assert corr > 0.999
    # the per-layer dequantization is the whole-tree one, element for
    # element: the same logits, bit for bit
    lw, _ = full(quantization.dequantize_tree(qp),
                 api.init_cache(params, {"tokens": toks}, 8), toks)
    assert torch.equal(lq, lw)


# ---------------------------------------------------------------------------
# registry and init
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(out["dtype"]).split(".")[-1]
    return out


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_equal_reference(arch):
    for get, jget in ((registry.get_config, jreg.get_config),
                      (registry.get_smoke_config, jreg.get_smoke_config)):
        got, want = get(arch), jget(arch)
        w = dataclasses.asdict(want)
        w["dtype"] = np.dtype(w["dtype"]).name
        assert _fields(got) == w
        assert got.n_params() == want.n_params()
        assert got.active_params() == want.active_params()
        assert got.head_dim == want.head_dim
    assert registry.uses_fsdp(arch) == jreg.uses_fsdp(arch)
    assert registry.ARCH_IDS == jreg.ARCH_IDS


def _shapes(tree) -> dict:
    return {name: (tuple(x.shape), np.dtype(x.dtype).name
                   if not isinstance(x, torch.Tensor)
                   else str(x.dtype).split(".")[-1])
            for name, x in _leaves(tree)}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_and_cache_shapes_equal_reference(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    cells = 0
    for cell, jcell in zip(registry.SHAPES, jreg.SHAPES):
        assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
        ok, why = registry.cell_applicable(cfg, cell)
        assert (ok, why) == jreg.cell_applicable(jcfg, jcell)
        if not ok:
            continue
        cells += 1
        got = registry.input_specs(cfg, cell)
        assert all(x.device.type == "meta" for x in got.values())
        assert _shapes(got) == _shapes(jreg.input_specs(jcfg, jcell))
        assert _shapes(registry.input_specs(cfg, cell, tau=3)) == _shapes(
            jreg.input_specs(jcfg, jcell, tau=3))
        if cell.kind == "decode":
            assert _shapes(registry.cache_shapes(cfg, cell)) == _shapes(
                jreg.cache_shapes(jcfg, jcell))
    assert cells >= 3


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_init_leaves_equal_reference_at_full_size(arch):
    """Leaf names, stacked shapes and dtypes of the published configs
    (the port on the meta device, the reference through eval_shape)."""
    got = get_api(registry.get_config(arch)).init(device="meta")
    jcfg = jreg.get_config(arch)
    want = jax.eval_shape(lambda: jget_api(jcfg).init(
        jax.random.PRNGKey(0)))
    assert _shapes(got) == _shapes(want)
    n = sum(x.numel() for _, x in _leaves(got))
    # the analytic count charges whisper's GELU MLPs three matrices where
    # they hold two, and leaves out enc_norm: 41,157,888 for 36,439,680
    assert n == (36_439_680 if arch == "whisper_tiny" else jcfg.n_params())


# The truncated normal at +-2 sigma has std 0.8796 sigma.  Both packages'
# sample stds must sit within 6 standard errors (~ 1 / sqrt(2 n) relative
# over n draws) of that, every draw within 2 sigma, and some past 1.5
# sigma (a 9.2% tail: at the smallest leaf, 256 draws, all missing it has
# odds under 1e-10).
TRUNC_STD = 0.87962566


def _sigma(name: str, shape) -> float:
    """The reference's scale: 1.0 for embeddings, 0.5 for the convs,
    else fan_in^-1/2."""
    if name.endswith("/embed"):
        return 1.0
    if name.endswith(("/conv_x", "/conv_bc")):
        return 0.5
    return float(shape[-2]) ** -0.5


@pytest.mark.parametrize("arch", ["granite_8b", "olmoe_1b_7b",
                                  "mamba2_2p7b", "whisper_tiny"])
def test_init_draws_the_reference_distribution(arch):
    cfg = registry.get_smoke_config(arch)
    got = get_api(cfg).init(11, device=CPU)
    want = jget_api(jreg.get_smoke_config(arch)).init(jax.random.PRNGKey(0))
    assert _shapes(got) == _shapes(want)
    want = dict(_leaves(want))
    checked = 0
    for name, x in _leaves(got):
        ref = np.asarray(want[name], np.float32)
        x = x.float().numpy()
        if np.all(ref == ref.flat[0]):           # norms, A_log, D, dt_bias
            np.testing.assert_array_equal(x, ref, err_msg=name)
            continue
        sigma = _sigma(name, x.shape)
        tol = 6.0 / np.sqrt(2.0 * x.size)
        for draws in (x, ref):
            assert abs(np.std(draws) / (TRUNC_STD * sigma) - 1) < tol, name
            assert np.max(np.abs(draws)) <= 2 * sigma * (1 + 1e-6), name
            assert np.max(np.abs(draws)) > 1.5 * sigma, name
        checked += 1
    assert checked >= 5
    # the same seed draws the same params; another seed others
    again = get_api(cfg).init(11, device=CPU)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(again), _leaves(get_api(cfg).init(
                   11, device=CPU))))
    assert not torch.equal(get_api(cfg).init(12, device=CPU)["embed"],
                           again["embed"])


def test_params_from_reference_checks_against_the_config():
    jparams = jget_api(jreg.get_smoke_config("granite_8b")).init(
        jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="does not match"):
        interop.params_from_reference(
            jparams, registry.get_smoke_config("granite_34b"), device=CPU)
    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    cfg = dataclasses.replace(registry.get_smoke_config("granite_8b"),
                              dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        interop.params_from_reference(bf, cfg, device=CPU)   # f32 norms
    bf["blocks"]["attn_norm"] = jparams["blocks"]["attn_norm"]
    bf["blocks"]["mlp_norm"] = jparams["blocks"]["mlp_norm"]
    bf["final_norm"] = jparams["final_norm"]
    got = interop.params_from_reference(bf, cfg, device=CPU)
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["embed"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(bf["embed"]).view(np.uint16))
