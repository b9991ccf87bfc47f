"""The port's optimizers, schedules, clipping, top-k error feedback and
step-indexed data pipeline held against the reference on the CPU.

The same numpy params and grads (a tree with a plain, a stacked and a
vector leaf) go through ``repro.optim`` and ``repro_torch.optim``:
``adamw`` and ``sgd`` (with and without momentum) over 3 updates under a
cosine schedule agree at ``rtol=1e-6`` in f32 (moments too) and within one
bf16 ulp for bf16 params; ``cosine_schedule`` and ``rm_schedule`` over
counts 0-200, ``global_norm`` and ``clip_by_global_norm`` at
``rtol=1e-6``.  ``topk_threshold_mask`` and ``topk_compress`` equal the
reference's bit for bit.  Then the contracts of
``tests/test_substrates.py`` on the port's own: AdamW and SGD with
momentum converge on a quadratic, the schedules' shape, the clip, the
error feedback's mass conservation, top-k keeping the largest, and
``lm_batch`` deterministic, shifted, in range, with the reference's share
of Markov kicks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import sparse as jsparse
from repro.data import pipeline as jpipeline
from repro.optim import compression as jcompression
from repro.optim import optimizers as joptim
from repro_torch.comm import sparse
from repro_torch.data import pipeline
from repro_torch.optim import compression, optimizers
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(1)

SHAPES = {"a": (4, 8), "b": {"stack": (3, 5, 7), "vec": (6,)}}
RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _within_bf16_ulp(got, want, what):
    got, want = _np(got), _np(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{what}: {int(bad.sum())} entries past one ulp"


def _pair(name: str):
    sched = dict(warmup=2, total=6)
    if name == "adamw":
        return (joptim.adamw(joptim.cosine_schedule(0.01, **sched)),
                optimizers.adamw(optimizers.cosine_schedule(0.01, **sched)))
    mom = 0.9 if name == "sgd_momentum" else 0.0
    return (joptim.sgd(joptim.cosine_schedule(0.05, **sched), momentum=mom),
            optimizers.sgd(optimizers.cosine_schedule(0.05, **sched),
                           momentum=mom))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_optimizer_updates_equal_reference(name, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    jopt, topt = _pair(name)
    jp, tp = _jax(params, jdt), _torch(params, tdt)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = _tree(rng, SHAPES, scale=0.1)
        jp, js = jax.jit(jopt.update)(_jax(grads, jdt), js, jp)
        tp, ts = topt.update(_torch(grads, tdt), ts, tp)
    for i, (g, w) in enumerate(zip(tree_leaves(tp), jax.tree.leaves(jp))):
        assert g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"param {i}")
        else:
            _within_bf16_ulp(g, w, f"param {i}")
    tstate, jstate = tree_leaves(ts), jax.tree.leaves(js)
    assert len(tstate) == len(jstate)
    for i, (g, w) in enumerate(zip(tstate, jstate)):
        if g.is_floating_point():
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"state {i}")
        else:
            assert g.dtype == torch.int32 and int(g) == int(w) == 3


@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_donated_and_blocked_updates_equal_the_functional_bitwise(
        name, monkeypatch):
    """``donate=True`` writes the same bits into the given tensors; a leaf
    updated in blocks of rows (``CHUNK`` cut to 7 entries) or layer by
    layer gives the whole leaf's bits."""
    rng = np.random.default_rng(5)
    params = _tree(rng, SHAPES)
    _, topt = _pair(name)
    p1 = _torch(params, torch.bfloat16)
    p2 = _torch(params, torch.bfloat16)
    s1, s2 = topt.init(p1), topt.init(p2)
    for _ in range(3):
        grads = _torch(_tree(rng, SHAPES, scale=0.1), torch.bfloat16)
        p1, s1 = topt.update(grads, s1, p1)
        with monkeypatch.context() as m:
            m.setattr(optimizers, "CHUNK", 7)
            held = tree_leaves(p2) + tree_leaves(s2)
            p2, s2 = topt.update(grads, s2, p2, donate=True)
        assert all(a is b for a, b in zip(
            tree_leaves(p2) + tree_leaves(s2)[:-1], held[:-1]))
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1),
                    tree_leaves(p2) + tree_leaves(s2)):
        assert torch.equal(a, b)


def test_schedules_equal_reference():
    counts = np.arange(0, 201, dtype=np.int32)
    jc, tc = jnp.asarray(counts), torch.from_numpy(counts)
    pairs = [(joptim.cosine_schedule(3e-4, warmup=20, total=150),
              optimizers.cosine_schedule(3e-4, warmup=20, total=150)),
             (joptim.cosine_schedule(1.0, warmup=10, total=100, floor=0.2),
              optimizers.cosine_schedule(1.0, warmup=10, total=100,
                                         floor=0.2)),
             (joptim.rm_schedule(0.5, 1.0), optimizers.rm_schedule(0.5, 1.0)),
             (joptim.rm_schedule(0.3, 0.07),
              optimizers.rm_schedule(0.3, 0.07))]
    for jf, tf in pairs:
        got, want = tf(tc), jax.jit(jf)(jc)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=0)


def test_global_norm_and_clip_equal_reference():
    rng = np.random.default_rng(1)
    grads = _tree(rng, SHAPES, scale=3.0)
    for max_norm in (1.0, 1e3):
        jg, jn = joptim.clip_by_global_norm(_jax(grads, jnp.float32),
                                            max_norm)
        tg, tn = optimizers.clip_by_global_norm(
            _torch(grads, torch.float32), max_norm)
        np.testing.assert_allclose(_np(tn), _np(jn), rtol=RTOL)
        np.testing.assert_allclose(
            _np(optimizers.global_norm(_torch(grads, torch.float32))),
            _np(joptim.global_norm(_jax(grads, jnp.float32))), rtol=RTOL)
        for g, w in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)
    # bf16 grads: the scale is cast to bf16 before the product
    jg, _ = joptim.clip_by_global_norm(_jax(grads, jnp.bfloat16), 1.0)
    tg, _ = optimizers.clip_by_global_norm(_torch(grads, torch.bfloat16),
                                           1.0)
    for g, w in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert g.dtype == torch.bfloat16
        _within_bf16_ulp(g, w, "bf16 clip")


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.37, 1.0])
def test_topk_mask_and_compress_equal_reference_bitwise(frac):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    x[:4] = 0.5                                  # a tie run
    x[4, :8] = -0.5
    np.testing.assert_array_equal(
        sparse.topk_threshold_mask(torch.from_numpy(x), frac).numpy(),
        np.asarray(jsparse.topk_threshold_mask(jnp.asarray(x), frac)))
    delta = {"w": x, "v": {"u": rng.standard_normal(50).astype(np.float32)}}
    res = _tree(rng, {"w": (64, 32), "v": {"u": (50,)}}, scale=0.1)
    jef = jcompression.ErrorFeedbackState(residual=_jax(res, jnp.float32))
    tef = compression.ErrorFeedbackState(residual=_torch(res, torch.float32))
    jc, jef2, jfrac = jcompression.topk_compress(
        _jax(delta, jnp.float32), jef, frac=frac)
    tc, tef2, tfrac = compression.topk_compress(
        _torch(delta, torch.float32), tef, frac=frac)
    for got, want in ((tc, jc), (tef2.residual, jef2.residual)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(_np(g), _np(w))
    assert float(tfrac) == float(jfrac)


# ---------------------------------------------------------------------------
# the contracts of tests/test_substrates.py, on the port's own
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    opt = optimizers.adamw(0.1, weight_decay=0.0)
    params = {"w": torch.tensor(5.0)}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert abs(float(params["w"])) < 1e-2


def test_sgd_momentum_converges():
    opt = optimizers.sgd(0.05, momentum=0.9)
    params = {"w": torch.tensor(4.0)}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert abs(float(params["w"])) < 2e-2


def test_cosine_and_rm_schedule_shape():
    fn = optimizers.cosine_schedule(1.0, warmup=10, total=100, floor=0.1)
    assert float(fn(torch.tensor(0))) == 0.0
    assert float(fn(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(fn(torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)
    rm = optimizers.rm_schedule(0.5, 1.0)
    assert float(rm(torch.tensor(0))) == 0.5
    assert float(rm(torch.tensor(4))) == pytest.approx(0.1)


def test_clip_by_global_norm():
    clipped, norm = optimizers.clip_by_global_norm(
        {"a": torch.full((3,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(300), rel=1e-5)
    assert float(optimizers.global_norm(clipped)) == pytest.approx(
        1.0, rel=1e-4)


def test_topk_error_feedback_conserves_mass():
    delta = {"w": torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 32)).astype(np.float32))}
    comp, ef2, _ = compression.topk_compress(
        delta, compression.init_error_feedback(delta), frac=0.1)
    np.testing.assert_allclose((comp["w"] + ef2.residual["w"]).numpy(),
                               delta["w"].numpy(), atol=1e-5)
    assert float((comp["w"] != 0).float().mean()) <= 0.15


@pytest.mark.parametrize("seed", range(10))
def test_topk_keeps_largest(seed):
    rng = np.random.default_rng(seed)
    frac = float(rng.uniform(0.01, 0.5))
    x = {"w": torch.from_numpy(rng.standard_normal(128).astype(np.float32))}
    comp, _, _ = compression.topk_compress(
        x, compression.init_error_feedback(x), frac=frac)
    kept = comp["w"].abs().numpy()
    dropped = x["w"].abs().numpy()[kept == 0]
    if kept.max() > 0 and dropped.size:
        assert dropped.max() <= kept[kept > 0].min() + 1e-6


def _markov_share(tokens: np.ndarray, vocab: int) -> float:
    """Share of positions whose token is the previous one's plus 1."""
    return float(np.mean(tokens[:, 1:] == (tokens[:, :-1] + 1) % vocab))


def test_lm_batch_deterministic_shifted_in_range():
    cfg = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=4, seed=9)
    b1 = pipeline.lm_batch(cfg, 3, device="cpu")
    b2 = pipeline.lm_batch(cfg, 3, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"],
                           pipeline.lm_batch(cfg, 4, device="cpu")["tokens"])
    assert b1["tokens"].dtype == torch.int32
    assert tuple(b1["tokens"].shape) == tuple(b1["labels"].shape) == (4, 16)
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 128
    other = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=4,
                                seed=10)
    assert not torch.equal(b1["tokens"], pipeline.lm_batch(
        other, 3, device="cpu")["tokens"])


def test_lm_batch_markov_share_equals_reference():
    """The kick's share, over 64 x 256 tokens, within 0.02 of the
    reference's (the draws differ, the process does not)."""
    cfg = dict(vocab=512, seq_len=255, global_batch=64, seed=0)
    got = pipeline.lm_batch(pipeline.DataConfig(**cfg), 0, device="cpu")
    want = jpipeline.lm_batch(jpipeline.DataConfig(**cfg), 0)
    tok_t, tok_j = got["tokens"].numpy(), np.asarray(want["tokens"])
    share_t, share_j = _markov_share(tok_t, 512), _markov_share(tok_j, 512)
    assert 0.2 < share_t < 0.5
    assert abs(share_t - share_j) < 0.02
    # the Zipf head: the commonest tokens' shares, the reference's
    freq_t, freq_j = (np.bincount(t.ravel(), minlength=512)[:4] / t.size
                      for t in (tok_t, tok_j))
    np.testing.assert_allclose(freq_t, freq_j, atol=0.01)


def test_vq_batch_deterministic_mixture():
    cfg = pipeline.DataConfig(vocab=0, seq_len=0, global_batch=256, seed=3)
    a = pipeline.vq_batch(cfg, 5, d=4, device="cpu")
    assert torch.equal(a, pipeline.vq_batch(cfg, 5, d=4, device="cpu"))
    assert tuple(a.shape) == (256, 4) and a.dtype == torch.float32
    assert 0.0 - 0.3 < float(a.min()) and float(a.max()) < 1.0 + 0.3
