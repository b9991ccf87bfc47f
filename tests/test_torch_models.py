"""The port's LM serving path held against ``repro.models`` on the CPU.

For each of the ten ``smoke_config()``s, the reference's ``init`` makes the
params, ``interop.params_from_reference`` carries them across, and numpy
inputs from a seed go through both packages: ``forward`` logits,
``loss_fn``, ``prefill`` (the last logits and every cache leaf) and 4
greedy ``decode_step``s must agree at ``rtol=1e-4, atol=1e-5`` in f32 with
equal greedy tokens.  Also: hymba at 4 layers with window 8, a 16-token
prompt and 8 decode steps (the windowed path, which the 3-layer smoke never
reaches: at L <= 3 every layer is global), and granite-8b's smoke config in
bf16 against the reference in bf16.  One jitted reference per arch per
module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import get_api as jget_api
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.models.api import get_api
from repro_torch.models.common import ModelConfig

torch.set_num_threads(1)

B, T, MAX_LEN, GEN = 2, 8, 16, 4
RTOL, ATOL = 1e-4, 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _batch(cfg, seed: int, t: int = T, b: int = B) -> dict:
    """numpy inputs: tokens, next-token labels (the last one -1, masked),
    and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    batch = {"tokens": toks[:, :t], "labels": labels}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch: dict, dtype=jnp.float32) -> dict:
    return {k: (jnp.asarray(v) if v.dtype.kind == "i"
                else jnp.asarray(v, dtype)) for k, v in batch.items()}


def _torch(batch: dict, dtype=torch.float32) -> dict:
    return {k: (torch.from_numpy(v) if v.dtype.kind == "i"
                else torch.from_numpy(v).to(dtype)) for k, v in batch.items()}


class Pair:
    """One config in both packages: the reference's params, their port
    copy, and jitted reference entry points."""

    def __init__(self, jcfg, tcfg: ModelConfig, seed: int = 0):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.japi, self.tapi = jget_api(jcfg), get_api(tcfg)
        self.jparams = self.japi.init(jax.random.PRNGKey(seed))
        self.tparams = interop.params_from_reference(self.jparams, tcfg,
                                                     device="cpu")
        self.forward = jax.jit(self.japi.forward)
        self.loss = jax.jit(self.japi.loss_fn)
        self.decode = jax.jit(self.japi.decode_step)
        self._prefill = {}

    def prefill(self, max_len: int):
        if max_len not in self._prefill:
            self._prefill[max_len] = jax.jit(functools.partial(
                self.japi.prefill, max_len=max_len))
        return self._prefill[max_len]


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch: str) -> Pair:
        if arch not in cache:
            cache[arch] = Pair(jreg.get_smoke_config(arch),
                               registry.get_smoke_config(arch))
        return cache[arch]

    return get


def _close(got, want, what: str, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_forward_logits_equal_reference(pairs, arch):
    pr = pairs(arch)
    batch = _batch(pr.tcfg, 1)
    want = pr.forward(pr.jparams, _jax(batch))
    got = pr.tapi.forward(pr.tparams, _torch(batch))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, f"{arch} forward")


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_loss_equals_reference(pairs, arch):
    pr = pairs(arch)
    batch = _batch(pr.tcfg, 2)
    want = float(pr.loss(pr.jparams, _jax(batch)))
    got = float(pr.tapi.loss_fn(pr.tparams, _torch(batch)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _prompt(cfg, seed):
    batch = _batch(cfg, seed)
    batch.pop("labels")
    return batch


def _cache_close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    assert got["cur_len"] == int(want["cur_len"])
    for name in sorted(set(got) - {"cur_len"}):
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).split(".")[-1] == \
            str(want[name].dtype), name
        _close(got[name], want[name], f"{what} cache[{name!r}]")


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_prefill_logits_and_cache_equal_reference(pairs, arch):
    pr = pairs(arch)
    batch = _prompt(pr.tcfg, 3)
    max_len = MAX_LEN + (pr.tcfg.img_tokens if pr.tcfg.family == "vlm"
                         else 0)
    want_l, want_c = pr.prefill(max_len)(pr.jparams, _jax(batch))
    got_l, got_c = pr.tapi.prefill(pr.tparams, _torch(batch), max_len)
    _close(got_l, want_l, f"{arch} prefill logits")
    _cache_close(got_c, want_c, f"{arch} prefill")


def _greedy(logits) -> np.ndarray:
    return np.argmax(_np(logits).reshape(B, -1), axis=-1)[:, None].astype(
        np.int32)


def _decode_both(pr: Pair, batch: dict, max_len: int, steps: int,
                 rtol=RTOL, atol=ATOL) -> None:
    """Prefill, then ``steps`` greedy decode steps in both packages: logits
    close and every greedy token equal; the final caches close."""
    want_l, want_c = pr.prefill(max_len)(pr.jparams, _jax(batch))
    got_l, got_c = pr.tapi.prefill(pr.tparams, _torch(batch), max_len)
    for s in range(steps):
        tok = _greedy(want_l)
        np.testing.assert_array_equal(_greedy(got_l), tok,
                                      err_msg=f"greedy token {s}")
        want_l, want_c = pr.decode(pr.jparams, want_c, jnp.asarray(tok))
        got_l, got_c = pr.tapi.decode_step(pr.tparams, got_c,
                                           torch.from_numpy(tok))
        assert tuple(got_l.shape) == tuple(want_l.shape)
        _close(got_l, want_l, f"decode step {s}", rtol, atol)
    np.testing.assert_array_equal(_greedy(got_l), _greedy(want_l))
    _cache_close(got_c, want_c, "after decode")


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_greedy_decode_equals_reference(pairs, arch):
    pr = pairs(arch)
    max_len = MAX_LEN + (pr.tcfg.img_tokens if pr.tcfg.family == "vlm"
                         else 0)
    _decode_both(pr, _prompt(pr.tcfg, 4), max_len, GEN)


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_2p7b",
                                  "hymba_1p5b", "whisper_tiny"])
def test_decode_continues_from_the_reference_cache(pairs, arch):
    """``interop.cache_from_reference`` carries a reference cache across
    (K/V, conv tails, SSM state, whisper's cross K/V; ``cur_len`` a host
    int): the port's decode steps from it equal the reference's."""
    pr = pairs(arch)
    batch = _prompt(pr.tcfg, 8)
    want_l, want_c = pr.prefill(MAX_LEN)(pr.jparams, _jax(batch))
    got_c = interop.cache_from_reference(want_c, device="cpu")
    assert isinstance(got_c["cur_len"], int)
    _cache_close(got_c, want_c, "carried")
    for s in range(2):
        tok = _greedy(want_l)
        want_l, want_c = pr.decode(pr.jparams, want_c, jnp.asarray(tok))
        got_l, got_c = pr.tapi.decode_step(pr.tparams, got_c,
                                           torch.from_numpy(tok))
        _close(got_l, want_l, f"decode step {s} from the carried cache")


def test_hymba_windowed_layers_cross_their_window():
    """hymba at L = 4 (windows 0, 8, 0, 0: layer 1 slides) with window 8,
    a 16-token prompt and 8 decode steps: the prompt and the decode both
    reach past the window."""
    jcfg = dataclasses.replace(jreg.get_smoke_config("hymba_1p5b"),
                               n_layers=4, window=8)
    tcfg = dataclasses.replace(registry.get_smoke_config("hymba_1p5b"),
                               n_layers=4, window=8)
    from repro_torch.models import transformer
    assert transformer._layer_windows(tcfg) == [0, 8, 0, 0]
    pr = Pair(jcfg, tcfg, seed=7)
    batch = _batch(tcfg, 5, t=16)
    want = pr.forward(pr.jparams, _jax(batch))
    got = pr.tapi.forward(pr.tparams, _torch(batch))
    _close(got, want, "hymba L=4 forward")
    batch.pop("labels")
    _decode_both(pr, batch, 24, 8)


# bf16 end to end: both packages round every product and activation to
# bf16, in different orders (XLA's fused dots, torch's eager ones); over 2
# layers that moved the logits by at most 0.0244 on |logits| <= 3.47
# (measured at init seeds 3, 4, 5 and 11; bf16's spacing at 2-4 is
# 0.0156): the bound is 2.56x that
BF16_ATOL = 0.0625


def test_dense_bf16_equals_reference_bf16():
    jcfg = dataclasses.replace(jreg.get_smoke_config("granite_8b"),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(registry.get_smoke_config("granite_8b"),
                               dtype=torch.bfloat16)
    pr = Pair(jcfg, tcfg, seed=3)
    assert pr.tparams["blocks"]["wq"].dtype == torch.bfloat16
    batch = _batch(tcfg, 6)
    want = pr.forward(pr.jparams, _jax(batch, jnp.bfloat16))
    got = pr.tapi.forward(pr.tparams, _torch(batch, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    gap = float(np.max(np.abs(_np(got) - _np(want))))
    assert gap <= BF16_ATOL, gap
    # the argmax agrees wherever the reference's top two are apart by
    # more than the bound
    w = _np(want)
    top2 = np.sort(w, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * BF16_ATOL
    np.testing.assert_array_equal(np.argmax(_np(got), -1)[clear],
                                  np.argmax(w, -1)[clear])
