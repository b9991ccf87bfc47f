"""The port's tile tuner, and every delta route on ragged shapes.

Mirrors ``tests/test_autotune.py``:

  * every route of ``ops.vq_delta_routed`` (full kernel, blocked with the
    tuner's tiles, blocked with forced tiles, the ``fused=False``
    comparator) on shapes that divide no tile, against the reference's
    oracle and its own routes: assignments and counts exact, zsum at
    ``rtol=1e-4, atol=1e-6``;
  * ``ops.vq_delta_topk`` with ``budget_bytes`` None and tiny;
  * the tuner is deterministic: one shape, one pick; a hit never searches
    again; the JSON file round-trips; keys name the device;
  * no module outside ``src/repro_torch/kernels/`` passes literal tiles.

On the CPU the kernels' plain versions have no tiles, so the picks come
from the tuner's model (``search`` times only on a card).
"""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.sparse import topk_count
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import autotune, ops, vq_assign, vq_fused

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")

# batch not a multiple of the argmin pass's 8 rows, kappa of no chunk or
# tile, kappa below the tiles, batch < 8
RAGGED = [(100, 200, 16), (64, 300, 8), (7, 33, 5), (3, 4, 2), (130, 17, 3)]


@pytest.fixture(autouse=True)
def _fresh_tuner():
    """Each test sees a clean in-memory tuner and leaves one behind."""
    autotune.set_cache_path(None)
    autotune.reset("cache")
    yield
    autotune.set_cache_path(None)
    autotune.reset("cache")


def _case(batch, kappa, d):
    rng = np.random.default_rng(batch * kappa + d)
    z = rng.standard_normal((batch, d)).astype(np.float32)
    w = rng.standard_normal((kappa, d)).astype(np.float32)
    return z, w


@pytest.mark.parametrize("batch,kappa,d", RAGGED)
def test_all_delta_routes_match_ref_on_ragged_shapes(batch, kappa, d):
    z, w = _case(batch, kappa, d)
    zt, wt = torch.from_numpy(z), torch.from_numpy(w)
    cr, sr = jref.vq_delta_ref(jnp.asarray(z), jnp.asarray(w))
    jc, js = jops.vq_delta_routed(jnp.asarray(z), jnp.asarray(w),
                                  budget_bytes=1024)
    ar, _ = jref.vq_assign_ref(jnp.asarray(z), jnp.asarray(w))
    routes = {
        "full": lambda: ops.vq_delta_routed(zt, wt),
        "blocked_tuned": lambda: ops.vq_delta_routed(zt, wt, budget_bytes=64),
        "blocked_forced": lambda: ops.vq_delta_blocked(zt, wt, kchunk=16,
                                                       bk=128),
        "unfused": lambda: ops.vq_delta_routed(zt, wt, budget_bytes=64,
                                               fused=False),
    }
    for name, run in routes.items():
        c, s = run()
        np.testing.assert_array_equal(c.numpy(), np.asarray(cr),
                                      err_msg=name)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc),
                                      err_msg=name)
        for want in (sr, js):
            np.testing.assert_allclose(s.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
    _, _, _, assign = vq_fused.vq_delta_blocked(zt, wt)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ar))


@pytest.mark.parametrize("budget", [None, 64])
def test_vq_delta_topk_matches_sparse_transport_semantics(budget):
    """Both branches (the delta kernel's eager payload, the blocked
    kernel's epilogue) against the reference's ``vq_delta_topk`` at the
    same budget role and the per-leaf compress written out."""
    batch, kappa, d, frac = 40, 24, 6, 0.1
    z, w = _case(batch, kappa, d)
    residual = np.random.default_rng(5).standard_normal(
        (kappa, d)).astype(np.float32)
    vals, idx, new_res = ops.vq_delta_topk(
        torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(residual),
        frac=frac, budget_bytes=budget)
    cr, sr = jref.vq_delta_ref(jnp.asarray(z), jnp.asarray(w))
    full = (np.asarray(cr)[:, None] * w - np.asarray(sr) + residual)
    flat = full.reshape(-1)
    k = topk_count(kappa * d, frac)
    assert vals.shape == (k,) and idx.shape == (k,)
    order = np.argsort(-np.abs(flat), kind="stable")[:k]
    np.testing.assert_array_equal(idx.numpy(), np.sort(order))
    np.testing.assert_allclose(vals.numpy(), flat[idx.numpy()], rtol=RTOL,
                               atol=ATOL)
    kept = np.zeros_like(flat)
    kept[idx.numpy()] = flat[idx.numpy()]
    np.testing.assert_allclose(new_res.numpy().reshape(-1), flat - kept,
                               rtol=RTOL, atol=ATOL)
    rv, ri, rr = jops.vq_delta_topk(jnp.asarray(z), jnp.asarray(w),
                                    jnp.asarray(residual), frac=frac,
                                    budget_bytes=None if budget is None
                                    else 1024)
    order = np.argsort(np.asarray(ri))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri)[order])
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv)[order],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new_res.numpy(), np.asarray(rr), rtol=RTOL,
                               atol=ATOL)


def test_delta_topk_branches_agree_bitwise():
    """On the CPU the blocked branch's epilogue and the full branch's eager
    payload are the same expression: equal bit for bit."""
    rng = np.random.default_rng(9)
    z, w, r = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 30, 8), (3, 20, 8), (3, 20, 8)))
    full = ops.vq_delta_topk(z, w, r, frac=0.2)
    blocked = ops.vq_delta_topk(z, w, r, frac=0.2, budget_bytes=64)
    for a, b in zip(full, blocked):
        assert torch.equal(a, b)


# -- tuner determinism ------------------------------------------------------

def test_same_shape_same_config_and_cache_hit_never_researches():
    c1 = autotune.pick_tiles(100, 200, 16, device=CPU, kind="delta_blocked")
    assert autotune.search_count() == 1
    c2 = autotune.pick_tiles(100, 200, 16, device=CPU, kind="delta_blocked")
    assert c1 == c2
    assert autotune.search_count() == 1          # hit: no new search
    # the pick fits under the SAME model the router uses
    assert (ops.delta_smem_bytes(200, 16, bk=c1.bk)
            <= ops.smem_budget_bytes(None))
    c3 = autotune.pick_tiles(64, 300, 8, device=CPU, kind="delta_blocked")
    assert autotune.search_count() == 2
    assert c3 in autotune._candidates(64, 300, 8, kind="delta_blocked",
                                      budget_bytes=ops.smem_budget_bytes())
    keys = {autotune.tune_key(k, 100, 200, 16, m=m, device=CPU)
            for k in autotune.KINDS for m in (1, 8)}
    assert len(keys) == 2 * len(autotune.KINDS)


def test_off_mode_returns_legacy_tiles_without_caching():
    autotune.reset("off")
    cfg = autotune.pick_tiles(100, 200, 16, device=CPU, kind="delta_blocked")
    assert (cfg.kchunk, cfg.bk) == (vq_assign.KCHUNK, vq_assign.OWN_ROWS)
    assert cfg == autotune.legacy_tiles()
    assert autotune.search_count() == 0


def test_json_cache_round_trips(tmp_path):
    path = tmp_path / "tiles.json"
    autotune.set_cache_path(str(path))
    autotune.reset("cache")
    c1 = autotune.pick_tiles(100, 200, 16, m=8, device=CPU, kind="delta")
    assert autotune.search_count() == 1
    raw = json.loads(path.read_text())
    assert raw == {"delta|m8|b100|k200|d16|e4|cpu:cpu": [c1.kchunk, c1.bk]}
    # a fresh process (reset) reloads the file: a hit, no search
    autotune.reset("cache")
    c2 = autotune.pick_tiles(100, 200, 16, m=8, device=CPU, kind="delta")
    assert c1 == c2
    assert autotune.search_count() == 0


def test_env_cache_path_and_bad_entries(tmp_path, monkeypatch):
    path = tmp_path / "env_tiles.json"
    key = autotune.tune_key("assign", 5, 9, 3, device=CPU)
    path.write_text(json.dumps({key: [7, 3], "junk": "x",
                                "bad|zero": [0, 4]}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    autotune.reset("cache")
    assert autotune.pick_tiles(5, 9, 3, device=CPU, kind="assign") == \
        autotune.TileConfig(kchunk=7, bk=3)
    assert autotune.search_count() == 0


def test_search_mode_on_cpu_takes_the_model_pick_and_caches_it():
    model = autotune.pick_tiles(1, 4096, 3072, m=8, device=CPU,
                                kind="delta_blocked")
    autotune.reset("search")
    cfg = autotune.pick_tiles(1, 4096, 3072, m=8, device=CPU,
                              kind="delta_blocked")
    assert cfg == model and autotune.search_count() == 1
    assert autotune.pick_tiles(1, 4096, 3072, m=8, device=CPU,
                               kind="delta_blocked") == cfg
    assert autotune.search_count() == 1          # resolved once, cached


def test_tune_key_is_device_scoped(monkeypatch):
    assert autotune.device_kind("cpu") == "cpu:cpu"
    assert "cpu:cpu" in autotune.tune_key("delta", 8, 16, 4, device=CPU)
    monkeypatch.setattr(autotune, "_cuda_name", lambda i: f"Card{i}")
    k0 = autotune.tune_key("delta", 8, 16, 4, device="cuda:0")
    k1 = autotune.tune_key("delta", 8, 16, 4, device="cuda:1")
    assert k0.endswith("|cuda:Card0") and k1.endswith("|cuda:Card1")
    assert len({k0, k1, autotune.tune_key("delta", 8, 16, 4,
                                          device=CPU)}) == 3
    with pytest.raises(ValueError):
        autotune.device_kind("meta")


def test_modes_and_kinds_are_validated():
    with pytest.raises(ValueError):
        autotune.set_mode("fast")
    with pytest.raises(ValueError):
        autotune.pick_tiles(1, 8, 4, device=CPU, kind="window")


def test_model_counts_blocks_against_the_card():
    """At the eq.-9 tick (batch 1, M=8) one kappa chunk per worker leaves
    124 of 132 SMs idle: the model ranks it far behind the pick, and a tile
    whose shared memory fits no SM is never picked."""
    shape = dict(batch=1, kappa=4096, d=3072, m=8, kind="delta_blocked")
    pick = autotune.pick_tiles(shape["batch"], shape["kappa"], shape["d"],
                               m=8, device=CPU, kind="delta_blocked")
    one_chunk = autotune.TileConfig(kchunk=4096, bk=pick.bk)

    def t(cfg):
        return autotune.model_time(cfg, shape["batch"], shape["kappa"],
                                   shape["d"], m=8, kind="delta_blocked")

    assert t(one_chunk) > 4 * t(pick)
    assert t(pick) <= t(autotune.legacy_tiles())
    # past 8 points the delta kernel's passes accumulate a (32, d) tile,
    # which fits no SM at d=3072 (at B <= 8 its sweep holds no tile)
    assert autotune.model_time(autotune.legacy_tiles(), 9, 4096, 3072, m=8,
                               kind="delta") == float("inf")
    # a budget no tile fits: the smallest bk, as the reference falls back
    # (the key holds no budget, so drop the cached pick first)
    autotune.reset("cache")
    tiny = autotune.pick_tiles(1, 4096, 3072, m=8, device=CPU,
                               kind="delta_blocked", budget_bytes=64)
    assert tiny.bk == min(autotune.BK_CANDIDATES)


# -- the tile-hygiene pin ---------------------------------------------------

def test_no_literal_tile_sizes_outside_kernels():
    """Tiles are the tuner's (or an explicit caller's) to choose: no module
    outside ``src/repro_torch/kernels/`` passes literal ``kchunk=`` /
    ``bk=`` sizes."""
    import repro_torch
    root = pathlib.Path(next(iter(repro_torch.__path__)))
    pat = re.compile(r"\b(kchunk|bk)\s*=\s*\d")
    offenders = []
    for p in sorted(root.rglob("*.py")):
        if p.relative_to(root).parts[0] == "kernels":
            continue
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if pat.search(line):
                offenders.append(f"{p.relative_to(root)}:{i}: {line.strip()}")
    assert not offenders, (
        "literal kernel tile sizes outside src/repro_torch/kernels/ "
        "(route through kernels.autotune instead):\n" + "\n".join(offenders))
