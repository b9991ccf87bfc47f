"""The top-k kernel's split design, pinned on the CPU.

``csrc/vq_topk.cu`` splits each row over a cluster of 8 blocks and selects
by three digit passes (11 + 10 + 10 bits of the sign-cleared key) whose
per-block histograms are summed across the cluster, skips the last two when
fewer than k keys are non-zero (T = 0), and has each warp place the kept
pairs of its contiguous segment at the exclusive prefix of the lower
blocks' and lower warps' (above, tie) counts.  No CUDA runs here, so this
file holds a numpy model of exactly those steps, on the slices of
``vq_fused._topk_plan`` (and of other cluster sizes), to ``vq_topk_plain``
and to the reference's ``vq_topk_pallas`` (interpret mode), bit for bit: on
rows whose tie runs of +-0, 0.5 and 0.25 straddle slice boundaries, with k
at, one below and one above the non-zero count, at C = 1, 2, 8 and 16, and
at row lengths that are and are not a multiple of 4 (float4 units or single
entries).  Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import vq_fused as jfused
from repro_torch.kernels import vq_fused

torch.set_num_threads(1)

# (kappa, d): N = 3,050, which no slice length divides and 4 does not
# (one-entry units); N = 3,072, float4 units
SHAPES = [(50, 61), (48, 64)]
BITS = ((20, 11), (10, 10), (0, 10))   # (shift, width) of the three digits


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _plan(n, cluster):
    """``_topk_plan``'s slicing at any cluster size (the kernel's is 8)."""
    return vq_fused.TopkPlan(cluster, 4 * -(-n // (4 * cluster)))


def _slices(n, plan):
    return [(min(n, r * plan.slice_len), min(n, (r + 1) * plan.slice_len))
            for r in range(plan.cluster)]


@pytest.mark.parametrize("n", [1, 40_040, 100_003, 524_288, 12_582_912])
@pytest.mark.parametrize("m", [1, 8])
def test_plan_slices_cover_the_row_once(n, m):
    plan = vq_fused._topk_plan(m, n, 1)
    assert plan == _plan(n, 8)
    assert plan.cluster == vq_fused.TOPK_CLUSTER == 8
    assert plan.slice_len % 4 == 0
    covered = np.zeros(n, np.int64)
    for lo, hi in _slices(n, plan):
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the slices overshoot the row by less than 4 entries a block
    assert plan.cluster * plan.slice_len - n < 4 * plan.cluster


def test_plan_at_the_main_shapes_and_rejects_bad_input():
    assert vq_fused._topk_plan(8, 524_288, 5_242) == (8, 65_536)
    assert vq_fused._topk_plan(8, 12_582_912, 125_829) == (8, 1_572_864)
    assert vq_fused._topk_plan(3, 40_040, 37) == (8, 5_008)
    with pytest.raises(ValueError, match="1 <= k"):
        vq_fused._topk_plan(8, 10, 11)
    with pytest.raises(ValueError, match="launch grid"):
        vq_fused._topk_plan(2**28, 10, 1)


def _segments(n, plan):
    """Each block's slice cut into its 32 warps' contiguous segments of
    units (float4s where n % 4 == 0, else single entries), in index order:
    (block, lo, hi) entry ranges."""
    width = 4 if n % 4 == 0 else 1
    out = []
    for r, (lo, hi) in enumerate(_slices(n, plan)):
        units = (hi - lo) // width
        seg = -(-units // 32)
        for w in range(32):
            u0, u1 = min(units, w * seg), min(units, (w + 1) * seg)
            out.append((r, lo + u0 * width, lo + u1 * width))
    return out


def split_select(row, k, plan):
    """The kernel's steps in numpy for one row: (vals, idx, residual)."""
    n = row.shape[0]
    keys = _bits(row) & 0x7FFFFFFF
    seg = [keys[lo:hi] for lo, hi in _slices(n, plan)]
    nz_row = sum(int((s != 0).sum()) for s in seg)   # no histogram for 0
    zeros_row = n - nz_row
    if nz_row < k:                                    # early exit: T = 0
        t, need = 0, k - nz_row
    else:
        want, prefix = k, 0
        for shift, width in BITS:
            # each block's histogram of its keys that match the prefix,
            # summed across the cluster
            tot = sum(np.bincount(
                (s[(s != 0) & ((s >> (shift + width)) == prefix)] >> shift)
                & ((1 << width) - 1), minlength=1 << width) for s in seg)
            if prefix == 0:                           # zeros counted apart
                tot[0] += zeros_row
            cum = 0
            for digit in range((1 << width) - 1, -1, -1):
                if cum + tot[digit] >= want:
                    break
                cum += int(tot[digit])
            want -= cum
            prefix = (prefix << width) | digit
        t, need = prefix, want
    # each warp's (above, tie) counts; its offsets are the exclusive prefix
    # over the lower blocks (published across the cluster) and the lower
    # warps of its block
    parts = _segments(n, plan)
    assert [lo for _, lo, _ in parts[1:]] == [hi for _, _, hi in parts[:-1]]
    gt = np.array([int((keys[lo:hi] > t).sum()) for _, lo, hi in parts])
    eq = np.array([int((keys[lo:hi] == t).sum()) for _, lo, hi in parts])
    gt_off = np.concatenate([[0], np.cumsum(gt)[:-1]])
    eq_off = np.concatenate([[0], np.cumsum(eq)[:-1]])
    vals = np.full(k, np.nan, np.float32)
    idx = np.full(k, -1, np.int64)
    res = row.copy()
    for w, (_, lo, hi) in enumerate(parts):
        s = keys[lo:hi]
        tie_rank = eq_off[w] + np.cumsum(s == t) - 1
        keep = (s > t) | ((s == t) & (tie_rank < need))
        start = gt_off[w] + min(eq_off[w], need)
        pos = start + np.arange(int(keep.sum()))
        assert np.isnan(vals[pos]).all()              # no slot twice
        vals[pos] = row[lo:hi][keep]
        idx[pos] = lo + np.flatnonzero(keep)
        res[lo:hi][keep] = 0.0
    assert (idx >= 0).all()
    return vals, idx, res


def _straddling_row(rng, n, shift):
    """+-0 everywhere; tie runs of +-0.5 and +-0.25 across the slice
    boundaries of C = 2, 8 and 16; a few distinct magnitudes above 1."""
    row = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    for c in (2, 8, 16):
        step = _plan(n, c).slice_len
        for b in range(step, n, step):
            lo, hi = max(0, b - 5 + shift), min(n, b + 5 + shift)
            row[lo:hi] = (0.5 if (b // step) % 2 else 0.25) * sign[lo:hi]
    big = rng.choice(np.flatnonzero(row == 0), 12, replace=False)
    row[big] = (1.0 + rng.random(12)) * sign[big]
    return row


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("dk", [-1, 0, 1])
def test_split_model_matches_plain_and_reference_on_straddling_ties(
        shape, cluster, dk):
    kappa, d = shape
    n = kappa * d
    rng = np.random.default_rng(100 * cluster + dk + 1)
    full = np.stack([_straddling_row(rng, n, s) for s in (0, 3)])
    plan = _plan(n, cluster)
    for j in range(2):
        k = int((full[j] != 0).sum()) + dk    # at, below, above non-zero
        vals, idx, res = split_select(full[j], k, plan)
        pv, pi, pr = vq_fused.vq_topk_plain(torch.from_numpy(full[j:j + 1]),
                                            k)
        np.testing.assert_array_equal(idx, pi[0].numpy())
        np.testing.assert_array_equal(_bits(vals), _bits(pv[0].numpy()))
        np.testing.assert_array_equal(_bits(res), _bits(pr[0].numpy()))
        rv, ri, rr = jfused.vq_topk_pallas(
            jnp.asarray(full[j].reshape(kappa, d)), k, interpret=True)
        order = np.argsort(np.asarray(ri))
        np.testing.assert_array_equal(idx, np.asarray(ri)[order])
        np.testing.assert_array_equal(_bits(vals),
                                      _bits(np.asarray(rv)[order]))
        np.testing.assert_array_equal(_bits(res),
                                      _bits(np.asarray(rr).reshape(-1)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("case", ["normal", "mid_tie", "denormal"])
def test_split_model_matches_plain_past_the_early_exit(shape, cluster, case):
    """All three digit passes: N(0, 1) rows; a k that cuts the 0.5 run;
    and a T among denormals (its top 11 bits 0, so the zeros join bin 0 of
    every pass)."""
    n = shape[0] * shape[1]
    rng = np.random.default_rng(cluster)
    if case == "normal":
        row = rng.standard_normal(n).astype(np.float32)
        k = 97
    elif case == "mid_tie":
        row = _straddling_row(rng, n, 1)
        k = int((np.abs(row) > 0.5).sum()) + int((np.abs(row) == 0.5).sum()) // 2
    else:
        row = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        tiny = rng.choice(n, 300, replace=False)
        row[tiny] = (rng.integers(1, 40, 300) * np.float32(1e-45)).astype(
            np.float32) * np.where(rng.random(300) < 0.5, -1, 1)
        row[tiny[:20]] = rng.standard_normal(20).astype(np.float32)
        k = 150
    plan = _plan(n, cluster)
    vals, idx, res = split_select(row, k, plan)
    pv, pi, pr = vq_fused.vq_topk_plain(torch.from_numpy(row[None]), k)
    np.testing.assert_array_equal(idx, pi[0].numpy())
    np.testing.assert_array_equal(_bits(vals), _bits(pv[0].numpy()))
    np.testing.assert_array_equal(_bits(res), _bits(pr[0].numpy()))
