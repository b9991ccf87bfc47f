"""The argmin engine of the assign, delta and blocked kernels, modelled on
the CPU: its launch plan (``vq_assign.argmin_plan``), the tiled route's
transposed butterfly (``vq::warp_sum_transposed``), the tiled route as a
whole, and the sweep's count-0 epilogue.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them there),
so these tests hold numpy models of the orders ``csrc/vq_delta.cu`` and
``csrc/vq_common.cuh`` spell out against ``vq::warp_dot``'s order (the
model of ``tests/test_torch_window_plan.py``) and against the plain
versions, bit for bit:

* the transposed butterfly: lane l's slot s holds output s ^ f(l), with f
  putting lane bits 4, 3, ... on the slot's top bits; at offset 16 the lane
  keeps half its slots and adds its partner's other half; every output
  gets ``warp_sum``'s tree;
* the tiled route: 32-point tiles, 16-row groups of kappa chunks, 8 x 8
  warp tiles whose lanes read point p ^ pl and row q ^ ql into slot 8q +
  p, the row norms from the same loads through an 8-output butterfly, the
  (min, argmin) folded under ``better``;
* the sweep's epilogue: a row's displacement at count 0 is
  ``0 * w - 0 + residual``, rounded op by op, as eager PyTorch rounds
  ``counts * w - zsum + residual``.
"""

import itertools

import numpy as np
import pytest
import torch

from test_torch_window_plan import (BIG, F32, INT_MAX, better, fma32,
                                    near_tie_codebook, sq_dist,
                                    warp_dot_model)

from repro_torch.kernels import autotune, ops, vq_assign, vq_fused

torch.set_num_threads(1)

#: a flip is accepted where the exact distances of the two rows differ by
#: at most this share of ||z||^2 + ||w||^2 (chip_smoke.FLIP_REL)
FLIP_REL = 2e-6


def lane_partials(a, b, d):
    """Lane l's fma partial of a[o] . b[o] over k = l, l + 32, ... for every
    output o: (32, N) float32."""
    n = a.shape[0]
    p = np.zeros((32, n), F32)
    for j in range(-(-d // 32)):
        for lane in range(32):
            k = 32 * j + lane
            if k < d:
                p[lane] = fma32(a[:, k], b[:, k], p[lane])
    return p


def slot_map(n):
    """f(l) of ``warp_sum_transposed<n>``: lane bits 4, 3, ... on the slot
    index's top bits, for as many offsets as halve the n slots."""
    bits = n.bit_length() - 1
    return [(lane << bits) >> 5 for lane in range(32)]


def transposed_sum(parts, n):
    """``vq::warp_sum_transposed<n>`` on lane partials parts (32, n) (lane
    l's partial of output o): lane l's slot s starts with output s ^ f(l).
    Returns the lanes' final slots (32, max(1, n // 32)) and f."""
    f = slot_map(n)
    v = np.stack([parts[lane][np.arange(n) ^ f[lane]] for lane in range(32)])
    left = n
    for off in (16, 8, 4, 2, 1):
        partner = np.arange(32) ^ off
        if left > 1:
            h = left // 2
            v = (v[:, :h] + v[partner, h:left]).astype(F32)
            left = h
        else:
            v = (v + v[partner]).astype(F32)
    return v, f


@pytest.mark.parametrize("n,d", list(itertools.product(
    (32, 64), (1, 31, 128, 3000, 3072))))
def test_transposed_butterfly_equals_warp_sum_tree(n, d):
    """Every output the transposed butterfly leaves in a lane has the bits
    ``warp_dot`` gives it, and every output is left in exactly one slot."""
    rng = np.random.default_rng(n * 10_000 + d)
    a = (rng.standard_normal((n, d)) * 3).astype(F32)
    b = near_tie_codebook(rng, n, d) - F32(0.5)
    got, f = transposed_sum(lane_partials(a, b, d), n)
    want = warp_dot_model(a, b)
    seen = set()
    for lane in range(32):
        for i in range(got.shape[1]):
            o = i ^ f[lane]
            seen.add(o)
            assert got[lane, i].view(np.int32) == want[o].view(np.int32)
    assert seen == set(range(n))


def test_transposed_butterfly_of_eight_norms_ends_in_every_lane():
    """The row norms' 8-slot butterfly: three halving offsets, then
    ``warp_sum``'s last two levels, so lane l ends with row l >> 2's norm,
    its ``warp_dot`` bits."""
    rng = np.random.default_rng(8)
    for d in (7, 128, 200):
        w = rng.random((8, d)).astype(F32)
        got, f = transposed_sum(lane_partials(w, w, d), 8)
        want = warp_dot_model(w, w)
        assert f == [lane >> 2 for lane in range(32)]
        for lane in range(32):
            assert got[lane, 0].view(np.int32) == want[lane >> 2].view(
                np.int32)


def tiled_model(z, w, kchunk):
    """The tiled route (B > 8) on one worker, as csrc/vq_delta.cu takes it:
    returns (assign, mind)."""
    b, d = z.shape
    kappa = w.shape[0]
    tp, rows, wp_pts, wr_rows = (vq_assign.TILE_POINTS, vq_assign.TILE_ROWS,
                                 8, 8)
    z2 = warp_dot_model(z, z)
    s_n = -(-kappa // kchunk)
    pmin = np.full((b, s_n), BIG, F32)
    pidx = np.full((b, s_n), INT_MAX, np.int64)
    lanes = np.arange(32)
    pl, ql = (lanes & 3) << 1, (lanes >> 2) & 7
    for p0 in range(0, b, tp):
        for s in range(s_n):
            k0, k1 = s * kchunk, min(kappa, s * kchunk + kchunk)
            best = {}
            for r0 in range(k0, k1, rows):
                for wp, wr in itertools.product(range(tp // wp_pts),
                                                range(rows // wr_rows)):
                    pts = p0 + wp * wp_pts + np.arange(wp_pts)
                    rws = r0 + wr * wr_rows + np.arange(wr_rows)
                    # slots the kernel stages past B or the chunk hold zeros
                    zt = np.where((pts < b)[:, None],
                                  z[np.minimum(pts, b - 1)], F32(0))
                    wt = np.where((rws < k1)[:, None],
                                  w[np.minimum(rws, kappa - 1)], F32(0))
                    o = np.arange(64)
                    a_rows, b_rows = zt[o % 8], wt[o // 8]  # output 8q + p
                    cross, f = transposed_sum(lane_partials(a_rows, b_rows,
                                                            d), 64)
                    norm, _ = transposed_sum(lane_partials(wt, wt, d), 8)
                    assert f == [lane << 1 for lane in range(32)]
                    for lane in range(32):
                        r = rws[ql[lane]]
                        for i in range(2):
                            p = pts[pl[lane] + i]
                            if r >= k1 or p >= b:
                                continue
                            dist = sq_dist(z2[p], cross[lane, i],
                                           norm[lane, 0])
                            v, j = best.get(p, (BIG, INT_MAX))
                            if better(dist, r, v, j):
                                best[p] = (dist, r)
            for p, (v, j) in best.items():
                pmin[p, s], pidx[p, s] = v, j
    assign = np.empty(b, np.int64)
    mind = np.empty(b, F32)
    for p in range(b):
        v, j = BIG, INT_MAX
        for s in range(s_n):
            if better(pmin[p, s], pidx[p, s], v, j):
                v, j = pmin[p, s], pidx[p, s]
        assign[p], mind[p] = j, v
    return assign, mind


def sweep_model(z, w):
    """The sweep (B <= 8), and every route's distances: ``warp_dot`` for
    every product and norm, the first row on ties."""
    dist = sq_dist(warp_dot_model(z, z)[:, None],
                   warp_dot_model(z[:, None], w[None]),
                   warp_dot_model(w, w)[None])
    assign = np.array([min(range(len(row)), key=lambda r: (row[r], r))
                       for row in dist])
    return assign, dist[np.arange(len(z)), assign]


@pytest.mark.parametrize("b,kappa,d,kchunk", [(9, 70, 31, 64),
                                              (40, 70, 128, 32),
                                              (33, 37, 200, 256)])
def test_tiled_model_equals_sweep_bitwise_and_plain_at_near_ties(
        b, kappa, d, kchunk):
    """The tiled route, modelled with its lane layout and butterflies on a
    near-tie codebook (ragged point tiles, row groups and kappa chunks,
    d not a multiple of 32 and past one column tile), gives the sweep's
    (assign, mind) bit for bit, and ``vq_assign_plain``'s up to flips at
    near-ties, min distances within the same rule."""
    rng = np.random.default_rng(b * kappa + d)
    w = near_tie_codebook(rng, kappa, d)
    z = (w[rng.integers(0, kappa, size=b)]
         + F32(0.02) * rng.standard_normal((b, d)).astype(F32)).astype(F32)
    assert vq_assign.argmin_plan(1, b, kappa, d, kchunk).route == "tiled"
    at, mt = tiled_model(z, w, kchunk)
    asw, msw = sweep_model(z, w)
    assert at.tolist() == asw.tolist()
    assert mt.view(np.int32).tolist() == msw.view(np.int32).tolist()
    ap, mp = vq_assign.vq_assign_plain(torch.from_numpy(z),
                                       torch.from_numpy(w))
    z64, w64 = z.astype(np.float64), w.astype(np.float64)
    for p in np.flatnonzero(at != ap.numpy()):
        gap = abs(((z64[p] - w64[at[p]]) ** 2).sum()
                  - ((z64[p] - w64[ap[p]]) ** 2).sum())
        assert gap <= FLIP_REL * ((z64[p] ** 2).sum()
                                  + (w64[ap[p]] ** 2).sum())
    # min distances carry the expanded form's rounding: within FLIP_REL of
    # the magnitude that cancels in it, as chip_smoke holds the card to
    keep = at == ap.numpy()
    scale = (z64 ** 2).sum(1) + (w64[at] ** 2).sum(1)
    err = np.abs(mt.astype(np.float64) - mp.numpy().astype(np.float64))
    assert (err[keep] <= FLIP_REL * scale[keep]).all()


def displacement(cnt, w, zs, res):
    """The kernels' __fadd_rn(__fsub_rn(__fmul_rn(cnt, w), zs), res)."""
    return ((F32(cnt) * w).astype(F32) - zs).astype(F32) + res


@pytest.mark.parametrize("counts", [0.0, 1.0, 3.0])
def test_sweep_epilogue_equals_eager_at_signed_zeros(counts):
    """A swept row's displacement, 0 * w - 0 + residual (and a winner's at
    its count and sum), equals eager ``counts * w - zsum + residual`` bit
    for bit where the residual is +0 or -0 and w negative, zero of either
    sign or positive: the sign of every zero survives."""
    rng = np.random.default_rng(int(counts))
    w = np.concatenate([rng.standard_normal(600).astype(F32),
                        np.array([-0.0, 0.0, -1.5, 2.5], F32)])
    res = np.where(np.arange(w.size) % 3 == 0, F32(-0.0),
                   np.where(np.arange(w.size) % 3 == 1, F32(0.0),
                            rng.standard_normal(w.size).astype(F32)))
    res = np.tile(res.astype(F32), (2, 1))
    w2 = np.stack([w, -w])
    zsum = (np.zeros_like(w2) if counts == 0
            else (counts * w2 + F32(0.25)).astype(F32))
    got = displacement(counts, w2, zsum, res)
    tw, tz, tr = (torch.from_numpy(x.copy()) for x in (w2, zsum, res))
    cnt = torch.full((2,), counts)
    eager = cnt.unsqueeze(-1) * tw - tz + tr
    assert got.view(np.int32).tolist() == eager.view(torch.int32).tolist()
    if counts == 0:
        signs = np.signbit(got[res == 0]) == (np.signbit(w2[res == 0])
                                              & np.signbit(res[res == 0]))
        assert signs.all()


def test_blocked_plain_epilogue_keeps_signed_zeros():
    """``vq_delta_blocked_plain`` forms the same eager expression, so on
    rows no point meets the epilogue is 0 * w - 0 + residual, -0 included."""
    w = torch.tensor([[[-1.0, 2.0], [-3.0, -0.0]]])
    z = torch.tensor([[[-1.0, 2.1]]])
    res = torch.tensor([[[0.5, -0.0], [-0.0, -0.0]]])
    _, _, _, assign, delta = vq_fused.vq_delta_blocked_plain(z, w, res)
    assert assign.tolist() == [[0]]
    want = displacement(0.0, w[0, 1].numpy(), np.zeros(2, F32),
                        res[0, 1].numpy())
    assert delta[0, 1].view(torch.int32).tolist() == want.view(
        np.int32).tolist()
    assert torch.signbit(delta[0, 1]).tolist() == [True, True]


def test_argmin_plan_routes_and_fits_at_every_width():
    """The sweep exactly at B <= 8, the tiled route past it; every block
    within the 232,448 B one block may use, at every route and width up to
    d = 8,000; the sweep's points staged while 4 B d + 1,024 fits; the
    tiled route's point tile staged once exactly at d <= 128; tickets and
    partials per worker, point tile and kappa chunk."""
    for m, b, kappa, d, kchunk in itertools.product(
            (1, 8), (1, 2, 7, 8, 9, 31, 32, 33, 128, 1000),
            (5, 1001, 4096), (1, 31, 128, 129, 1807, 3000, 3072, 7232,
                              7233, 8000), (64, 256, 1024)):
        plan = vq_assign.argmin_plan(m, b, kappa, d, kchunk)
        s = -(-kappa // kchunk)
        assert plan.route == ("sweep" if b <= 8 else "tiled")
        assert plan.smem_bytes <= vq_assign.SMEM_MAX
        assert plan.partials == m * b * s
        if plan.route == "sweep":
            assert plan.grid == (s, 1, m) and plan.tickets == m
            assert plan.staged == (4 * b * d + 1024 <= vq_assign.SMEM_MAX)
        else:
            tiles = -(-b // 32)
            assert plan.grid == (s, tiles, m) and plan.tickets == m * tiles
            assert plan.staged == (d <= 128)
    with pytest.raises(ValueError, match="kchunk"):
        vq_assign.argmin_plan(1, 1, 4, 4, 0)
    with pytest.raises(ValueError, match="> 0"):
        vq_assign.argmin_plan(1, 0, 4, 4, 1)


def test_argmin_plan_at_the_main_shapes():
    """The eq.-9 tick at d=3072 sweeps 3072-float points staged (13,312
    B); the serving flush and the eval take the tiled route, one launch."""
    tick = vq_assign.argmin_plan(8, 1, 4096, 3072, 128)
    assert tick == vq_assign.ArgminPlan("sweep", True, (32, 1, 8),
                                        4 * 3072 + 1024, 8, 8 * 32)
    flush = vq_assign.argmin_plan(1, 128, 4096, 128, 64)
    assert flush == vq_assign.ArgminPlan(
        "tiled", True, (64, 4, 1), 4 * (4 * 16 * 128 + 32 * 128) + 1024, 4,
        128 * 64)
    wide = vq_assign.argmin_plan(8, 1000, 4096, 3072, 1024)
    assert wide.staged is False and wide.grid == (4, 32, 8)
    assert wide.smem_bytes == 4 * (4 * 16 * 128 + 4 * 32 * 128) + 1024
    # the blocked kernel's largest block at d=3072 is the tiled route's
    assert ops.delta_smem_bytes(4096, 3072, bk=32) == wide.smem_bytes


def test_tuner_models_every_kind_from_the_plan():
    """At B <= 8 every kind is one sweep (the blocked kernel's bk does not
    enter); past it the tiled argmin, and the kinds with statistics add
    their accumulate pass; the flush spreads over the most blocks."""
    cfg = autotune.TileConfig(128, 32)
    small = {k: autotune.model_time(cfg, 1, 4096, 3072, m=8, kind=k)
             for k in autotune.KINDS}
    assert small["delta"] == small["delta_blocked"] > small["assign"]
    assert small["delta_blocked"] == autotune.model_time(
        autotune.TileConfig(128, 8), 1, 4096, 3072, m=8,
        kind="delta_blocked")
    big = {k: autotune.model_time(cfg, 1000, 4096, 128, m=8, kind=k)
           for k in autotune.KINDS}
    assert big["assign"] < big["delta"] and big["assign"] < big[
        "delta_blocked"]
    autotune.reset("cache")
    try:
        assert autotune.pick_tiles(128, 4096, 128, device="cpu",
                                   kind="assign").kchunk == 64
    finally:
        autotune.reset("cache")
