"""The window kernel's launch plan and resident sweep order, and the delta
kernel's one-launch sweep (its combine, its scratch and its tuner memo),
modelled on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them there),
so these tests hold numpy models of the orders their sources spell out
against each other and against the plain versions, bit for bit:

* ``vq::warp_dot`` (``csrc/vq_common.cuh``): lane l accumulates k = l,
  l + 32, ... with fma, then the xor butterfly over the warp;
* the resident window route's ``row_dot`` (``csrc/vq_window.cu``): one
  thread a row, float4 columns padded with zeros, the 32 lane partials in
  registers and the butterfly's tree;
* the delta sweep's per-row loop (``csrc/vq_delta.cu``): 4 columns a lane a
  step, the row norm from the same loads;
* the combine of the sweep's S partials: the last block's lanes take s = l,
  l + 32, ... and meet in ``vq::warp_argmin``, against the passes' fixed
  order.

numpy has no fused multiply-add, so ``fma32`` forms the exact a*b + c in
float64 (a float32 product is exact there) with its rounding error, rounds
to odd, then to float32: correct rounding, since float64 carries more than
float32's 24 bits plus two.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops, vq_assign, vq_fused

torch.set_num_threads(1)

F32 = np.float32
BIG = F32(3e38)
INT_MAX = 2**31 - 1


def fma32(a, b, c):
    """Correctly rounded float32 fma of float32 arrays (see the module
    docstring)."""
    a, b, c = (np.asarray(x, dtype=np.float64) for x in (a, b, c))
    p = a * b                      # exact
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly
    inexact = err != 0
    # round to odd: the neighbour toward zero of p + c, with its last bit set
    toward_zero = np.where((err > 0) == (s > 0), s, np.nextafter(s, 0.0))
    odd = (toward_zero.view(np.int64) | 1).view(np.float64)
    return np.where(inexact, odd, s).astype(F32)


def warp_dot_model(a, b):
    """``vq::warp_dot`` over the last axis of float32 arrays a, b (rows of
    width d): the lane partials, then the butterfly, lane by lane."""
    d = a.shape[-1]
    lanes = np.zeros(np.broadcast_shapes(a.shape, b.shape)[:-1] + (32,), F32)
    for k in range(d):
        lanes[..., k % 32] = fma32(a[..., k], b[..., k], lanes[..., k % 32])
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(32) ^ off]).astype(F32)
    assert (lanes == lanes[..., :1]).all()   # every lane ends equal
    return lanes[..., 0]


def row_dot_model(a, b):
    """The resident window route's ``row_dot``: rows padded with zero
    columns to whole float4s, groups of 8 float4s feeding p[4j + e], then
    the tree p[l] += p[l + off] for off = 16 .. 1."""
    d = a.shape[-1]
    n4 = -(-d // 4)
    pad = [(0, 0)] * (a.ndim - 1) + [(0, 4 * n4 - d)]
    a4 = np.pad(a, pad).astype(F32)
    pad = [(0, 0)] * (b.ndim - 1) + [(0, 4 * n4 - d)]
    b4 = np.pad(b, pad).astype(F32)
    p = np.zeros(np.broadcast_shapes(a.shape, b.shape)[:-1] + (32,), F32)
    for g in range(0, n4, 8):
        for j in range(8):
            if g + j < n4:
                for e in range(4):
                    k = 4 * (g + j) + e
                    p[..., 4 * j + e] = fma32(a4[..., k], b4[..., k],
                                              p[..., 4 * j + e])
    for off in (16, 8, 4, 2, 1):
        p[..., :off] = (p[..., :off] + p[..., off:2 * off]).astype(F32)
    return p[..., 0]


def sweep_dot_model(z, w):
    """The delta sweep's per-row loop: lane l steps k = l, l + 128, ... and
    takes columns k + 32c for c < 4 in turn; the norm from the same loads.
    Returns (z.w, ||w||^2) with the butterfly of ``warp_dot``."""
    d = w.shape[-1]
    shape = np.broadcast_shapes(z.shape, w.shape)[:-1] + (32,)
    acc, n2 = np.zeros(shape, F32), np.zeros(w.shape[:-1] + (32,), F32)
    for lane in range(32):
        for k in range(lane, d, 128):
            for c in range(4):
                kk = k + 32 * c
                if kk < d:
                    n2[..., lane] = fma32(w[..., kk], w[..., kk],
                                          n2[..., lane])
                    acc[..., lane] = fma32(z[..., kk], w[..., kk],
                                           acc[..., lane])
    out = []
    for lanes in (acc, n2):
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[..., np.arange(32) ^ off]).astype(F32)
        out.append(lanes[..., 0])
    return out[0], out[1]


def sq_dist(z2, cross, w2):
    """``vq::sq_dist``: ||z||^2 - 2 z.w + ||w||^2, each operation rounded."""
    return ((F32(z2) - (F32(2) * cross).astype(F32)).astype(F32)
            + w2).astype(F32)


def better(d, i, bd, bi):
    return d < bd or (d == bd and i < bi)


def argmin_blocks(dist, rows):
    """Per-block (min, argmin) over ``rows``-row blocks of ``dist``, then the
    cluster's combine, as the window kernel meets them."""
    parts = []
    for r0 in range(0, len(dist), rows):
        v, i = BIG, INT_MAX
        for r in range(r0, min(len(dist), r0 + rows)):
            if better(dist[r], r, v, i):
                v, i = dist[r], r
        parts.append((v, i))
    v, i = BIG, INT_MAX
    for pv, pi in parts:
        if better(pv, pi, v, i):
            v, i = pv, pi
    return i


def window_model(zwin, w0, eps, resident):
    """The window kernel on float32 arrays: tau steps per worker, the
    argmin in the plan's blocks, the winner's update w - eps*(w - z) and
    its norm recomputed in ``warp_dot``'s order.  ``resident``: distances
    as the resident route takes them (``row_dot`` for a block's rows in
    shared memory, ``warp_dot`` for its register rows); else ``warp_dot``
    for every row, as the streaming route and the delta kernel."""
    m, tau, d = zwin.shape
    kappa = w0.shape[0]
    plan = vq_fused._window_plan(m, kappa, d)
    in_regs = np.arange(kappa) % plan.rows >= plan.rows - plan.reg_rows
    if not resident:
        in_regs[:] = True

    def dot(a, w):
        out = np.empty(np.broadcast_shapes(a.shape, w.shape)[:-1], F32)
        out[..., in_regs] = warp_dot_model(a, w[in_regs])
        out[..., ~in_regs] = row_dot_model(a, w[~in_regs])
        return out

    out = np.repeat(w0[None], m, axis=0).astype(F32)
    for j in range(m):
        w = out[j]
        w2 = np.empty(kappa, F32)
        w2[in_regs] = warp_dot_model(w[in_regs], w[in_regs])
        w2[~in_regs] = row_dot_model(w[~in_regs], w[~in_regs])
        for t in range(tau):
            z = zwin[j, t]
            z2 = warp_dot_model(z, z)
            dist = sq_dist(z2, dot(z[None], w), w2)
            i = argmin_blocks(dist, plan.rows)
            e = F32(eps[t])
            w[i] = (w[i] - (e * (w[i] - z).astype(F32)).astype(F32)
                    ).astype(F32)
            w2[i] = warp_dot_model(w[i], w[i])
    return out


def order_error(z, w):
    """The most that any float32 summation order (with or without fma) can
    put ``vq::sq_dist`` of z against each row of w off the exact distance:
    gamma_(d+2) (||z||^2 + 2 sum |z w| + ||w||^2), the bound on the three
    d-term dot products and the two operations after them.  At d = 1 each
    product is rounded once whatever the order, so every route computes the
    same distance and the bound is 0."""
    d = z.shape[-1]
    if d == 1:
        return np.zeros(w.shape[0])
    z, w = z.astype(np.float64), w.astype(np.float64)
    gamma = (d + 2) * 2.0**-24 / (1 - (d + 2) * 2.0**-24)
    return gamma * ((z * z).sum() + 2 * np.abs(w * z).sum(-1)
                    + (w * w).sum(-1))


def order_margin(zwin, w0, eps):
    """The window replayed with exact distances: the least, over every step
    of every worker, of the gap from the step's winner to any row that is
    not a copy of it, less both rows' ``order_error``.  Positive: every
    summation order picks the same winner at every step (copies tie exactly
    and go to the lower index)."""
    least = np.inf
    for j in range(zwin.shape[0]):
        w = w0.copy()
        for t in range(zwin.shape[1]):
            z = zwin[j, t]
            dist = ((w.astype(np.float64) - z) ** 2).sum(-1)
            err = order_error(z, w)
            i = int(np.argmin(dist))
            other = ~(w == w[i]).all(-1)
            least = min(least, (dist[other] - dist[i] - err[other]
                                - err[i]).min())
            e = F32(eps[t])
            w[i] = (w[i] - (e * (w[i] - z)).astype(F32)).astype(F32)
    return least


def near_tie_codebook(rng, kappa, d):
    """Rows in pairs and triples: exact copies (ties, the lower index wins)
    and copies moved by a step in one column (near-ties that every
    summation order still ranks alike).  The step grows as sqrt(d gamma_d),
    the order error's scale for entries in [0, 1): 0.04 at d = 31, 3.0 at
    d = 3,072, where a fixed 1e-2 fell under the rounding of a 3,072-term
    dot product and host BLAS orders flipped winners."""
    base = rng.random((-(-kappa // 3), d)).astype(F32)
    w = np.repeat(base, 3, axis=0)[:kappa].copy()
    gamma = d * 2.0**-24 / (1 - d * 2.0**-24)
    w[2::3, rng.integers(0, d)] += F32(1e-2 + 4 * np.sqrt(d * gamma))
    return w


@pytest.mark.parametrize("d", [1, 31, 128, 3072])
def test_row_dot_and_sweep_orders_equal_warp_dot_bitwise(d):
    """The resident window sweep's thread-per-row order and the delta
    sweep's loop give ``warp_dot``'s bits, on near-tie rows."""
    rng = np.random.default_rng(d)
    kappa = 37
    w = near_tie_codebook(rng, kappa, d)
    z = (rng.random(d).astype(F32) - F32(0.5)) * F32(3)
    want = warp_dot_model(z[None], w)
    got = row_dot_model(z[None], w)
    assert want.view(np.int32).tolist() == got.view(np.int32).tolist()
    norms = warp_dot_model(w, w)
    assert (row_dot_model(w, w).view(np.int32)
            == norms.view(np.int32)).all()
    cross, n2 = sweep_dot_model(z[None], w)
    assert (cross.view(np.int32) == want.view(np.int32)).all()
    assert (n2.view(np.int32) == norms.view(np.int32)).all()


@pytest.mark.parametrize("m,tau,kappa,d", [(2, 4, 1001, 1), (3, 5, 1001, 31),
                                           (2, 3, 203, 128),
                                           (1, 3, 4001, 128),
                                           (1, 2, 37, 3072)])
def test_window_model_equals_plain_bitwise(m, tau, kappa, d):
    """The window kernel modelled in its resident order, at a kappa the
    cluster's rows do not divide (and at 4,001 rows, with register rows),
    equals ``vq_window_plain`` and the ``warp_dot`` model, bit for bit, on
    near-tie rows."""
    plan = vq_fused._window_plan(m, kappa, d)
    assert plan.resident and kappa % plan.rows != 0
    assert (plan.reg_rows > 0) == (kappa > 4000)
    rng = np.random.default_rng(kappa + d)
    w0 = near_tie_codebook(rng, kappa, d)
    zwin = w0[rng.integers(0, kappa, size=(m, tau))] + F32(0.01) * (
        rng.standard_normal((m, tau, d)).astype(F32))
    zwin = zwin.astype(F32)
    eps = (F32(0.5) / (F32(1) + np.arange(1, tau + 1, dtype=F32))).astype(F32)
    assert order_margin(zwin, w0, eps) > 0   # the near-ties rank alike
    resident = window_model(zwin, w0, eps, True)
    warp = window_model(zwin, w0, eps, False)
    plain = vq_fused.vq_window_plain(torch.from_numpy(zwin),
                                     torch.from_numpy(w0),
                                     torch.from_numpy(eps)).numpy()
    assert (resident.view(np.int32) == warp.view(np.int32)).all()
    assert (resident.view(np.int32) == plain.view(np.int32)).all()
    assert not (resident == w0[None]).all()   # the window moved rows


def test_window_plan_main_shapes():
    """(8, 4096, 128): resident in 8-block clusters of 512 rows, 433 in
    shared memory and 79 in registers; (8, 4096, 3072): 48 MiB a worker,
    the streaming route in 8-block clusters."""
    main = vq_fused._window_plan(8, 4096, 128)
    assert main == vq_fused.WindowPlan(True, 512, 512, 79, 33, 232_436)
    assert main.smem_bytes == vq_fused._resident_smem(433, 128)[1]
    assert vq_fused.smem_bytes(4096, 128) == main.smem_bytes
    wide = vq_fused._window_plan(8, 4096, 3072)
    assert wide == vq_fused.WindowPlan(False, 512, 512, 0, 0,
                                       4 * (512 + 2 * 3072) + 8 * 18)
    assert vq_fused.smem_bytes(4096, 3072) == wide.smem_bytes == 26_768
    with pytest.raises(ValueError, match="M, kappa and d > 0"):
        vq_fused._window_plan(0, 4096, 128)
    with pytest.raises(ValueError, match="65535"):
        vq_fused._window_plan(65536, 4096, 128)


def _on_chip_rows(d):
    """Rows one resident block holds: shared memory's, then registers'."""
    fit = 0
    while vq_fused._resident_smem(fit + 1, d)[1] <= vq_assign.SMEM_MAX:
        fit += 1
    return fit + (vq_fused.WARPS * vq_fused.REG_ROWS if d <= 128 else 0)


def test_every_window_plan_fits_and_covers_its_rows():
    """At the card's budget and smaller ones, every plan is resident where
    a block's kappa/8 rows fit on chip and the block fits the budget,
    streaming otherwise, and ``window_fits`` says whether its block fits
    the budget."""
    for budget, kappa, d in itertools.product(
            (vq_assign.SMEM_MAX, 100_000, 3_000),
            (1, 5, 16, 1001, 4096, 4097, 8000, 40_000, 500_000),
            (1, 8, 31, 40, 128, 129, 1807, 2048, 3072)):
        plan = vq_fused._window_plan(8, kappa, d, budget)
        assert plan.rows == -(-kappa // vq_fused.CLUSTER_BLOCKS)
        fits = ops.window_fits(kappa, d, budget_bytes=budget)
        assert fits == (plan.smem_bytes <= budget)
        assert vq_fused.smem_bytes(kappa, d, budget) == plan.smem_bytes
        if plan.resident:
            srows = plan.rows - plan.reg_rows
            assert plan.smem_bytes == vq_fused._resident_smem(srows, d)[1]
            assert fits and plan.smem_bytes <= vq_assign.SMEM_MAX
            assert plan.rows <= _on_chip_rows(d)
            assert plan == vq_fused._window_plan(8, kappa, d)
            assert plan.stride4 % 2 == 1 and 4 * plan.stride4 >= d
            assert plan.threads % 32 == 0
            assert 32 <= plan.threads <= vq_fused.WINDOW_THREADS
            if plan.reg_rows:
                assert d <= 32 * vq_fused.REG_COLS
                assert plan.threads == vq_fused.WINDOW_THREADS
                assert plan.reg_rows <= vq_fused.WARPS * vq_fused.REG_ROWS
        else:
            assert plan.threads == vq_fused.WINDOW_THREADS
            assert plan.reg_rows == 0
            assert plan.smem_bytes == (4 * (plan.rows + 2 * d)
                                       + vq_fused.STREAM_STATIC_SMEM)
            # a block's rows do not fit on chip, or not within the budget
            full = vq_fused._window_plan(8, kappa, d)
            assert plan.rows > _on_chip_rows(d) or (
                full.resident and full.smem_bytes > budget)


def test_window_plan_and_fits_agree_with_the_forced_budget():
    """The 1,024 B budget ``chip_smoke.py`` forces (phase 12) sends the
    window and the delta steps past their kernels at both widths; the
    default budget runs both kernels at d=128 and the window at d=3072."""
    for d in (128, 3072):
        assert vq_fused._window_plan(8, 4096, d, 1024).smem_bytes > 1024
        assert not ops.window_fits(4096, d, budget_bytes=1024)
        assert ops.delta_route(d, budget_bytes=1024) == "blocked"
        assert ops.window_fits(4096, d)
    assert ops.delta_route(128) == "full"
    assert ops.delta_route(3072) == "blocked"


@pytest.mark.parametrize("budget", [3_216, 50_000, 232_435])
def test_window_plan_streams_at_a_budget_between_the_routes(budget):
    """At 4096 x 128 a budget below the resident block's 232,436 B but not
    below the streaming block's 3,216 B takes the streaming route, so the
    window kernel still runs; a byte less refuses it, and 232,436 keeps
    the codebook on chip."""
    plan = vq_fused._window_plan(8, 4096, 128, budget)
    assert plan == vq_fused.WindowPlan(False, 512, 512, 0, 0, 3_216)
    assert ops.window_fits(4096, 128, budget_bytes=budget)
    assert not ops.window_fits(4096, 128, budget_bytes=3_215)
    assert vq_fused._window_plan(8, 4096, 128, 232_436).resident


def combine_fixed(parts):
    v, i = BIG, INT_MAX
    for pv, pi in parts:
        if better(pv, pi, v, i):
            v, i = pv, pi
    return v, i


def combine_warp(parts):
    """The sweep's last block: lane l folds s = l, l + 32, ... in order,
    then ``vq::warp_argmin``'s xor butterfly."""
    lanes = [(BIG, INT_MAX)] * 32
    for s, (pv, pi) in enumerate(parts):
        v, i = lanes[s % 32]
        if better(pv, pi, v, i):
            lanes[s % 32] = (pv, pi)
    for off in (16, 8, 4, 2, 1):
        new = []
        for lane in range(32):
            v, i = lanes[lane]
            ov, oi = lanes[lane ^ off]
            new.append((ov, oi) if better(ov, oi, v, i) else (v, i))
        lanes = new
    assert len(set((float(v), i) for v, i in lanes)) == 1
    return lanes[0]


def argmin_key(d, i):
    """``vq::argmin_key``: the distance's bits made order-preserving (-0.0
    taken as +0.0) above the index, as one unsigned 64-bit key."""
    u = int(np.float32(0.0 if d == 0 else d).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | i


def partials(dist, kchunk):
    """(min, argmin) of each kchunk-row chunk, as a sweep block leaves it."""
    return [combine_fixed([(dist[r], r) for r in range(s, min(len(dist),
                                                              s + kchunk))])
            for s in range(0, len(dist), kchunk)]


@pytest.mark.parametrize("kappa", [64, 1001, 4096])
def test_sweep_combine_any_order_gives_the_fixed_combine(kappa):
    """On tie-heavy distances (repeated values, +0.0 and -0.0, the BIG of a
    chunk with no live row) any kchunk split, any order of the partials,
    the last block's warp tree and the minimum of ``vq::argmin_key``s (the
    resident window's combine, -0.0 keyed as +0.0) find the fixed-order
    combine's (min, argmin), with the winner's own bits."""
    rng = np.random.default_rng(kappa)
    levels = np.array([-0.0, 0.0, 1.5, 1.5, 2.0, BIG], F32)
    dist = levels[rng.integers(0, len(levels), size=kappa)]
    dist[rng.integers(0, kappa, size=3)] = F32(-0.0)
    want = combine_fixed([(dist[r], r) for r in range(kappa)])
    assert want[0] == 0 and want[1] == int(np.flatnonzero(dist == 0)[0])
    for kchunk in (64, 128, 256, 512, 1024, 7):
        parts = partials(dist, kchunk)
        got = combine_warp(parts)
        assert got[1] == want[1]
        assert np.float32(got[0]).view(np.int32) == dist[want[1]].view(
            np.int32)
        for _ in range(5):
            order = rng.permutation(len(parts))
            shuffled = combine_fixed([parts[s] for s in order])
            assert shuffled[1] == want[1]
            assert np.float32(shuffled[0]).view(np.int32) == np.float32(
                want[0]).view(np.int32)
        # the resident window's blocks: each block's key the min of its
        # warps' keys (atomicMin), the cluster's winner the min of those
        keys = [argmin_key(v, i) for v, i in parts]
        assert min(keys) & 0xFFFFFFFF == want[1]
        assert min(argmin_key(dist[r], r) for r in range(kappa)) == min(keys)
    # the passes' combine of 8-point blocks over the same chunks agrees
    assert combine_fixed(partials(dist, 256)) == combine_warp(
        partials(dist, 256))


def test_sweep_smem_and_route_limits():
    """The sweep holds at most 8 points; from d = 1,807 on the delta
    kernel's largest block is still the accumulate pass's, so
    ``delta_fits`` keeps its edge (below it the tiled argmin's tiles are
    the largest)."""
    assert vq_assign.SMALL_B == 8
    plan = vq_assign.argmin_plan
    assert plan(8, 1, 4096, 128, 128).smem_bytes == 4 * 128 + 1024
    assert plan(8, 8, 4096, 128, 128).smem_bytes == 4 * 8 * 128 + 1024
    for d in (1807, 3072):
        assert vq_assign.smem_bytes(d) == vq_assign.accumulate_smem_bytes(d)
    for d in (1, 128):
        assert (vq_assign.smem_bytes(d) == plan(1, 9, 1, d, 1).smem_bytes
                == 4 * (4 * 16 * 128 + 32 * 128) + 1024)
    assert ops.delta_fits(1807) and not ops.delta_fits(1808)


def test_sweep_scratch_is_kept_per_device_and_stream():
    """Tickets start (and, the kernel leaving them so, stay) 0; a call that
    needs more grows the buffers; another stream gets its own."""
    cpu = torch.device("cpu")
    saved = dict(vq_assign._scratch)
    vq_assign._scratch.clear()
    try:
        t1, p1, i1 = vq_assign._sweep_scratch(cpu, 0, 8, 128)
        assert t1.dtype == torch.int32 and not t1.any() and t1.numel() == 8
        assert p1.numel() == i1.numel() == 128
        again = vq_assign._sweep_scratch(cpu, 0, 3, 64)
        assert all(a is b for a, b in zip(again, (t1, p1, i1)))
        grown = vq_assign._sweep_scratch(cpu, 0, 16, 64)
        assert grown[0].numel() == 16 and grown[1].numel() == 128
        other = vq_assign._sweep_scratch(cpu, 7, 8, 128)
        assert other[0] is not grown[0]
    finally:
        vq_assign._scratch.clear()
        vq_assign._scratch.update(saved)


def test_kchunk_memo_follows_the_tuner():
    """A pick is kept for the wrappers' fast path per shape and named
    device, answered again without a search, and dropped after a mode
    change or reset."""
    cpu = torch.device("cpu")
    autotune.reset("cache")
    try:
        first = autotune.pick_tiles(1, 4096, 128, m=8, device=cpu,
                                    kind="delta")
        fast = ("delta", 1, 4096, 128, 8, cpu)
        assert autotune._STATE.hits == {fast: first}
        misses = autotune.search_count()
        assert autotune.pick_tiles(1, 4096, 128, m=8, device=cpu,
                                   kind="delta") is first
        assert autotune.search_count() == misses
        autotune._STATE.hits[fast] = autotune.TileConfig(7, 7)
        assert autotune.pick_tiles(1, 4096, 128, m=8, device=cpu,
                                   kind="delta").kchunk == 7   # no lookup
        autotune.set_mode("off")
        assert not autotune._STATE.hits
        assert autotune.pick_tiles(1, 4096, 128, m=8, device=cpu,
                                   kind="delta").kchunk == vq_assign.KCHUNK
        autotune.set_mode("cache")
        autotune.pick_tiles(1, 4096, 128, m=8, device=cpu, kind="delta")
        autotune.reset("cache")
        assert not autotune._STATE.hits
    finally:
        autotune.reset("cache")


def test_tuner_models_the_sweep_at_small_batches():
    """At B <= 8 the model times the one-launch sweep: at the eq.-9 tick the
    kappa split the card timed fastest (128 rows, 256 blocks) wins, and the
    sweep runs at d=3072, where the passes' accumulate tile fits no SM."""
    def t(kchunk, batch, d=128):
        return autotune.model_time(autotune.TileConfig(kchunk, 32), batch,
                                   4096, d, m=8, kind="delta")

    assert t(128, 1) < t(64, 1) < t(256, 1) < t(1024, 1)
    assert t(128, 8) < t(1024, 8)
    assert t(256, 1, 3072) < float("inf")
    assert t(256, 9, 3072) == float("inf")
    autotune.reset("cache")
    assert autotune.pick_tiles(1, 4096, 128, m=8, device="cpu",
                               kind="delta").kchunk == 128
