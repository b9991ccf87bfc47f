"""The port's kernel modules held against ``repro.kernels``.

Here, on the CPU, each kernel wrapper takes its plain version (CUDA tensors
launch the kernel; ``chip_smoke.py`` holds the kernels against these plain
versions on the card).  The reference's Pallas kernels run in interpret
mode, as its own tests run them.  Tolerances: assignments equal, counts
exact, codebooks, sums and distances at ``rtol=1e-4, atol=1e-6``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vq as jvq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import vq_fused as jfused
from repro_torch.core import vq
from repro_torch.kernels import _build, ops, ref, vq_assign, vq_fused

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _mixture(rng, shape, d, n_centers=10, noise=0.05):
    centers = rng.random((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=shape)
    eps = noise * rng.standard_normal(shape + (d,)).astype(np.float32)
    return (centers[assign] + eps).astype(np.float32)


def _window_inputs(seed, m, tau, kappa, d, t0=0):
    rng = np.random.default_rng(seed)
    zwin = _mixture(rng, (m, tau), d)
    w0 = _mixture(rng, (kappa,), d)
    eps = np.array(jvq.default_steps(
        jnp.arange(t0 + 1, t0 + 1 + tau, dtype=jnp.int32)))
    return zwin, w0, eps


@pytest.mark.parametrize("m,tau,kappa,d", [(8, 10, 16, 8), (1, 10, 64, 16)])
def test_window_plain_matches_reference_window_kernel(m, tau, kappa, d):
    zwin, w0, eps = _window_inputs(0, m, tau, kappa, d, t0=20)
    ours = vq_fused.vq_window(torch.from_numpy(zwin), torch.from_numpy(w0),
                              torch.from_numpy(eps))
    assert ours.shape == (m, kappa, d)
    for i in range(m):
        want = jops.vq_window(jnp.asarray(zwin[i]), jnp.asarray(w0),
                              jnp.asarray(eps))
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch,kappa,d", [(1, 16, 8), (37, 200, 8),
                                           (300, 200, 16)])
def test_delta_plain_matches_reference_kernel_and_ref(batch, kappa, d):
    """Ragged batches (not a block multiple) and kappa > 128."""
    rng = np.random.default_rng(batch)
    z = _mixture(rng, (batch,), d)
    w = _mixture(rng, (kappa,), d)
    counts, zsum, mind, assign = vq_assign.vq_delta(torch.from_numpy(z),
                                                    torch.from_numpy(w))
    jc, jz = jops.vq_delta(jnp.asarray(z), jnp.asarray(w))
    rc, rz = jref.vq_delta_ref(jnp.asarray(z), jnp.asarray(w))
    ra, rm = jref.vq_assign_ref(jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ra))
    assert assign.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(zsum.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(zsum.numpy(), np.asarray(rz), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(mind.numpy(), np.asarray(rm), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        float(ops.distortion(torch.from_numpy(z), torch.from_numpy(w))),
        float(jops.distortion(jnp.asarray(z), jnp.asarray(w))), rtol=RTOL)


@pytest.mark.parametrize("d", [1808, 4096])
def test_distortion_past_delta_width_matches_reference(d):
    """Eq. 2 at widths past the delta kernel's shared memory (d > 1,807):
    4,096 is granite-8b's embedding width, which the embedding example
    scores on the card."""
    rng = np.random.default_rng(d)
    z = rng.standard_normal((40, d)).astype(np.float32)
    w = rng.standard_normal((16, d)).astype(np.float32)
    np.testing.assert_allclose(
        float(ops.distortion(torch.from_numpy(z), torch.from_numpy(w))),
        float(jops.distortion(jnp.asarray(z), jnp.asarray(w))), rtol=RTOL)


@pytest.mark.parametrize("batch,kappa,d", [(1, 130, 8), (37, 200, 16),
                                           (129, 300, 16)])
def test_assign_plain_matches_reference_kernel_and_ref(batch, kappa, d):
    """kappa not a multiple of 128: the reference kernel masks its padded
    columns; N(0, 1) data as the reference's serving tests use."""
    rng = np.random.default_rng(100 + batch)
    z = rng.standard_normal((batch, d)).astype(np.float32)
    w = rng.standard_normal((kappa, d)).astype(np.float32)
    assign, mind = vq_assign.vq_assign(torch.from_numpy(z),
                                       torch.from_numpy(w))
    assert assign.dtype == torch.int32 and mind.dtype == torch.float32
    for ja, jm in (jops.vq_assign(jnp.asarray(z), jnp.asarray(w)),
                   jref.vq_assign_ref(jnp.asarray(z), jnp.asarray(w))):
        np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
        np.testing.assert_allclose(mind.numpy(), np.asarray(jm), rtol=1e-5)
    a2, m2 = ops.vq_assign(torch.from_numpy(z), torch.from_numpy(w))
    assert torch.equal(a2, assign) and torch.equal(m2, mind)


@pytest.mark.parametrize("shape", [(3, 37, 200, 8), (1, 5, 16, 8)])
def test_assign_plain_equals_delta_plain_bitwise(shape):
    """The CPU side of the card contract: the assign and delta plain
    versions give the same (assign, mind) to the bit, stacked or 2-D."""
    m, b, kappa, d = shape
    rng = np.random.default_rng(m * b)
    z = torch.from_numpy(_mixture(rng, (m, b), d))
    w = torch.from_numpy(_mixture(rng, (m, kappa), d))
    for zz, ww in ((z, w), (z[0], w[0])):
        assign, mind = vq_assign.vq_assign(zz, ww)
        _, _, dmind, dassign = vq_assign.vq_delta(zz, ww)
        assert torch.equal(assign, dassign) and assign.dtype == torch.int32
        assert torch.equal(mind, dmind)
        assert assign.shape == zz.shape[:-1]


def test_delta_stacked_workers_match_per_worker():
    rng = np.random.default_rng(7)
    z = torch.from_numpy(_mixture(rng, (8, 30), 8))
    w = torch.from_numpy(_mixture(rng, (8, 16), 8))
    counts, zsum = ops.vq_delta(z, w)
    assert counts.shape == (8, 16) and zsum.shape == (8, 16, 8)
    for i in range(8):
        c, s = ops.vq_delta(z[i], w[i])
        torch.testing.assert_close(counts[i], c, rtol=0, atol=0)
        torch.testing.assert_close(zsum[i], s, rtol=RTOL, atol=ATOL)


def test_port_ref_matches_reference_ref():
    rng = np.random.default_rng(8)
    z = _mixture(rng, (50,), 8)
    w = _mixture(rng, (40,), 8)
    a, m = ref.vq_assign_ref(torch.from_numpy(z), torch.from_numpy(w))
    ja, jm = jref.vq_assign_ref(jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=RTOL, atol=ATOL)
    c, s = ref.vq_delta_ref(torch.from_numpy(z), torch.from_numpy(w))
    jc, js = jref.vq_delta_ref(jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(ref.distortion_ref(torch.from_numpy(z), torch.from_numpy(w))),
        float(jref.distortion_ref(jnp.asarray(z), jnp.asarray(w))), rtol=RTOL)


@pytest.mark.parametrize("m", [1, 8])
def test_window_plain_equals_per_step_delta_scan_bitwise(m):
    """The CPU side of the card contract: the window's plain version and
    the per-step scan through the delta plain version agree to the bit."""
    zwin, w0, eps = _window_inputs(1, m, 10, 16, 8, t0=50)
    zt, w0t, epst = (torch.from_numpy(x) for x in (zwin, w0, eps))
    fused = vq_fused.vq_window(zt, w0t, epst)
    w = w0t.expand(m, 16, 8).contiguous()
    for s in range(10):
        counts, zsum = ops.vq_delta_routed(zt[:, s].unsqueeze(1).contiguous(),
                                           w)
        w = w - epst[s] * (counts.unsqueeze(-1) * w - zsum)
    assert torch.equal(fused, w)
    # and the per-step scan over core.vq.H
    w = w0t.expand(m, 16, 8).contiguous()
    for s in range(10):
        w = w - epst[s] * vq.H(zt[:, s], w)
    assert torch.equal(fused, w)


def test_residency_predicates_and_routing():
    # the slice's width fits both kernels by far
    assert ops.window_fits(4096, 128) and ops.delta_fits(128)
    # 433 of a block's 512 rows in shared memory, padded to 33 float4s, with
    # their norms, four point buffers and the keys (79 rows in registers)
    assert vq_fused.smem_bytes(4096, 128) == (16 * 433 * 33 + 4 * 433
                                              + 4 * 512 + 32)
    # 62,500 norms per block of the 8-block cluster are 250,000 B
    assert not ops.window_fits(500_000, 8)
    assert not ops.delta_fits(2048)   # a (32, 2048) f32 tile is 256 KiB
    # past the delta kernel's budget the blocked route answers, with the
    # plain result
    rng = np.random.default_rng(3)
    z = torch.from_numpy(_mixture(rng, (5,), 2048))
    w = torch.from_numpy(_mixture(rng, (3,), 2048))
    assert ops.delta_route(2048) == "blocked"
    counts, zsum = ops.vq_delta_routed(z, w)
    pc, pz, _, _ = vq_assign.vq_delta_plain(z, w)
    assert torch.equal(counts, pc) and torch.equal(zsum, pz)
    counts, zsum = ops.vq_delta_routed(torch.zeros((1, 4)), torch.zeros((3, 4)))
    assert counts.shape == (3,) and zsum.shape == (3, 4)


def test_wrappers_validate_inputs():
    z = torch.zeros((2, 1, 4))
    w = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        vq_assign.vq_delta(z.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="float32"):
        vq_assign.vq_delta(z.double(), w.double())
    with pytest.raises(ValueError, match="mismatch"):
        vq_assign.vq_delta(z, torch.zeros((2, 3, 5)))
    zwin = torch.zeros((2, 3, 4))
    eps = torch.ones(3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        vq_fused.vq_window(zwin.to("meta"), w[0].to("meta"), eps.to("meta"))
    with pytest.raises(ValueError, match="mismatch"):
        vq_fused.vq_window(zwin, w[0], torch.ones(2))
    before = (vq_fused.launches, vq_assign.launches)
    vq_fused.vq_window(zwin, w[0], eps)
    vq_assign.vq_delta(z, w)
    # the plain versions on the CPU are not kernel launches
    assert (vq_fused.launches, vq_assign.launches) == before


def test_assign_wrapper_validates_and_never_counts_cpu():
    z = torch.zeros((2, 1, 4))
    w = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        vq_assign.vq_assign(z.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="vq_assign takes"):
        vq_assign.vq_assign(z, w[0])
    with pytest.raises(ValueError, match="float32"):
        vq_assign.vq_assign(z.double(), w.double())
    before = vq_assign.launches_assign
    vq_assign.vq_assign(z, w)
    ops.vq_assign(z[0], w[0])
    assert vq_assign.launches_assign == before
    assert set(_build.SIGNATURES) == {"vq_window_f32", "vq_window_clusters",
                                      "vq_delta_f32", "vq_assign_f32",
                                      "vq_topk_f32", "vq_delta_blocked_f32",
                                      "vq_ring_f32", "vq_argmin_launches",
                                      "vq_divergence_f32", "vq_ring_alloc",
                                      "vq_ring_free", "vq_ring_export",
                                      "vq_ring_open", "vq_ring_close",
                                      "vq_ring_step", "vq_ring_hop_f32",
                                      "vq_ring_copy_f32", "vq_ring_sync_caps",
                                      "vq_events_create", "vq_event_record",
                                      "vq_event_elapsed"}


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {"vq_window.cu",
                                                          "vq_delta.cu",
                                                          "vq_topk.cu",
                                                          "vq_blocked.cu",
                                                          "vq_ring.cu",
                                                          "vq_divergence.cu",
                                                          "vq_ring_hop.cu",
                                                          "vq_events.cu"}
    assert os.path.basename(_build.BUILD_ROOT) == ".build"


def _tie_heavy(rng, m, n):
    """Mostly exact zeros of both signs, plus repeated magnitudes of both
    signs and a few distinct values: every k below cuts through a tie."""
    x = np.zeros((m, n), np.float32)
    x[rng.random((m, n)) < 0.3] = -0.0
    for mag, share in ((0.5, 0.05), (0.25, 0.1)):
        hit = rng.random((m, n)) < share
        x[hit] = mag * rng.choice(np.array([1.0, -1.0], np.float32),
                                  int(hit.sum()))
    few = rng.random((m, n)) < 0.02
    x[few] = rng.standard_normal(int(few.sum())).astype(np.float32)
    return x


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# (M, kappa, d, k): k = 1 and k = N; N = 1155 = 3*5*7*11 has no
# power-of-two factor; M = 1 and M = 3
TOPK_CASES = [(1, 16, 8, 1), (1, 16, 8, 128), (3, 33, 35, 37),
              (3, 33, 35, 1155), (3, 24, 6, 14)]


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("m,kappa,d,k", TOPK_CASES)
def test_topk_plain_matches_reference_topk_kernel(m, kappa, d, k, tie_heavy):
    """The same kept set as the reference's top-k kernel (interpret mode),
    and vals and residual equal bit for bit once ordered by index; the
    port keeps its pairs in ascending index order."""
    rng = np.random.default_rng(7 + k)
    n = kappa * d
    full = (_tie_heavy(rng, m, n) if tie_heavy
            else rng.standard_normal((m, n)).astype(np.float32))
    vals, idx, res = vq_fused.vq_topk_plain(torch.from_numpy(full), k)
    assert vals.shape == (m, k) and idx.shape == (m, k)
    assert idx.dtype == torch.int32 and res.shape == (m, n)
    for j in range(m):
        rv, ri, rr = jfused.vq_topk_pallas(
            jnp.asarray(full[j].reshape(kappa, d)), k, interpret=True)
        ri = np.asarray(ri)
        order = np.argsort(ri)
        np.testing.assert_array_equal(idx[j].numpy(), ri[order])
        np.testing.assert_array_equal(_bits(vals[j].numpy()),
                                      _bits(np.asarray(rv)[order]))
        np.testing.assert_array_equal(_bits(res[j].numpy()),
                                      _bits(np.asarray(rr).reshape(-1)))


def test_topk_plain_breaks_ties_by_lower_index():
    """lax.top_k's order on the reference's own example: among equal |x|,
    -0.0 and +0.0 included, the lower index is kept."""
    x = torch.tensor([[0.0, .5, -.5, 0.0, .25, -.25, .5, -0.0, 0.0]])
    vals, idx, res = vq_fused.vq_topk_plain(x, 6)
    assert idx.tolist() == [[0, 1, 2, 4, 5, 6]]
    assert vals.tolist() == [[0.0, .5, -.5, .25, -.25, .5]]
    # kept entries become +0.0; the others keep their bits (-0.0 too)
    assert _bits(res.numpy()).tolist() == _bits(
        np.array([[0.0, 0, 0, 0, 0, 0, 0, -0.0, 0]], np.float32)).tolist()


def test_topk_wrapper_validates_and_never_counts_cpu():
    full = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="1 <= k"):
        vq_fused.vq_topk(full, 0)
    with pytest.raises(ValueError, match="1 <= k"):
        vq_fused.vq_topk(full, 6)
    with pytest.raises(ValueError, match="float32"):
        vq_fused.vq_topk(full.double(), 1)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        vq_fused.vq_topk(full[0], 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        vq_fused.vq_topk(full.to("meta"), 1)
    before = vq_fused.launches_topk
    got = vq_fused.vq_topk(full, 2)
    ops.vq_topk(full, 5)
    assert vq_fused.launches_topk == before
    for a, b in zip(got, vq_fused.vq_topk_plain(full, 2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 3])
def test_delta_topk_matches_reference(m):
    """ops.vq_delta_topk against the reference's (mirrors
    tests/test_autotune.py:106): the same kept set, vals and residual at
    RTOL/ATOL (zsum sums points in another order), and the port's own
    displacement + plain selection bit for bit."""
    batch, kappa, d, frac = 40, 24, 6, 0.1
    rng = np.random.default_rng(11)
    z = _mixture(rng, (m, batch), d)
    w = _mixture(rng, (m, kappa), d)
    residual = 0.01 * rng.standard_normal((m, kappa, d)).astype(np.float32)
    zt, wt, rt = (torch.from_numpy(a) for a in (z, w, residual))
    got = ops.vq_delta_topk(zt if m > 1 else zt[0], wt if m > 1 else wt[0],
                            rt if m > 1 else rt[0], frac=frac)
    vals, idx, new_res = (g if m > 1 else g[None] for g in got)
    k = max(1, int(frac * kappa * d))
    assert vals.shape == (m, k) and new_res.shape == (m, kappa, d)
    counts, zsum = ops.vq_delta(zt, wt)
    full = (counts.unsqueeze(-1) * wt - zsum + rt).reshape(m, -1)
    for a, b in zip((vals, idx, new_res.reshape(m, -1)),
                    vq_fused.vq_topk_plain(full, k)):
        assert torch.equal(a, b)
    for j in range(m):
        rv, ri, rr = jops.vq_delta_topk(jnp.asarray(z[j]), jnp.asarray(w[j]),
                                        jnp.asarray(residual[j]), frac=frac)
        ri = np.asarray(ri)
        order = np.argsort(ri)
        np.testing.assert_array_equal(idx[j].numpy(), ri[order])
        np.testing.assert_allclose(vals[j].numpy(), np.asarray(rv)[order],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(new_res[j].numpy(), np.asarray(rr),
                                   rtol=RTOL, atol=ATOL)
    # past the delta kernel's budget the blocked epilogue answers, with the
    # plain payload and selection
    zb = torch.from_numpy(_mixture(rng, (4,), 2048))
    wb = torch.from_numpy(_mixture(rng, (3,), 2048))
    rb = torch.from_numpy(
        0.01 * rng.standard_normal((3, 2048)).astype(np.float32))
    kb = max(1, int(0.1 * 3 * 2048))
    c, s, _, _ = vq_assign.vq_delta_plain(zb, wb)
    want = vq_fused.vq_topk_plain((c.unsqueeze(-1) * wb - s + rb).reshape(
        1, -1), kb)
    got = ops.vq_delta_topk(zb, wb, rb, frac=0.1)
    for a, b in zip(got, (want[0][0], want[1][0], want[2].view(3, 2048))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="residual"):
        ops.vq_delta_topk(zt[0], wt[0], rt[0, :3], frac=frac)
