"""The port's blocked assign+delta route held against the reference.

On the CPU the blocked kernel's wrapper takes its plain version
(``vq_fused.vq_delta_blocked_plain``); ``chip_smoke.py`` holds the CUDA
kernel against it, and against the delta kernel bit for bit, on the card.
The reference's blocked Pallas kernel runs in interpret mode, as its own
tests run it.  Tolerances: assignments equal and counts exact; zsum and the
epilogue's delta at ``rtol=1e-5, atol=1e-6`` (the reference sums a block's
points with a one-hot matmul, the port one point at a time); the mesh run
at the reference's own fused-vs-routed bar, ``rtol=1e-5, atol=1e-7``.
Mirrors ``tests/test_kernels.py:92-138`` and ``tests/test_comm.py:279-302``.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import GeometricDelayNetwork as JGeometric
from repro.engine import InstantNetwork as JInstant
from repro.engine import MeshExecutor as JMeshExecutor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import vq_fused as jfused
from repro_torch import interop
from repro_torch.core import async_vq
from repro_torch.engine import GeometricDelayNetwork, InstantNetwork
from repro_torch.engine.mesh import MeshExecutor
from repro_torch.kernels import autotune, ops, vq_assign, vq_fused
from repro_torch.launch import train

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TAU = 10


def _mixture(rng, shape, d, n_centers=10, noise=0.05):
    centers = rng.random((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=shape)
    eps = noise * rng.standard_normal(shape + (d,)).astype(np.float32)
    return (centers[assign] + eps).astype(np.float32)


def _inputs(seed, batch, kappa, d, m=None):
    rng = np.random.default_rng(seed)
    lead = () if m is None else (m,)
    z = _mixture(rng, lead + (batch,), d)
    w = _mixture(rng, lead + (kappa,), d)
    res = 0.01 * rng.standard_normal(lead + (kappa, d)).astype(np.float32)
    return z, w, res


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("batch,kappa,d,bm,bk", [(64, 96, 16, 16, 32),
                                                (32, 64, 40, 8, 64)])
def test_blocked_plain_matches_reference_blocked_kernel(batch, kappa, d, bm,
                                                        bk, with_residual):
    """The reference's two-sweep kernel itself (interpret mode) on shapes
    its tiles divide: the same assignments, exact counts, zsum and delta
    within RTOL/ATOL, min distances within RTOL."""
    z, w, res = _inputs(batch + kappa, batch, kappa, d)
    ref_out = jfused.vq_delta_blocked_pallas(
        jnp.asarray(z), jnp.asarray(w), bm=bm, bk=bk,
        residual=jnp.asarray(res) if with_residual else None,
        interpret=True)
    got = vq_fused.vq_delta_blocked_plain(
        torch.from_numpy(z), torch.from_numpy(w),
        torch.from_numpy(res) if with_residual else None)
    counts, zsum, mind, assign = got[:4]
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ref_out[0]))
    np.testing.assert_allclose(mind.numpy(), np.asarray(ref_out[1]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_out[2]))
    np.testing.assert_allclose(zsum.numpy(), np.asarray(ref_out[3]),
                               rtol=RTOL, atol=ATOL)
    assert len(got) == (5 if with_residual else 4)
    if with_residual:
        np.testing.assert_allclose(got[4].numpy(), np.asarray(ref_out[4]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("batch,kappa,d", [(100, 200, 16), (7, 33, 5),
                                           (1, 130, 24)])
def test_ops_blocked_matches_reference_ops_on_ragged_shapes(batch, kappa, d,
                                                            with_residual):
    """``ops.vq_delta_blocked`` against the reference's, which pads to its
    tiles: exact counts, zsum and delta within RTOL/ATOL, and the
    wrapper's assignments equal to the reference's assign kernel."""
    z, w, res = _inputs(7 * batch + d, batch, kappa, d)
    zt, wt, rt = (torch.from_numpy(a) for a in (z, w, res))
    r = rt if with_residual else None
    got = ops.vq_delta_blocked(zt, wt, residual=r)
    want = jops.vq_delta_blocked(jnp.asarray(z), jnp.asarray(w),
                                 residual=jnp.asarray(res) if with_residual
                                 else None)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, h in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=RTOL,
                                   atol=ATOL)
    _, _, _, assign = vq_fused.vq_delta_blocked(zt, wt, residual=r)[:4]
    ja, _ = jops.vq_assign(jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))


def test_blocked_wrapper_is_the_plain_version_on_cpu():
    """Stacked workers equal the 2-D form worker by worker; CPU calls are
    the plain version and count no launch; the epilogue is the eager
    expression bit for bit; inputs are validated."""
    z, w, res = _inputs(5, 9, 20, 12, m=3)
    zt, wt, rt = (torch.from_numpy(a) for a in (z, w, res))
    before = vq_fused.launches_blocked
    counts, zsum, mind, assign, delta = vq_fused.vq_delta_blocked(
        zt, wt, residual=rt, kchunk=4, bk=3)
    assert vq_fused.launches_blocked == before
    assert torch.equal(delta, counts.unsqueeze(-1) * wt - zsum + rt)
    for i in range(3):
        one = vq_fused.vq_delta_blocked(zt[i], wt[i])
        for a, b in zip(one, (counts[i], zsum[i], mind[i], assign[i])):
            assert torch.equal(a, b)
    plain = vq_assign.vq_delta_plain(zt, wt)
    for a, b in zip((counts, zsum, mind, assign), plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="residual"):
        vq_fused.vq_delta_blocked(zt, wt, residual=rt[:, :3])
    with pytest.raises(ValueError, match="residual"):
        vq_fused.vq_delta_blocked(zt, wt, residual=rt.double())
    with pytest.raises(ValueError, match="cuda or cpu"):
        vq_fused.vq_delta_blocked(zt.to("meta"), wt.to("meta"))
    with pytest.raises(ValueError, match="vq_delta_blocked takes"):
        vq_fused.vq_delta_blocked(zt, wt[0])


def test_routing_helpers():
    """Mirrors the reference's ``test_vmem_budget_routing``: explicit >
    env > default, the router's one cost model, and the route at the delta
    kernel's edge, d = 1,807 / 1,808."""
    assert ops.smem_budget_bytes() == ops.DEFAULT_SMEM_BUDGET_BYTES == 232_448
    assert ops.smem_budget_bytes(1234) == 1234
    for bad in (0, -5):
        with pytest.raises(ValueError):
            ops.smem_budget_bytes(bad)
    assert ops.delta_smem_bytes(4096, 1807) == 232_448
    assert ops.delta_route(1807) == "full"
    assert ops.delta_route(1808) == "blocked"
    assert ops.delta_route(1808, fused=False) == "via_assign"
    assert ops.delta_route(1807, fused=False) == "full"
    assert ops.delta_route(8, budget_bytes=1024) == "blocked"
    assert not ops.window_fits(16, 8, budget_bytes=64)
    # the blocked kernel's shared memory does not grow with d past the
    # argmin engine's staging: 8 points staged up to d = 7,232, read in
    # place past it; the tiled route's tiles (a ring of 4 stages of 16
    # rows and 32 point rows) do not depend on d past 128
    tiled = 4 * (4 * 16 * 128 + 4 * 32 * 128) + 1024
    assert (ops.delta_smem_bytes(4096, 3072, bk=32)
            == vq_assign.argmin_smem_bytes(3072) == tiled)
    assert ops.delta_smem_bytes(4096, 7232, bk=32) == 232_448
    assert ops.delta_smem_bytes(4096, 100_000, bk=32) == tiled
    assert (ops.delta_smem_bytes(4096, 128, bk=64)
            > ops.delta_smem_bytes(4096, 128, bk=32))
    assert ops.delta_smem_bytes(16, 128, bk=64) == ops.delta_smem_bytes(
        16, 128, bk=16)


def test_smem_budget_env(monkeypatch):
    monkeypatch.setenv("REPRO_SMEM_BUDGET_BYTES", "1024")
    assert ops.smem_budget_bytes() == 1024
    assert ops.smem_budget_bytes(4096) == 4096
    assert ops.delta_route(8) == "blocked"
    monkeypatch.setenv("REPRO_SMEM_BUDGET_BYTES", "0")
    with pytest.raises(ValueError):
        ops.smem_budget_bytes()


@pytest.mark.parametrize("batch,kappa,d", [(100, 200, 16), (64, 300, 8)])
def test_routed_blocked_parity(batch, kappa, d):
    """Mirrors ``test_vq_delta_routed_blocked_parity_kappa_gt_bk``: a tiny
    budget takes the blocked route, the default the full kernel, and the
    fused=False comparator the assign kernel + index_add_; all equal the
    reference oracle (counts exact), and each other bit for bit here."""
    rng = np.random.default_rng(batch * kappa)
    z = rng.standard_normal((batch, d)).astype(np.float32)
    w = rng.standard_normal((kappa, d)).astype(np.float32)
    zt, wt = torch.from_numpy(z), torch.from_numpy(w)
    cr, sr = jref.vq_delta_ref(jnp.asarray(z), jnp.asarray(w))
    outs = [ops.vq_delta_routed(zt, wt),
            ops.vq_delta_routed(zt, wt, budget_bytes=1024),
            ops.vq_delta_routed(zt, wt, budget_bytes=1024, fused=False)]
    for c, s in outs:
        np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0], outs[2][0])


def test_delta_via_assign_stacked_matches_plain():
    """The comparator with a worker dimension: rows offset per worker."""
    z, w, _ = _inputs(3, 6, 11, 7, m=4)
    zt, wt = torch.from_numpy(z), torch.from_numpy(w)
    counts, zsum = ops.vq_delta_routed(zt, wt, budget_bytes=64, fused=False)
    pc, pz, _, _ = vq_assign.vq_delta_plain(zt, wt)
    assert counts.shape == (4, 11) and zsum.shape == (4, 11, 7)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(zsum, pz, rtol=1e-6, atol=1e-7)


def test_minibatch_step_reduces_distortion_and_matches_reference():
    """Mirrors ``test_minibatch_step_reduces_distortion``, through the
    blocked route (tiny budget) and the full one, against the reference's
    ``vq_minibatch_step``."""
    rng = np.random.default_rng(3)
    data = _mixture(rng, (2048,), 16, n_centers=8)
    w0 = data[rng.choice(2048, 32, replace=False)].copy()
    d0 = float(jref.distortion_ref(jnp.asarray(data), jnp.asarray(w0)))
    jw = jnp.asarray(w0)
    ws = {b: torch.from_numpy(w0) for b in (None, 1024)}
    for i in range(8):
        batch = data[i * 256:(i + 1) * 256]
        jw = jops.vq_minibatch_step(jnp.asarray(batch), jw, jnp.asarray(0.5))
        for b in ws:
            ws[b] = ops.vq_minibatch_step(torch.from_numpy(batch), ws[b],
                                          torch.tensor(0.5), budget_bytes=b)
    assert torch.equal(ws[None], ws[1024])
    np.testing.assert_allclose(ws[None].numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-6)
    d1 = float(jref.distortion_ref(jnp.asarray(data), jnp.asarray(
        ws[None].numpy())))
    assert d1 < d0


def _setup(m, n=200, d=8, kappa=16, seed=42, n_eval=100):
    rng = np.random.default_rng(seed)
    data = _mixture(rng, (m, n), d)
    w0 = data.reshape(-1, d)[rng.choice(m * n, kappa, replace=False)].copy()
    return w0, data, data[:, :n_eval].copy()


def test_mesh_tiny_budget_matches_reference_routed_mesh():
    """Mirrors ``tests/test_comm.py:279-302`` at kappa=192: a tiny
    ``smem_budget_bytes`` sends the port's sync loop through the blocked
    route; it equals the port's window route bit for bit here, and the
    reference mesh with ``vmem_budget_bytes=1024`` at the reference's own
    fused-vs-routed bar."""
    w0, data, eval_data = _setup(1, kappa=192)
    ins = interop.from_reference(w0, data, eval_data, device="cpu")
    # the window kernel holds 304 B at kappa=192, d=8: 256 B fits neither
    assert not ops.window_fits(192, 8, budget_bytes=256)
    assert ops.delta_route(8, budget_bytes=256) == "blocked"
    routed = MeshExecutor(InstantNetwork(), smem_budget_bytes=256,
                          device="cpu").run("delta", *ins, tau=TAU)
    fused = MeshExecutor(InstantNetwork(), device="cpu").run(
        "delta", *ins, tau=TAU)
    assert torch.equal(routed.w_shared, fused.w_shared)
    assert torch.equal(routed.distortion, fused.distortion)
    theirs = JMeshExecutor(network=JInstant(), vmem_budget_bytes=1024).run(
        "delta", jnp.asarray(w0), jnp.asarray(data), jnp.asarray(eval_data),
        tau=TAU)
    np.testing.assert_allclose(routed.distortion.numpy(),
                               np.asarray(theirs.distortion), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(routed.w_shared.numpy(),
                               np.asarray(theirs.w_shared), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_async_mesh_past_the_delta_budget_matches_scheme_async(monkeypatch,
                                                               fused):
    """Eq. 9 at d = 2,048, past the delta kernel's shared memory: one
    blocked step per tick (``fused=False``: the assign + index_add_
    comparator instead), on the reference's round lengths, equal to the
    port's oracle ``scheme_async`` bit for bit."""
    m, n, d = 4, 60, 2048
    w0, data, eval_data = _setup(m, n=n, d=d, kappa=12, n_eval=20)
    key = jax.random.fold_in(jax.random.PRNGKey(42), 9)
    lengths = interop.lengths_from_reference(
        JGeometric(0.5).round_lengths(key, m, n // TAU + 2, TAU))
    ins = interop.from_reference(w0, data, eval_data, device="cpu")
    calls = {"blocked": 0, "via_assign": 0}
    real_blocked = vq_fused.vq_delta_blocked_plain
    real_via = ops._delta_via_assign

    def blocked(*a):
        calls["blocked"] += 1
        return real_blocked(*a)

    def via_assign(*a):
        calls["via_assign"] += 1
        return real_via(*a)

    monkeypatch.setattr(vq_fused, "vq_delta_blocked_plain", blocked)
    monkeypatch.setattr(ops, "_delta_via_assign", via_assign)
    got = MeshExecutor(GeometricDelayNetwork(0.5), fused=fused,
                       device="cpu").run("async_delta", *ins, tau=TAU,
                                         lengths=lengths)
    monkeypatch.undo()
    assert calls == ({"blocked": n, "via_assign": 0} if fused
                     else {"blocked": 0, "via_assign": n})
    want = async_vq.scheme_async(*ins, tau=TAU, lengths=lengths)
    assert torch.equal(got.wall_ticks, want.wall_ticks)
    assert torch.equal(got.distortion, want.distortion)
    assert torch.equal(got.w_shared, want.w_shared)


def test_launch_train_wide_codebook_on_cpu():
    """The launcher at a width past the delta kernel's budget, with the
    tuner's flags."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = train.main(["--mode", "vq", "--executor", "mesh",
                             "--scheme", "async_delta", "--network",
                             "geometric", "--workers", "2", "--points", "40",
                             "--dim", "2048", "--kappa", "8", "--autotune",
                             "off", "--device", "cpu"])
        assert autotune.get_mode() == "off"
    finally:
        autotune.reset("cache")
    text = out.getvalue()
    assert rc == 0
    assert "d=2048 kappa=8" in text and "done: C(final)=" in text
    assert ops.delta_route(2048) == "blocked"
