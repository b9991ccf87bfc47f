"""The port's ``core/vq.py`` held against ``repro.core.vq``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: ``rtol=1e-4, atol=1e-6`` (what the reference holds its own mesh
to against its oracles), assignments equal, the step schedule bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vq as jvq
from repro_torch.core import vq

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _mixture(rng, shape, d, n_centers=10, noise=0.05):
    """Points of shape ``shape + (d,)`` from a uniform-center mixture."""
    centers = rng.random((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=shape)
    eps = noise * rng.standard_normal(shape + (d,)).astype(np.float32)
    return (centers[assign] + eps).astype(np.float32)


def _zw(seed, batch, kappa, d):
    rng = np.random.default_rng(seed)
    z = _mixture(rng, (batch,), d)
    w = _mixture(rng, (kappa,), d)
    return z, w


@pytest.mark.parametrize("batch,kappa,d", [(5, 16, 8), (37, 64, 16)])
def test_squared_distances_and_nearest_match_reference(batch, kappa, d):
    z, w = _zw(0, batch, kappa, d)
    ours = vq.squared_distances(torch.from_numpy(z), torch.from_numpy(w))
    ref = jvq.squared_distances(jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    idx = vq.nearest(torch.from_numpy(z), torch.from_numpy(w))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jvq.nearest(z, w)))


def test_H_touches_only_the_winner_and_matches_reference():
    z, w = _zw(1, 12, 16, 8)
    for b in range(z.shape[0]):
        h = vq.H(torch.from_numpy(z[b]), torch.from_numpy(w))
        nonzero = torch.nonzero(h.abs().sum(dim=1)).flatten().tolist()
        win = int(vq.nearest(torch.from_numpy(z[b:b + 1]),
                             torch.from_numpy(w))[0])
        assert nonzero == [win]
        np.testing.assert_allclose(h.numpy(), np.asarray(jvq.H(z[b], w)),
                                   rtol=RTOL, atol=ATOL)


def test_H_batch_and_distortions_match_reference():
    rng = np.random.default_rng(2)
    z = _mixture(rng, (8, 50), 8)
    w = _mixture(rng, (16,), 8)
    zt, wt = torch.from_numpy(z), torch.from_numpy(w)
    np.testing.assert_allclose(vq.H_batch(zt[0], wt).numpy(),
                               np.asarray(jvq.H_batch(z[0], w)),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(vq.distortion(zt[0], wt)),
                               float(jvq.distortion(z[0], w)), rtol=RTOL)
    np.testing.assert_allclose(float(vq.distortion_multi(zt, wt)),
                               float(jvq.distortion_multi(z, w)), rtol=RTOL)
    # the stacked form is the per-worker form, one worker at a time
    per = torch.stack([vq.distortion(zt[i], wt) for i in range(8)])
    np.testing.assert_allclose(vq.distortion(zt, wt).numpy(), per.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eps0,decay", [(0.5, 1.0), (0.3, 0.1)])
def test_default_steps_bitwise(eps0, decay):
    t = np.arange(0, 5000, dtype=np.int32)
    ours = vq.default_steps(torch.from_numpy(t), eps0=eps0, decay=decay)
    ref = jvq.default_steps(jnp.asarray(t), eps0=eps0, decay=decay)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t0", [0, 37])
def test_vq_run_and_window_displacement_match_reference(t0):
    rng = np.random.default_rng(3)
    data = _mixture(rng, (120,), 8)
    w0 = _mixture(rng, (16,), 8)
    ours = vq.vq_run(torch.from_numpy(w0), torch.from_numpy(data), t0=t0)
    ref = jvq.vq_run(jnp.asarray(w0), jnp.asarray(data), t0=t0)
    assert ours.t == int(ref.t) == t0 + 120
    np.testing.assert_allclose(ours.w.numpy(), np.asarray(ref.w), rtol=RTOL,
                               atol=ATOL)
    delta, w_fin = vq.window_displacement(torch.from_numpy(w0),
                                          torch.from_numpy(data[:10]), t0)
    rdelta, rw = jvq.window_displacement(jnp.asarray(w0),
                                         jnp.asarray(data[:10]),
                                         jnp.asarray(t0, jnp.int32))
    np.testing.assert_allclose(delta.numpy(), np.asarray(rdelta), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(w_fin.numpy(), np.asarray(rw), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(w_fin, torch.from_numpy(w0) - delta,
                               rtol=0, atol=0)


def test_vq_run_stacked_workers_match_reference_per_worker():
    rng = np.random.default_rng(4)
    data = _mixture(rng, (8, 40), 8)
    w0 = _mixture(rng, (16,), 8)
    ours = vq.vq_run(torch.from_numpy(w0), torch.from_numpy(data), t0=5)
    assert ours.w.shape == (8, 16, 8)
    for i in range(8):
        ref = jvq.vq_run(jnp.asarray(w0), jnp.asarray(data[i]), t0=5)
        np.testing.assert_allclose(ours.w[i].numpy(), np.asarray(ref.w),
                                   rtol=RTOL, atol=ATOL)
