"""``core/dvq.py``'s steps, stacked and over a process group, held against
``repro.core.dvq`` and the unsharded step.

The reference's ``test_dvq_window_matches_scheme_delta``
(``tests/test_distributed.py:245-262``) runs here on both packages, stacked
and in a 4-rank gloo world (``_torch_worlds.dvq_steps``), against
``repro.core.dvq.make_window_vq_step`` at ``rtol=1e-5, atol=1e-6``.  The
minibatch step over model 2 x data 2 ranks must give the unsharded step's
assignments and counts exactly; ``run_minibatch_vq`` must match the
reference's at the cross-framework tolerance and bring the distortion down,
as ``tests/test_distributed.py:265-284`` asks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.core import dvq as jdvq
from repro.core import schemes as jschemes
from repro_torch import comm
from repro_torch.core import dvq, vq
from repro_torch.distributed import process_group

torch.set_num_threads(1)

M, TAU, D, KAPPA = 4, 10, 6, 8
RTOL, ATOL = 1e-5, 1e-6


def _inputs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    centers = rng.random((5, D)).astype(f32)
    zwin = (centers[rng.integers(0, 5, (M, TAU))]
            + 0.05 * rng.standard_normal((M, TAU, D))).astype(f32)
    zwin2 = (centers[rng.integers(0, 5, (M, TAU))]
             + 0.05 * rng.standard_normal((M, TAU, D))).astype(f32)
    w = zwin.reshape(-1, D)[rng.choice(M * TAU, KAPPA, replace=False)].copy()
    z = (centers[rng.integers(0, 5, 64)]
         + 0.05 * rng.standard_normal((64, D))).astype(f32)
    return {"w": w, "zwin": zwin, "zwin2": zwin2, "z": z}


@pytest.fixture(scope="module")
def world():
    ins = _inputs()
    return ins, process_group.spawn(worlds.dvq_steps, 4, ins, device="cpu")


def _ref_window(ins):
    step = jax.jit(jdvq.make_window_vq_step(tau=TAU))
    w1, t1 = step(jnp.asarray(ins["w"]), jnp.asarray(7, jnp.int32),
                  jnp.asarray(ins["zwin"]))
    w2, t2 = step(w1, t1, jnp.asarray(ins["zwin2"]))
    return np.asarray(w1), np.asarray(w2), int(t2)


def test_dvq_window_matches_scheme_delta():
    """The reference's test on the port: one window equals the simulated S2
    scheme, here ``core.schemes.scheme_delta`` on both packages."""
    from repro_torch.core import schemes
    ins = _inputs()
    w0, data = ins["w"], ins["zwin"]
    ref = jschemes.scheme_delta(jnp.asarray(w0), jnp.asarray(data),
                                jnp.asarray(data), tau=TAU)
    mine = schemes.scheme_delta(torch.from_numpy(w0), torch.from_numpy(data),
                                torch.from_numpy(data), tau=TAU)
    step = dvq.make_window_vq_step(tau=TAU)
    w_new, t = step(torch.from_numpy(w0), 0, torch.from_numpy(data))
    np.testing.assert_allclose(w_new.numpy(), np.asarray(ref.w_shared),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w_new.numpy(), mine.w_shared.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert t == TAU


@pytest.mark.parametrize("transport", ["xla", "ring"])
def test_stacked_window_step_matches_reference(transport):
    ins = _inputs()
    want = _ref_window(ins)
    step = dvq.make_window_vq_step(tau=TAU, transport=transport)
    w1, t1 = step(torch.from_numpy(ins["w"]), 7, torch.from_numpy(ins["zwin"]))
    w2, t2 = step(w1, t1, torch.from_numpy(ins["zwin2"]))
    np.testing.assert_allclose(w1.numpy(), want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w2.numpy(), want[1], rtol=RTOL, atol=ATOL)
    assert t2 == want[2] == 27
    # the plain scan gives the same codebook
    plain = dvq.make_window_vq_step(tau=TAU, transport=transport,
                                    use_kernel=False)
    w1p, _ = plain(torch.from_numpy(ins["w"]), 7,
                   torch.from_numpy(ins["zwin"]))
    np.testing.assert_allclose(w1p.numpy(), w1.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("transport", ["xla", "ring"])
def test_group_window_step_matches_reference_and_stacked(world, transport):
    ins, outs = world
    want = _ref_window(ins)
    step = dvq.make_window_vq_step(tau=TAU, transport=transport)
    s1, t1 = step(torch.from_numpy(ins["w"]), 7, torch.from_numpy(ins["zwin"]))
    s2, _ = step(s1, t1, torch.from_numpy(ins["zwin2"]))
    for r in range(4):
        w1, w2, t2, records = outs[r][f"window_{transport}"]
        np.testing.assert_allclose(w1, want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(w2, want[1], rtol=RTOL, atol=ATOL)
        assert t2 == 27
        assert records == step.transport.log.records
        if transport == "ring":     # the group ring keeps the stacked fold
            np.testing.assert_array_equal(w1, s1.numpy())
            np.testing.assert_array_equal(w2, s2.numpy())


def test_kappa_sharded_minibatch_equals_unsharded(world):
    ins, outs = world
    w, z = torch.from_numpy(ins["w"]), torch.from_numpy(ins["z"])
    full = dvq.make_minibatch_vq_step()
    counts, zsum, assign = full.stats(w, z)
    w_full, t = full(w, 3, z)
    ref_w, _ = jdvq.make_minibatch_vq_step()(
        jnp.asarray(ins["w"]), jnp.asarray(3, jnp.int32), jnp.asarray(ins["z"]))
    np.testing.assert_allclose(w_full.numpy(), np.asarray(ref_w), rtol=RTOL,
                               atol=ATOL)
    k_local, rows = KAPPA // 2, 32
    for r in range(4):
        di, mi, c, zs, a, w_new, t_new = outs[r]["minibatch"]
        own = slice(mi * k_local, (mi + 1) * k_local)
        np.testing.assert_array_equal(a, assign[di * rows:(di + 1) * rows])
        np.testing.assert_array_equal(c, counts[own].numpy())   # exact
        np.testing.assert_allclose(zs, zsum[own].numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(w_new, w_full[own].numpy(), rtol=RTOL,
                                   atol=ATOL)
        assert t_new == t == 4


@pytest.mark.parametrize("use_kernel", [True, False])
def test_minibatch_step_matches_reference(use_kernel):
    ins = _inputs()
    step = dvq.make_minibatch_vq_step(use_kernel=use_kernel)
    w, t = step(torch.from_numpy(ins["w"]), 0, torch.from_numpy(ins["z"]))
    want, _ = jdvq.make_minibatch_vq_step(use_kernel=False)(
        jnp.asarray(ins["w"]), jnp.asarray(0, jnp.int32),
        jnp.asarray(ins["z"]))
    np.testing.assert_allclose(w.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert t == 1


def test_run_minibatch_vq_matches_reference_and_reduces_distortion():
    rng = np.random.default_rng(2)
    n_steps, batch, d, kappa = 20, 256, 16, 32
    centers = rng.random((12, d)).astype(np.float32)
    stream = (centers[rng.integers(0, 12, n_steps * batch)]
              + 0.05 * rng.standard_normal((n_steps * batch, d))
              ).astype(np.float32)
    data = stream.reshape(n_steps, batch, d)
    w0 = stream[rng.choice(len(stream), kappa, replace=False)].copy()
    w_final, trace = dvq.run_minibatch_vq(torch.from_numpy(w0),
                                          torch.from_numpy(data),
                                          steps=n_steps)
    jw, jtrace = jdvq.run_minibatch_vq(jnp.asarray(w0), jnp.asarray(data),
                                       steps=n_steps)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(w_final.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-6)
    assert float(trace[-1]) < float(trace[0])
    before = float(vq.distortion(torch.from_numpy(stream), torch.from_numpy(w0)))
    after = float(vq.distortion(torch.from_numpy(stream), w_final))
    assert after < before
    with pytest.raises(ValueError, match="steps=3"):
        dvq.run_minibatch_vq(torch.from_numpy(w0), torch.from_numpy(data),
                             steps=3)


@pytest.mark.parametrize("layout,batch,want", [
    ({"data": 4, "model": 2}, 256, {"w": ("model", None),
                                    "z": (("data",), None)}),
    ({"pod": 2, "data": 16, "model": 16}, 1 << 20,
     {"w": ("model", None), "z": (("pod", "data"), None)}),
    ({"data": 4, "model": 3}, 250, {"w": (None, None), "z": (None, None)}),
    ({"workers": 4}, 8, {"w": (None, None), "z": (None, None)})])
def test_vq_layout_matches_reference_shardings(layout, batch, want):
    assert dvq.vq_layout(layout, kappa=32, d=16, batch=batch) == want


def test_window_step_records_one_dense_reduce():
    ins = _inputs()
    step = dvq.make_window_vq_step(tau=TAU)
    step(torch.from_numpy(ins["w"]), 0, torch.from_numpy(ins["zwin"]))
    (rec,) = step.transport.log.records
    assert rec.participants == M and rec.logical_bytes == 4 * KAPPA * D
    assert rec.wire_bytes == comm.ring_wire_bytes(4 * KAPPA * D, M)
