"""The port's LM window step held against ``repro.training.steps`` on the
CPU.

The reference runs its window step on a (2, 1, 1) mesh, one replica a pod;
the port runs the two replicas stacked.  Both start from the reference's
params (``interop.params_from_reference``) and take the same numpy tokens
for 2 windows of tau = 2 SGD steps, for each ``Merge``:

  * with one batch tiled over both replicas, as ``tests/test_distributed.py``
    feeds the reference, and with a different batch on each replica: each
    replica's params, ``opt_state``, ``delta_prev`` and ``residual`` (the
    port's row i, the reference's device i) and the loss at ``rtol=1e-4,
    atol=1e-5``;
  * every ``CommRecord`` of a window (op, participants, logical and wire
    bytes, calls, tag) equal to the reference's, over a dense transport and
    over a sparse one.

The reference returns its state with ``out_specs=P()`` under
``check_vma=False``: each device keeps its own replica's leaves for the
next window, and the host reads device 0's.  Pinned here: the host's read
is replica 0's, the next window starts from each replica's own, and a
state taken through the host (every replica then holds replica 0's) gives
the port's run from ``replica(state, 0)`` expanded.

Then the port's own contracts, under SGD as the reference's tests run
them: AVERAGE over replicas fed the same batch == the sequential steps,
bit for bit; DELTA applies M times the displacement; DELTA_SPARSE at frac
1.0 == DELTA bit for bit; at a low frac it leaves a residual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.optim import optimizers as joptim
from repro.training import steps as jsteps
from repro_torch import comm, interop
from repro_torch.configs import registry
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
from repro_torch.training import steps

torch.set_num_threads(1)

ARCH = "granite_8b"
TAU, B, T, M = 2, 4, 8, 2
LR = 0.05
RTOL, ATOL = 1e-4, 1e-5
MERGES = ["allreduce", "average", "delta", "async_delta", "delta_sparse"]
SPARSE_FRAC = 0.05


def _tokens(seed: int, tiled: bool) -> dict:
    """(tau, M * B, T) tokens and labels: one batch tiled over both
    replicas, or a batch each."""
    rng = np.random.default_rng(seed)
    vocab = registry.get_smoke_config(ARCH).vocab
    rows = B if tiled else M * B
    toks = rng.integers(0, vocab, (TAU, rows, T)).astype(np.int32)
    if tiled:
        toks = np.concatenate([toks] * M, axis=1)
    return {"tokens": toks, "labels": toks}


@pytest.fixture(scope="module")
def ref():
    jcommon.set_run_options(mesh=None)
    return {"jcfg": jreg.get_smoke_config(ARCH),
            "tcfg": registry.get_smoke_config(ARCH),
            "mesh": jax.make_mesh((M, 1, 1), ("pod", "data", "model")),
            "jitted": {}}


def _transports(kind: str):
    if kind == "sparse":
        return (jcomm.get_transport("sparse", frac=SPARSE_FRAC),
                comm.get_transport("sparse", frac=SPARSE_FRAC))
    return jcomm.get_transport("xla"), comm.get_transport("xla")


def _records(log_records) -> list:
    return [(r.op, r.participants, r.logical_bytes, r.wire_bytes, r.calls,
             r.tag) for r in log_records]


def _host_round_trip(state):
    """The reference's state as a host read hands it back: device 0's."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)


def _collapse(state):
    """The port's counterpart: every replica takes replica 0's leaves."""
    return _expand(steps.replica(state, 0))


def _expand(tree):
    """Every leaf held once, expanded over the M replicas."""
    return tree_unflatten(tree, [x.expand(M, *x.shape)
                                 for x in tree_leaves(tree)])


def _run_both(ref, merge_name: str, kind: str, tiled: bool,
              collapse: bool = False):
    """Two windows in each package (with ``collapse``, the state taken
    through the host between them); returns (ref states, port states, ref
    losses, port losses, ref records of one trace, port records of each
    window)."""
    merge = getattr(steps.Merge, merge_name.upper())
    jmerge = getattr(jsteps.Merge, merge_name.upper())
    jt, tt = _transports(kind)
    jopt, topt = joptim.sgd(LR), optimizers.sgd(LR)
    # one jitted reference a (merge, transport) per module: its records
    # are appended once, when it traces
    if (merge_name, kind) not in ref["jitted"]:
        ref["jitted"][merge_name, kind] = [jax.jit(jsteps.make_window_step(
            ref["jcfg"], jopt, ref["mesh"], tau=TAU, merge=jmerge,
            merge_axis="pod", compress_frac=SPARSE_FRAC, transport=jt)),
            jt, None]
    jitted = ref["jitted"][merge_name, kind]
    jstep, jt = jitted[0], jitted[1]
    tstep = steps.make_window_step(
        ref["tcfg"], topt, workers=M, tau=TAU, merge=merge,
        compress_frac=SPARSE_FRAC, transport=tt)
    jstate = jsteps.init_window_state(ref["jcfg"], jopt,
                                      jax.random.PRNGKey(0), jmerge,
                                      transport=jt)
    tstate = steps.init_window_state(ref["tcfg"], topt, 0, merge,
                                     transport=tt, workers=M, device="cpu")
    tstate["params"] = _expand(interop.params_from_reference(
        jstate["params"], ref["tcfg"], device="cpu"))
    jouts, touts, jloss, tloss, trecs = [], [], [], [], []
    with ref["mesh"]:
        for w in range(2):
            if w and collapse:
                jstate, tstate = _host_round_trip(jstate), _collapse(tstate)
            toks = _tokens(10 * w + (1 if tiled else 2), tiled)
            n_before = len(jt.log.records)
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in toks.items()})
            if jitted[2] is None:
                jitted[2] = _records(jt.log.records[n_before:])
            mark = len(tt.log.records)
            tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                        for k, v in toks.items()})
            trecs.append(_records(tt.log.records[mark:]))
            jouts.append(jstate)
            touts.append(tstate)
            jloss.append(float(jm["loss"]))
            tloss.append(float(tm["loss"]))
    return jouts, touts, jloss, tloss, jitted[2], trecs


def _device_rows(ref, x, i: int) -> np.ndarray:
    """The reference leaf as pod i's device holds it."""
    dev = ref["mesh"].devices.ravel()[i]
    (data,) = [np.asarray(s.data, np.float32) for s in x.addressable_shards
               if s.device == dev]
    return data


def _close(ref, got, want, what: str) -> None:
    """Each replica's leaves (the port's rows) against the reference's on
    that replica's device."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i in range(M):
        for j, (a, b) in enumerate(zip(g, w)):
            a = a[i].detach().float().numpy()
            b = _device_rows(ref, b, i)
            assert a.shape == b.shape, (what, i, j)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} replica {i} leaf {j}")


def _check(ref, run) -> None:
    jouts, touts, jloss, tloss, jrecs, trecs = run
    for w, (js, ts) in enumerate(zip(jouts, touts)):
        assert sorted(ts) == sorted(js)
        for key in sorted(js):
            _close(ref, ts[key], js[key], f"window {w} {key}")
        assert torch.equal(ts["step"], torch.full((M,), TAU * (w + 1),
                                                  dtype=torch.int32))
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=ATOL)
    assert trecs[0] == trecs[1] == jrecs


@pytest.mark.devices(2)
@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "per-replica"])
@pytest.mark.parametrize("merge", MERGES)
def test_window_step_equals_reference(ref, merge, tiled):
    kind = "sparse" if merge == "delta_sparse" else "xla"
    _check(ref, _run_both(ref, merge, kind, tiled))


@pytest.mark.devices(2)
def test_async_delta_over_sparse_transport_equals_reference(ref):
    """ASYNC_DELTA over a stateful transport: the {"own", "comm"} carry."""
    run = _run_both(ref, "async_delta", "sparse", tiled=False)
    _check(ref, run)
    assert sorted(run[1][-1]["delta_prev"]) == ["comm", "own"]
    assert run[4][0][0] == "sum" and run[4][0][3] > 0


@pytest.mark.devices(2)
@pytest.mark.parametrize("merge", ["async_delta", "delta_sparse"])
def test_host_read_is_replica_0_and_devices_keep_their_own(ref, merge):
    """The reference's state reads on the host as replica 0's, while the
    replicas' carries differ (the port's rows, the reference's devices);
    taken through the host, every replica starts the next window from
    replica 0's, and the port's run from ``replica(state, 0)`` agrees.
    The two next windows part (the carry matters)."""
    kind = "sparse" if merge == "delta_sparse" else "xla"
    kept = _run_both(ref, merge, kind, tiled=False)
    key = "residual" if merge == "delta_sparse" else "delta_prev"
    j0, t0 = kept[0][0][key], kept[1][0][key]
    for a, b in zip(jax.tree.leaves(j0), tree_leaves(t0)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      _device_rows(ref, a, 0))
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   b[0].numpy(), rtol=RTOL, atol=ATOL)
    assert any(not torch.equal(b[0], b[1]) for b in tree_leaves(t0))
    collapsed = _run_both(ref, merge, kind, tiled=False, collapse=True)
    _check(ref, collapsed)
    gap = max(float((a[0] - b[0]).abs().max()) for a, b in zip(
        tree_leaves(kept[1][1]["params"]),
        tree_leaves(collapsed[1][1]["params"])))
    assert gap > 1e-4


@pytest.mark.devices(2)
def test_allreduce_from_per_replica_state_equals_reference(ref):
    """An ALLREDUCE window from a state whose replicas differ (after an
    ASYNC_DELTA window): each replica steps its own params with the mean
    grads, on the devices as in the port's rows."""
    jt, tt = _transports("xla")
    jopt, topt = joptim.sgd(LR), optimizers.sgd(LR)
    jsteps_ = [jax.jit(jsteps.make_window_step(
        ref["jcfg"], jopt, ref["mesh"], tau=TAU, merge=mg, merge_axis="pod",
        transport=jt)) for mg in (jsteps.Merge.ASYNC_DELTA,
                                  jsteps.Merge.ALLREDUCE)]
    tsteps_ = [steps.make_window_step(ref["tcfg"], topt, workers=M, tau=TAU,
                                      merge=mg, transport=tt)
               for mg in (steps.Merge.ASYNC_DELTA, steps.Merge.ALLREDUCE)]
    jstate = jsteps.init_window_state(ref["jcfg"], jopt,
                                      jax.random.PRNGKey(0),
                                      jsteps.Merge.ASYNC_DELTA)
    tstate = steps.init_window_state(ref["tcfg"], topt, 0,
                                     steps.Merge.ASYNC_DELTA, workers=M,
                                     device="cpu")
    tstate["params"] = _expand(interop.params_from_reference(
        jstate["params"], ref["tcfg"], device="cpu"))
    with ref["mesh"]:
        for w, (js, ts) in enumerate(zip(jsteps_, tsteps_)):
            toks = _tokens(30 + w, tiled=False)
            jstate, jm = js(jstate, {k: jnp.asarray(v)
                                     for k, v in toks.items()})
            tstate, tm = ts(tstate, {k: torch.from_numpy(v)
                                     for k, v in toks.items()})
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=RTOL, atol=ATOL)
    assert not any(x.stride(0) == 0 for x in tree_leaves(tstate["params"]))
    for key in ("params", "opt_state", "step"):
        _close(ref, tstate[key], jstate[key], f"allreduce {key}")


# ---------------------------------------------------------------------------
# the port's own contracts (SGD, one batch tiled over the replicas)
# ---------------------------------------------------------------------------

def _port_window(merge, frac: float = SPARSE_FRAC, seed: int = 1,
                 transport=None):
    tcfg = registry.get_smoke_config(ARCH)
    opt = optimizers.sgd(LR)
    state = steps.init_window_state(tcfg, opt, 0, merge, transport,
                                    workers=M, device="cpu")
    step = steps.make_window_step(tcfg, opt, workers=M, tau=TAU,
                                  merge=merge, compress_frac=frac,
                                  transport=transport)
    toks = {k: torch.from_numpy(v) for k, v in _tokens(seed, True).items()}
    out, metrics = step(state, toks)
    return state, out, metrics, toks


def test_average_of_identical_replicas_equals_sequential_bitwise():
    state, out, _, toks = _port_window(steps.Merge.AVERAGE)
    plain = steps.make_train_step(registry.get_smoke_config(ARCH),
                                  optimizers.sgd(LR))
    ref_state = steps.replica({k: state[k] for k in ("params", "opt_state",
                                                     "step")}, 0)
    for s in range(TAU):
        ref_state, _ = plain(ref_state, {k: v[s, :B]
                                         for k, v in toks.items()})
    for a, b in zip(tree_leaves(out["params"]),
                    tree_leaves(ref_state["params"])):
        assert a.stride(0) == 0 and torch.equal(a[0], b)


def test_delta_applies_m_times_the_displacement():
    state, avg, _, _ = _port_window(steps.Merge.AVERAGE)
    _, dlt, _, _ = _port_window(steps.Merge.DELTA)
    for w0, a, d in zip(tree_leaves(state["params"]),
                        tree_leaves(avg["params"]),
                        tree_leaves(dlt["params"])):
        np.testing.assert_allclose((d - w0).numpy(), (M * (a - w0)).numpy(),
                                   atol=5e-5)


def test_sparse_at_full_density_equals_delta_bitwise():
    _, dlt, _, _ = _port_window(steps.Merge.DELTA)
    _, sps, _, _ = _port_window(steps.Merge.DELTA_SPARSE, frac=1.0)
    for a, b in zip(tree_leaves(dlt["params"]), tree_leaves(sps["params"])):
        assert torch.equal(a, b)
    assert all(not torch.any(r) for r in tree_leaves(sps["residual"]))


def test_sparse_at_low_density_leaves_a_residual():
    _, out, metrics, _ = _port_window(steps.Merge.DELTA_SPARSE, frac=0.05)
    assert torch.isfinite(metrics["loss"])
    assert max(float(r.abs().max()) for r in tree_leaves(out["residual"])) > 0


def test_delta_over_a_stateful_transport_is_refused():
    with pytest.raises(ValueError, match="DELTA_SPARSE"):
        steps.make_window_step(registry.get_smoke_config(ARCH),
                               optimizers.sgd(LR), workers=M, tau=TAU,
                               merge=steps.Merge.DELTA, transport="sparse")
