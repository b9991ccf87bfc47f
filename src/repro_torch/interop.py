"""Carries state between the JAX reference and the port, through numpy.

``from_reference`` turns the reference's inputs (anything ``np.asarray``
takes: numpy arrays or the JAX package's arrays) into the port's f32
contiguous tensors on a device, after checking their shapes and types;
``result_from_reference`` does the same for a reference ``SchemeResult``,
``lengths_from_reference`` for a ``NetworkModel.round_lengths`` draw (the
async scheme's round lengths, which torch cannot redraw from a JAX key) and
``codebook_from_reference`` for a codebook to publish into a store, and
``merge_state_from_reference`` for a sync merge's state (the quorum carry,
the dynamic merge's carry and staleness, a hierarchical transport's
per-tier residuals).  ``to_numpy`` turns a port ``SchemeResult`` into
numpy arrays.  For the LM side, ``params_from_reference`` turns the reference's params
pytree into the port's nested dict (leaf names, stacked shapes and dtypes
kept, bf16 bits moved through ``uint16``), ``cache_from_reference`` a
decode cache and ``quantized_from_reference`` an int8 tree of
``QuantizedLeaf``s.  The device is ``cuda`` unless the caller passes
``device="cpu"``.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.schemes import SchemeResult


def _tensor(x, name: str, ndim: int, kind: str, dtype: torch.dtype,
            device) -> torch.Tensor:
    device = device_lib.resolve(device)
    a = np.asarray(x)
    if a.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {a.shape}")
    if a.dtype.kind not in kind:
        raise TypeError(f"{name} must be of kind {kind!r}, got {a.dtype}")
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(
        device=device, dtype=dtype).contiguous()


def from_reference(w0, data, eval_data, *, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference inputs -> ``(w0 (kappa, d), data (M, n, d),
    eval_data (M, n_eval, d))`` f32 contiguous tensors on ``device``."""
    f32 = torch.float32
    w0_t = _tensor(w0, "w0", 2, "f", f32, device)
    data_t = _tensor(data, "data", 3, "f", f32, device)
    eval_t = _tensor(eval_data, "eval_data", 3, "f", f32, device)
    d = w0_t.shape[1]
    if data_t.shape[2] != d or eval_t.shape[2] != d:
        raise ValueError(
            f"d disagrees: w0 {tuple(w0_t.shape)}, data "
            f"{tuple(data_t.shape)}, eval_data {tuple(eval_t.shape)}")
    if eval_t.shape[0] != data_t.shape[0]:
        raise ValueError(
            f"M disagrees: data {tuple(data_t.shape)}, eval_data "
            f"{tuple(eval_t.shape)}")
    return w0_t, data_t, eval_t


def result_from_reference(result, *, device=None) -> SchemeResult:
    """A reference ``SchemeResult`` (w_shared, wall_ticks, distortion) ->
    the port's, on ``device``."""
    w, ticks, curve = result
    out = SchemeResult(
        w_shared=_tensor(w, "w_shared", 2, "f", torch.float32, device),
        wall_ticks=_tensor(ticks, "wall_ticks", 1, "iu", torch.int32, device),
        distortion=_tensor(curve, "distortion", 1, "f", torch.float32,
                           device))
    if out.wall_ticks.shape != out.distortion.shape:
        raise ValueError(
            f"wall_ticks {tuple(out.wall_ticks.shape)} and distortion "
            f"{tuple(out.distortion.shape)} disagree")
    return out


def lengths_from_reference(lengths, *, device="cpu") -> torch.Tensor:
    """A reference (M, max_rounds) round-length draw -> an int32 tensor
    (on the host by default: the async scheme moves it once, after
    checking its shape and that every round lasts tau ticks or more)."""
    return _tensor(lengths, "lengths", 2, "iu", torch.int32, device)


def codebook_from_reference(w, *, device=None) -> torch.Tensor:
    """A reference (kappa, d) codebook -> an f32 tensor on ``device``."""
    return _tensor(w, "codebook", 2, "f", torch.float32, device)


def merge_state_from_reference(state, *, topology=None, device=None):
    """A reference sync merge state, as its mesh executor keeps it between
    segments (every leaf with a leading per-worker (M, ...) dimension,
    nested in dicts), -> the port's, on ``device``.

    Leaves map to f32 tensors, keeping their (M, ...) shape, except:
    ``"stale"`` (the dynamic merge's windows since the last merge, the
    same on every worker) becomes one scalar, and ``"t1"`` (a hierarchical
    transport's tier-1 state, the same on every worker of a host group)
    becomes one row a host, (hosts, ...), under ``topology``.  Both are
    checked to agree across the rows they fold."""
    def rows_equal(a, groups, name):
        # groups: (n_groups, group_size, ...); every row equals its first
        if not np.array_equal(groups, np.broadcast_to(groups[:, :1],
                                                      groups.shape)):
            raise ValueError(f"{name}: rows differ within a group, so they "
                             f"do not fold to one")
        return groups[:, 0]

    def convert(x, key):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: convert(v, k) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.kind != "f" or a.ndim < 1:
            raise TypeError(f"{key}: expected a float (M, ...) array, got "
                            f"{a.dtype} {a.shape}")
        if key == "stale":
            a = rows_equal(a, a[None], key)[0]
        elif key == "t1":
            if topology is None:
                raise ValueError("a tier-1 state needs topology=")
            if a.shape[0] != topology.total_workers:
                raise ValueError(
                    f"t1: {a.shape[0]} rows, the topology holds "
                    f"{topology.total_workers} workers")
            a = rows_equal(a, a.reshape(topology.hosts,
                                        topology.workers_per_host,
                                        *a.shape[1:]), key)
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(
            device_lib.resolve(device))

    return convert(state, "state")


# numpy dtype names -> torch dtypes of the LM trees' leaves
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32,
           "int8": torch.int8}


def _leaf(x, name: str, device: torch.device) -> torch.Tensor:
    """One array leaf, dtype kept.  numpy has no bfloat16 of its own (the
    reference's arrays carry ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses), so bf16 bits move through ``uint16``."""
    a = np.asarray(x)
    if a.dtype.name not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {a.dtype}")
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16), order="C").view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C", copy=True))
    return t.to(device)


def _tree(x, name: str, device: torch.device, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, f"{name}/{k}", device, leaf)
                for k, v in x.items()}
    return leaf(x, name, device)


def _signature(tree, name: str = "") -> dict:
    """{path: (shape, dtype)} of a tree of tensors and QuantizedLeafs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_signature(v, f"{name}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {name: (tuple(tree.shape), tree.dtype)}
    return {name: (tuple(tree.q.shape), tree.dtype)}


def _check_like(got, want, what: str) -> None:
    g, w = _signature(got), _signature(want)
    if g != w:
        diff = sorted(str(x) for x in set(g.items()) ^ set(w.items()))
        raise ValueError(f"{what} does not match the port's init: "
                         f"{diff[:6]}")


def params_from_reference(params, cfg, *, device=None) -> dict:
    """The reference's params pytree (nested dicts of numpy or JAX arrays)
    -> the port's nested dict on ``device``, with the same leaf names,
    stacked shapes and dtypes; checked against the port's ``init`` for
    ``cfg`` (on the ``meta`` device)."""
    from repro_torch.models.api import get_api

    out = _tree(params, "params", device_lib.resolve(device), _leaf)
    _check_like(out, get_api(cfg).init(device="meta"), "params")
    return out


def cache_from_reference(cache, *, device=None) -> dict:
    """A reference decode cache -> the port's: ``cur_len`` a host int, the
    other leaves tensors on ``device`` with their shapes and dtypes."""
    dev = device_lib.resolve(device)
    return {k: (int(np.asarray(v)) if k == "cur_len"
                else _leaf(v, f"cache/{k}", dev))
            for k, v in cache.items()}


def quantized_from_reference(qparams, cfg, *, device=None) -> dict:
    """A reference int8 tree (``quantize_tree``'s, ``QuantizedLeaf``s
    among plain leaves) -> the port's, ``q``, ``scale`` and the original
    dtype kept; checked against the port's ``init`` for ``cfg``."""
    from repro_torch.models.api import get_api
    from repro_torch.models.quantization import QuantizedLeaf

    def leaf(x, name, dev):
        if hasattr(x, "q") and hasattr(x, "scale"):
            dtype = _DTYPES[np.dtype(x.dtype).name]
            return QuantizedLeaf(q=_leaf(x.q, f"{name}.q", dev),
                                 scale=_leaf(x.scale, f"{name}.scale", dev),
                                 dtype=dtype)
        return _leaf(x, name, dev)

    out = _tree(qparams, "qparams", device_lib.resolve(device), leaf)
    _check_like(out, get_api(cfg).init(device="meta"), "qparams")
    return out


def to_numpy(result: SchemeResult) -> SchemeResult:
    """A port ``SchemeResult`` as numpy arrays (f32, int32, f32)."""
    return SchemeResult(
        w_shared=result.w_shared.detach().cpu().numpy().astype(np.float32),
        wall_ticks=result.wall_ticks.detach().cpu().numpy().astype(np.int32),
        distortion=result.distortion.detach().cpu().numpy().astype(
            np.float32))
