"""Atomic, async and elastic checkpoints, counterpart of
``repro/checkpoint/checkpointing.py``.

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

    ckpt_dir/step_000000123/
        manifest.json      # step, n_leaves, names, shapes, dtypes, treedef
        leaf_00000.npy ... # one .npy per leaf (the whole array, on the host)

  * a tree is dicts, lists, tuples and named tuples (``AdamState``) of
    tensors, numpy arrays or Python scalars (``None`` holds no leaf); its
    leaves are numbered in the reference's flatten order (dict keys
    sorted), each named by its key path joined with ``/`` (a named tuple's
    field as ``.name``, as the reference's JAX paths print it);
  * every leaf is written into ``step_N.tmp/``, the manifest last, and the
    directory is then renamed into place: a step without its manifest is
    never listed, so a crash mid-save cannot corrupt the latest good step;
  * bf16 and float8 leaves are stored as same-width unsigned integer views,
    with the logical dtype's name in the manifest (numpy has no such type);
  * ``save_async`` copies every leaf to host numpy in the caller's thread,
    then hands the I/O to a daemon thread; ``wait`` raises the first write
    error;
  * ``restore`` returns tensors on ``device``: leaves are stored whole, so
    the restarting run's worker count does not matter to the read; with
    ``placement=`` (a ``distributed.sharding.Placement``, the counterpart of
    the reference's ``shardings=``, its lines 138-165) each rank reads the
    whole stored leaves and keeps its slices under the placement's specs, so
    a checkpoint written under one layout restores under another;
  * the ``keep`` newest steps are retained.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib

# dtypes numpy cannot hold: (torch dtype, the same-width integer view torch
# reads and writes, the unsigned view numpy stores, as the reference does)
_NARROW = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_NARROW_NAME = {torch_dtype: name
                for name, (torch_dtype, _, _) in _NARROW.items()}


def _flatten(tree, path=()) -> tuple[list, list[str], str]:
    """``(leaves, names, treedef string)`` in the reference's flatten order:
    dict keys sorted, sequences in order, ``None`` empty."""
    if tree is None:
        return [], [], "None"
    if isinstance(tree, dict):
        leaves, names, parts = [], [], []
        for k in sorted(tree):
            sub, sub_names, sub_def = _flatten(tree[k], path + (str(k),))
            leaves += sub
            names += sub_names
            parts.append(f"{k!r}: {sub_def}")
        return leaves, names, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        leaves, names, parts = [], [], []
        for i, item in enumerate(tree):
            key = f".{fields[i]}" if fields else str(i)
            sub, sub_names, sub_def = _flatten(item, path + (key,))
            leaves += sub
            names += sub_names
            parts.append(sub_def)
        if isinstance(tree, list):
            return leaves, names, "[" + ", ".join(parts) + "]"
        if fields:
            return leaves, names, f"{type(tree).__name__}({', '.join(parts)})"
        inner = ", ".join(parts) + ("," if len(parts) == 1 else "")
        return leaves, names, "(" + inner + ")"
    return [tree], ["/".join(path)], "*"


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, by those of
    the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_unflatten(item, leaves) for item in tree]
        # a named tuple takes its fields as arguments, not one iterable
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return next(leaves)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else (
        np.shape(leaf))


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """``(a host numpy array of the leaf's own, never the caller's memory;
    its dtype's name)``, a narrow float as its unsigned view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _NARROW_NAME.get(t.dtype)
        if name is not None:
            _, view, store = _NARROW[name]
            return t.view(view).to("cpu", copy=True).numpy().view(store), name
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """A stored leaf as a tensor on ``device`` (a 0-d leaf stays 0-d)."""
    arr = np.asarray(arr, order="C")
    if dtype_name in _NARROW:
        torch_dtype, view, _ = _NARROW[dtype_name]
        signed = np.int16 if view == torch.int16 else np.uint8
        return torch.from_numpy(arr.view(signed)).view(torch_dtype).to(device)
    return torch.from_numpy(arr).to(device)


class Checkpointer:
    """Step-indexed checkpoints under ``directory``, the newest ``keep``
    retained."""

    def __init__(self, directory: str, *, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        self._errors: list[Exception] = []
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # -- writing ------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``.  Every leaf is copied to the host
        first, here in the caller's thread (a device leaf syncs the card);
        with ``blocking=False`` the write itself is queued.  A blocking
        save writes after the queued ones, so two writes of one step never
        race."""
        leaves, names, treedef = _flatten(tree)
        host = [_to_host(leaf) for leaf in leaves]
        if blocking:
            self._queue.join()
            self._write(step, host, names, treedef)
        else:
            self._queue.put((step, host, names, treedef))

    def save_async(self, step: int, tree: Any) -> None:
        self.save(step, tree, blocking=False)

    def wait(self) -> None:
        """Block until every queued save is written; raise the first error
        a queued write hit."""
        self._queue.join()
        if self._errors:
            raise self._errors[0]

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                self._write(*job)
            except Exception as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _write(self, step: int, host: list, names: list[str],
               treedef: str) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, (arr, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "names": names,
            "shapes": [list(arr.shape) for arr, _ in host],
            "dtypes": [name for _, name in host],
            "treedef": f"PyTreeDef({treedef})",
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- reading ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Steps with a manifest, oldest first (a ``.tmp`` is never one)."""
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "manifest.json"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, *, device=None,
                placement=None) -> Any:
        """Step ``step`` in the structure of ``target`` (a tree of tensors,
        arrays or scalars whose shapes the leaves must have: the whole
        leaves), as tensors on ``device`` (``cuda`` unless the caller asks
        for ``"cpu"``).  With ``placement`` each leaf is cut to this rank's
        slice on the host before it moves."""
        device = device_lib.resolve(device)
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        want, _, _ = _flatten(target)
        if len(want) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target has "
                f"{len(want)}")
        specs = placement.spec_leaves() if placement is not None else None
        if specs is not None and len(specs) != len(want):
            raise ValueError(f"the placement has {len(specs)} specs, the "
                             f"target {len(want)} leaves")
        loaded = []
        for i, leaf in enumerate(want):
            arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
            if tuple(arr.shape) != _shape(leaf):
                raise ValueError(
                    f"leaf {manifest['names'][i]}: checkpoint shape "
                    f"{arr.shape} != target {_shape(leaf)}")
            if specs is None:
                loaded.append(_from_host(arr, manifest["dtypes"][i], device))
            else:
                whole = _from_host(arr, manifest["dtypes"][i], "cpu")
                loaded.append(placement.local(whole, specs[i]).to(device))
        return _unflatten(target, iter(loaded))
