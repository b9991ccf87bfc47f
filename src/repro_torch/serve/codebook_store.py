"""Versioned, hot-swappable codebook store: the read side of the engine.

Counterpart of ``repro/serve/codebook_store.py``.  Training publishes
``(version, w)`` snapshots (``publisher()`` is an ``on_window(window, w)``
callback); lookup readers always see a consistent snapshot.

Guarantees:

  * **no torn reads**: a snapshot is an immutable ``CodebookSnapshot``
    swapped in atomically under a lock; a reader holds a complete
    ``(version, w)`` pair or the previous one, never a mix;
  * **strictly monotonic versions**: the store owns the version counter;
    concurrent publishers serialize on the lock and each gets a fresh
    version;
  * **a copy on publish**: ``publish`` takes a tensor on any device or a
    numpy array and keeps its own read-only numpy copy, never the caller's
    array, plus one copy on the store's device (made once here, so a
    flush does not copy the codebook host -> device each time).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib


class CodebookSnapshot(NamedTuple):
    """One immutable published codebook."""

    version: int            # store-assigned, strictly monotonic
    w: np.ndarray           # (kappa, d) read-only f32 prototypes
    step: int               # publisher tag (training window; -1 unknown)
    published_at: float     # time.monotonic() at publish
    w_device: torch.Tensor  # (kappa, d) f32 copy on the store's device


class CodebookStore:
    """Thread-safe versioned codebook snapshots with atomic hot-swap.

    ``device``: where each snapshot's ``w_device`` copy lives, ``cuda``
    unless the caller asks for ``"cpu"``."""

    def __init__(self, w0: torch.Tensor | np.ndarray | None = None, *,
                 keep: int = 16, device: str | torch.device | None = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.device = device_lib.resolve(device)
        self._cond = threading.Condition()
        self._latest: CodebookSnapshot | None = None
        self._history: collections.OrderedDict[int, CodebookSnapshot] = (
            collections.OrderedDict())
        self._keep = keep
        if w0 is not None:
            self.publish(w0, step=0)

    def publish(self, w: torch.Tensor | np.ndarray, *,
                step: int = -1) -> CodebookSnapshot:
        """Swap in a new codebook; returns its snapshot (fresh version)."""
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        # copy, don't alias: the flag below would otherwise freeze the
        # caller's own array
        arr = np.array(w, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(f"codebook must be (kappa, d), got {arr.shape}")
        arr.setflags(write=False)
        w_device = torch.tensor(arr, device=self.device)
        with self._cond:
            version = (self._latest.version + 1) if self._latest else 1
            snap = CodebookSnapshot(version=version, w=arr, step=step,
                                    published_at=time.monotonic(),
                                    w_device=w_device)
            self._latest = snap
            self._history[version] = snap
            while len(self._history) > self._keep:
                self._history.popitem(last=False)
            self._cond.notify_all()
        return snap

    def latest(self) -> CodebookSnapshot:
        """The current snapshot (atomic); raises if nothing was published."""
        with self._cond:
            if self._latest is None:
                raise LookupError("no codebook published yet")
            return self._latest

    def get(self, version: int) -> CodebookSnapshot | None:
        """A retained snapshot, or None if evicted or never published."""
        with self._cond:
            return self._history.get(version)

    @property
    def version(self) -> int:
        """Latest published version (0 = empty store)."""
        with self._cond:
            return self._latest.version if self._latest else 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._history)

    def wait_for(self, version: int, timeout: float | None = None) -> bool:
        """Block until ``self.version >= version``; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._latest is None or self._latest.version < version:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left)
            return True

    def publisher(self, *, skip_stale: bool = False
                  ) -> Callable[[int, torch.Tensor], None]:
        """An ``on_window(window, w)`` callback that publishes into this
        store (``MeshExecutor`` / ``ElasticMeshExecutor``'s ``on_window``).

        ``skip_stale=True`` drops a publish whose window is at or before the
        latest published step: a trainer resumed from a checkpoint replays
        windows the store already served, and publishing them again would
        move the served codebook backward."""

        def on_window(window: int, w: torch.Tensor) -> None:
            if skip_stale:
                with self._cond:
                    latest = self._latest
                if latest is not None and window <= latest.step:
                    return
            self.publish(w, step=window)

        return on_window
