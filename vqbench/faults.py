"""Faults planted under the timed path, to show that ``correct`` catches
them: the CPU test drives a whole run with each (planted into the
executor the harness builds), and ``tools/readings.py`` reads each at a
cell's own size on the card.

  * ``state_unchanged``: a local step returns the codebook it was given
    (the window, and eq. 9's per-tick step);
  * ``half_batch``: the merge takes half of the workers' displacements,
    scaled to the mean over them;
  * ``no_exchange``: the merge takes worker 0's displacement alone, as if
    the exchange between the workers were left out;
  * ``answer_altered``: the job's final codebook has row 0 moved by 1 in
    every coordinate where the program returns it.
"""

from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "answer_altered")


def plant(executor, name: str) -> None:
    """Break ``executor`` (a ``MeshExecutor`` over the dense transport) in
    place with fault ``name``."""
    if name == "state_unchanged":
        executor._local_window = (
            lambda w0, zwin, eps: w0.expand(zwin.shape[0], *w0.shape)
            .contiguous())
        executor._h = lambda z, w: torch.zeros_like(w)
    elif name in ("half_batch", "no_exchange"):
        transport = executor.transport
        whole = transport._sum

        def half(x, mask=None):
            h = x.shape[0] // 2
            scale = x.shape[0] / h
            return whole(x[:h] * scale, None if mask is None else mask[:h])

        def own(x, mask=None):
            return whole(x[:1], None if mask is None else mask[:1])

        transport._sum = half if name == "half_batch" else own
    elif name == "answer_altered":
        run = executor.run

        def altered(*args, **kwargs):
            res = run(*args, **kwargs)
            res.w_shared[0].add_(1.0)
            return res

        executor.run = altered
    else:
        raise ValueError(f"unknown fault {name!r}; choose from {FAULTS}")
