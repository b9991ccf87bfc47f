"""Delta compression with error feedback, counterpart of
``repro/optim/compression.py``.

``topk_compress`` keeps the k largest-magnitude entries of each leaf of
(delta + residual) as a dense masked tensor and carries the rest into the
next call's residual, so nothing is lost, only delayed.  The selection is
``comm.sparse.topk_threshold_mask`` (ties widen the mask); the gathered
(value, index) form of the same protocol is ``comm.SparseTransport``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.comm.sparse import topk_threshold_mask
from repro_torch.optim.optimizers import tree_map


class ErrorFeedbackState(NamedTuple):
    residual: Any  # a tree like the params, f32


def init_error_feedback(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def topk_compress(delta, ef: ErrorFeedbackState, *, frac: float = 0.01
                  ) -> tuple[Any, ErrorFeedbackState, torch.Tensor]:
    """Returns ``(compressed_delta, new_ef_state, kept_fraction)``:
    compressed = topk(delta + residual) in delta's dtype, residual' =
    (delta + residual) - compressed in f32."""
    def leaf(d, r):
        full = d.to(torch.float32) + r
        kept = full * topk_threshold_mask(full, frac)
        return kept.to(d.dtype), full - kept

    outs = tree_map(leaf, delta, ef.residual)
    compressed = tree_map(lambda o: o[0], outs)
    residual = tree_map(lambda o: o[1], outs)
    frac_t = torch.tensor(frac, dtype=torch.float32)
    return compressed, ErrorFeedbackState(residual=residual), frac_t
