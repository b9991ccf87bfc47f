"""``QuantizedTransport``: bf16/int8 encoding of the merge deltas over any
transport.  Counterpart of ``repro/comm/quant.py``.

Each worker encodes its contribution (payload + error-feedback residual) to
a narrow wire format; the decoded f32 values ride the INNER transport's
reduction unchanged, and the rounding left out is carried into the next
call's payload (error feedback, as ``SparseTransport`` does for its top-k),
so nothing is lost, only delayed.

Three codecs (``quantize_leaf``), each applied to every worker's own slice
of the stacked (M, ...) payload, which is the reference's "leaf" (one
device's local payload):

  * ``bf16``: round the f32 payload to bfloat16 (2 bytes an entry);
  * ``int8``: symmetric max-abs scaling per worker,
    ``q = round(x / s).clip(-127, 127)`` with ``s = max|x| / 127`` (1 byte
    an entry and one f32 scale per worker on the wire);
  * ``identity``: encode and decode are the identity and the wire width
    stays 4 bytes: the decorator changes nothing, numerics or accounting.

Wire accounting: the inner transport's records since the call's mark are
copied into this transport's log, re-priced at the quantized width
(``_requant``): dense records ``wire * width // 4``; sparse records (value
f32 + index int32 pairs, only the value narrows) ``wire * (width + 4) //
8``; int8 adds 4 bytes of scale a leaf when the record moved any wire (a
tuple payload is coded leaf by leaf, each leaf with its own scale and
residual).  A record keeps its ``tier``, so quantization over a
``HierarchicalTransport`` keeps the per-tier split.  Means pass through
unquantized and unchanged: they are consensus values, not displacements,
so ``AverageMerge`` and the eval reduce are the inner transport's own.  A
``QuantizedTransport`` inside another is refused.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.comm.api import (CommRecord, Transport, as_leaves,
                                  from_leaves, get_transport)

#: wire bytes per payload entry under each codec (dense f32 is 4)
QUANT_WIDTH = {"identity": 4, "bf16": 2, "int8": 1}


def _check_mode(mode: str) -> None:
    if mode not in QUANT_WIDTH:
        raise ValueError(
            f"unknown quantization mode {mode!r}; choose from "
            f"{sorted(QUANT_WIDTH)}")


def quantize_leaf(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Encode -> decode every worker's leaf of the stacked f32 x (M, ...):
    the dequantized values the receiving side reconstructs (the reduction
    sums these, so simulating the wire is exact).  The int8 scale is each
    worker's own ``max|x|``.  Rounding is half to even and the bf16
    conversion round-to-nearest-even, as in the reference."""
    _check_mode(mode)
    if mode == "identity":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    m = x.shape[0]
    amax = x.abs().reshape(m, -1).amax(dim=1).view(m, *(1,) * (x.dim() - 1))
    # tensor operands filled on x's device: a python scalar divisor is a
    # reciprocal multiply on the card, and torch.tensor would copy from the
    # host and wait for the stream
    floor, levels = (torch.full((), v, dtype=torch.float32, device=x.device)
                     for v in (1e-30, 127.0))
    scale = torch.maximum(amax, floor) / levels
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    return q * scale


class QuantizedTransport(Transport):
    """Quantize sum payloads before the inner transport's reduction."""

    name = "quant"

    def __init__(self, inner: Transport | str = "xla", *, mode: str = "bf16",
                 **inner_kwargs):
        super().__init__()
        _check_mode(mode)
        if isinstance(inner, Transport) and inner_kwargs:
            raise ValueError(
                "pass inner transport kwargs only with a string inner spec; "
                f"got a constructed transport AND {sorted(inner_kwargs)}")
        self.inner = (inner if isinstance(inner, Transport)
                      else get_transport(inner, **inner_kwargs))
        if isinstance(self.inner, QuantizedTransport):
            raise ValueError(
                "inner= must not be a QuantizedTransport: double "
                "quantization would double-charge scale bytes and hide one "
                "codec's error inside the other's residual")
        self.mode = mode
        # identity is exact: no residual to feed back, no state to thread
        self.error_feedback = mode != "identity"
        self.name = f"quant[{mode}:{self.inner.name}]"

    @property
    def stateful(self) -> bool:  # type: ignore[override]
        return self.error_feedback or self.inner.stateful

    def workers(self, x) -> int:
        return self.inner.workers(x)

    def plain(self) -> QuantizedTransport:
        out = copy.copy(self)    # shares the log
        out.inner = self.inner.plain()
        return out

    # -- state threading: residual + inner state in one carry ---------------

    @staticmethod
    def _zeros(x):
        leaves, is_tuple = as_leaves(x)
        return from_leaves([torch.zeros(leaf.shape, dtype=torch.float32,
                                        device=leaf.device)
                            for leaf in leaves], is_tuple)

    def init_state(self, x):
        res = self._zeros(x) if self.error_feedback else None
        inner = self.inner.init_state(x)
        if res is None:
            return inner
        if inner is None:
            return res
        return {"q": res, "inner": inner}

    def _split_state(self, state):
        if self.error_feedback and self.inner.stateful:
            state = {} if state is None else state
            return state.get("q"), state.get("inner")
        if self.error_feedback:
            return state, None
        return None, state

    def _join_state(self, res, inner):
        if self.error_feedback and self.inner.stateful:
            return {"q": res, "inner": inner}
        if self.error_feedback:
            return res
        return inner

    # -- wire re-pricing ----------------------------------------------------

    def _requant(self, r: CommRecord, n_leaves: int) -> CommRecord:
        """Re-price one delegated sum record at the quantized width."""
        if r.op == "mean":
            return r                       # rides dense, unquantized
        width = QUANT_WIDTH[self.mode]
        if r.transport.startswith("sparse"):
            # (value f32, index int32) pairs: only the value half narrows
            wire = r.wire_bytes * (width + 4) // 8
        else:
            wire = r.wire_bytes * width // 4
        if self.mode == "int8" and r.wire_bytes > 0:
            wire += 4 * n_leaves           # the worker's scale, a leaf
        return dataclasses.replace(
            r, transport=f"{r.transport}+{self.mode}", wire_bytes=wire)

    def _delegated(self, mark: int, n_leaves: int) -> None:
        for r in self.inner.log.since(mark):
            self.log.append(self._requant(r, n_leaves))

    # -- encode + delegate --------------------------------------------------

    def _encode(self, x, residual, mask: torch.Tensor | None):
        """(dequantized payload, new residual), leaf by leaf.  A masked-out
        worker contributes zero downstream (the inner masked reduce applies
        the mask) and keeps its residual untouched, as ``SparseTransport``'s
        masked workers do."""
        leaves, is_tuple = as_leaves(x)
        res = ([None] * len(leaves) if residual is None
               else as_leaves(residual)[0])
        outs = [self._encode_leaf(leaf, r, mask)
                for leaf, r in zip(leaves, res, strict=True)]
        deq = from_leaves([o[0] for o in outs], is_tuple)
        if residual is None:
            return deq, None
        return deq, from_leaves([o[1] for o in outs], is_tuple)

    def _encode_leaf(self, x: torch.Tensor, residual: torch.Tensor | None,
                     mask: torch.Tensor | None):
        payload = x.to(torch.float32)
        if residual is not None:
            payload = payload + residual
        deq = quantize_leaf(payload, self.mode)
        if residual is None:
            return deq, None
        new_res = payload - deq
        if mask is not None:
            keep = mask.view(x.shape[0], *(1,) * (x.dim() - 1)) != 0
            new_res = torch.where(keep, new_res, residual)
        return deq, new_res

    def _quant_reduce(self, x, *, mask, state, tag: str):
        res, inner_state = self._split_state(state)
        # a state=None call runs residual-free and stays None (the one-shot
        # convention every stateful transport follows)
        residual = None
        if self.error_feedback:
            residual = self._zeros(x) if res is None else res
        deq, new_res = self._encode(x, residual, mask)
        mark = self.inner.log.mark()
        if mask is None:
            total, inner_state = self.inner.all_reduce(
                deq, op="sum", state=inner_state, tag=tag)
        else:
            total, inner_state = self.inner.masked_all_reduce(
                deq, mask, state=inner_state, tag=tag)
        self._delegated(mark, len(as_leaves(x)[0]))
        if state is None:
            return total, None
        return total, self._join_state(new_res, inner_state)

    # -- Transport API ------------------------------------------------------

    def all_reduce(self, x, *, op: str = "sum", state=None, calls: int = 1,
                   tag: str = "merge"):
        if calls != 1:
            return self._charged(calls, self.all_reduce, x, op=op,
                                 state=state, tag=tag)
        if op == "mean":
            mark = self.inner.log.mark()
            out, _ = self.inner.all_reduce(x, op="mean", tag=tag)
            self._delegated(mark, len(as_leaves(x)[0]))
            return out, state
        if op != "sum":
            raise ValueError(
                f"unknown reduce op {op!r}; choose 'sum' or 'mean'")
        return self._quant_reduce(x, mask=None, state=state, tag=tag)

    def masked_all_reduce(self, x, mask: torch.Tensor, *, state=None,
                          calls: int = 1, tag: str = "merge"):
        if calls != 1:
            return self._charged(calls, self.masked_all_reduce, x, mask,
                                 state=state, tag=tag)
        m = as_leaves(x)[0][0].shape[0]
        if mask.shape != (m,):
            raise ValueError(f"mask must be ({m},), got {tuple(mask.shape)}")
        return self._quant_reduce(x, mask=mask.to(torch.float32), state=state,
                                  tag=tag)
