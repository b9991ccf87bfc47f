"""``RingTransport``: dense merges through the ring all-reduce kernel.

Counterpart of ``repro/comm/ring.py``.  The reference runs the
bandwidth-optimal two-phase ring between TPU devices (``_ring_kernel``,
neighbour remote copies) and falls back to XLA's psum elsewhere.  In its
reduce-scatter hops (``ring.py:80-94``), hop s has worker i fold its left
neighbour's partial of chunk ``(i - s - 1) % M`` into its own, the received
partial as the left operand.  Each worker's payload is cut into M chunks of
``ceil(N / M)`` entries, so chunk c sums as the left fold ``(...((x_c +
x_{c+1}) + x_{c+2}) ... + x_{c-1})`` (worker indices mod M); the all-gather
hops only copy completed chunks.  The fold order is the contract: it differs
from ``torch.sum``'s, so the ring and the dense transport agree to rounding,
not bit for bit.

Here the M workers are the leading dimension of one tensor on one card.
``ring_all_reduce`` computes the result of the hops in one launch of
``kernels/csrc/vq_ring.cu`` without running them: offset p of chunk c only
ever meets offset p of chunk c on the other workers, and every partial a hop
would send already lies in the same memory, so each entry is folded in the
ring's order straight from the M rows and stored once.  The hops come back
as moves over peer memory only across cards (ROADMAP queue 1, item 9b).
``ring_all_reduce_plain`` runs the hops themselves in PyTorch; the two agree
bit for bit.  The reference's two-slot buffer scheme is not carried over.

``ring_all_reduce`` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor only; ``launches_ring`` counts the kernel's
launches.  Wire and logical bytes are the dense convention's: a ring moves
exactly the bytes ``CommRecord`` charges a dense all-reduce.
"""

from __future__ import annotations

import copy

import torch

from repro_torch.comm.xla import XlaTransport
from repro_torch.kernels import _build

launches_ring = 0


def _check(x: torch.Tensor, mask: torch.Tensor | None) -> None:
    if x.dim() < 1 or x.dtype != torch.float32:
        raise ValueError(f"ring_all_reduce takes x (M, ...) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m = x.shape[0]
    if mask is not None and (mask.shape != (m,)
                             or mask.dtype != torch.float32
                             or mask.device != x.device):
        raise ValueError(
            f"mask must be float32 ({m},) on {x.device}, got {mask.dtype} "
            f"{tuple(mask.shape)} on {mask.device}")


def ring_all_reduce_plain(x: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain version: the M-1 reduce-scatter hops in PyTorch.

    x (M, ...) f32 (and mask (M,) f32, applied first) -> (...), the ring
    sum.  The payload is zero-padded to M chunks, viewed (M, M, chunk); each
    hop gathers the left neighbours' chunks (a copy, so every worker's
    pre-hop values are read before any is written) and writes the receiving
    workers' chunks; chunk c is then read from worker ``(c - 1) % M``."""
    _check(x, mask)
    m = x.shape[0]
    flat = x.reshape(m, -1)
    if mask is not None:
        flat = mask[:, None] * flat
    n = flat.shape[1]
    chunk = -(-n // m)
    o = flat.new_zeros((m, m * chunk))
    o[:, :n] = flat
    o = o.view(m, m, chunk)
    workers = torch.arange(m, device=x.device)
    left = (workers - 1) % m
    for s in range(m - 1):
        recv = (workers - s - 1) % m
        o[workers, recv] = o[left, recv] + o[workers, recv]
    return o[left, workers].reshape(m * chunk)[:n].reshape(x.shape[1:])


def ring_all_reduce(x: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """The ring sum over the workers of x (M, ...) f32, or of mask[i] * x[i]
    with mask (M,) f32: (...), bit for bit ``ring_all_reduce_plain``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream.  M = 1 returns the (masked) input row without a
    launch."""
    global launches_ring
    _check(x, mask)
    if x.device.type == "cpu":
        return ring_all_reduce_plain(x, mask)
    if x.device.type != "cuda":
        raise ValueError(
            f"ring_all_reduce runs on cuda or cpu, got {x.device}")
    m = x.shape[0]
    if m == 1 or x.numel() == 0:
        return x[0] if mask is None else mask[0] * x[0]
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    lib = _build.library()
    with _build.on_device(x.device):
        stream = _build.current_stream(x.device)
        rc = lib.vq_ring_f32(x.data_ptr(),
                             None if mask is None else mask.data_ptr(),
                             out.data_ptr(), m, x.numel() // m, stream)
    _build.check(rc, "vq_ring_f32")
    launches_ring += 1
    return out


class RingTransport(XlaTransport):
    """Dense merges over the ring kernel; records under ``"ring"``.

    Sums return the ring sum; means the ring sum divided by M (a tensor, as
    the reference's ``ring.py:159-162`` divides) and cast back to x's dtype;
    the masked sum is the ring of ``mask * x`` (the reference's
    ``xla.py:57-63``), the mask applied as the kernel loads."""

    name = "ring"

    def __init__(self):
        super().__init__()
        self.reduce = ring_all_reduce

    def plain(self) -> RingTransport:
        out = copy.copy(self)    # shares the log
        out.reduce = ring_all_reduce_plain
        return out

    def _sum(self, x, mask=None):
        x = x.to(torch.float32).contiguous()
        return self.reduce(x, None if mask is None
                           else mask.to(torch.float32).contiguous())

    def _mean(self, x):
        # a tensor divisor on x's device: tensor / python scalar rounds as a
        # multiply by the reciprocal on the card, which is not exact at M = 3
        # or 6; torch.full fills it on the device (torch.tensor would copy
        # from the host and wait for the stream)
        m = torch.full((), x.shape[0], dtype=torch.float32, device=x.device)
        return (self._sum(x) / m).to(x.dtype)
