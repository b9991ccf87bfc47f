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

Stacked workers (the M workers the leading dimension of one tensor on one
card): ``ring_all_reduce`` computes the result of the hops in one launch of
``kernels/csrc/vq_ring.cu`` without running them: offset p of chunk c only
ever meets offset p of chunk c on the other workers, and every partial a hop
would send already lies in the same memory, so each entry is folded in the
ring's order straight from the M rows and stored once.
``ring_all_reduce_plain`` runs the hops themselves in PyTorch; the two agree
bit for bit.  The reference's two-slot buffer scheme is not carried over.

One worker a process (``distributed.process_group``):
``ring_all_reduce_group`` runs the 2 (M - 1) hops between the ranks of a
process group, in the same chunking and fold order, so every rank gets the
bits of ``ring_all_reduce_plain`` of the stacked rows.  On the CPU a hop is
a gloo send/recv of one chunk and the add; on the card it is one launch of
``kernels/csrc/vq_ring_hop.cu``, which reads the left neighbour's staging
buffer through a CUDA IPC mapping.  The hops wait for each other on the
card, as the reference's wait on its DMA and barrier semaphores: each
rank's staging allocation carries a progress counter, and
``hop_schedule`` spells out each step's chunk and the counters it waits
for.  A call enqueues the stage, the hops and the copy out on the current
stream, each step behind the driver's stream waits on the neighbours'
counters and ahead of a stream write of its own, and returns without
waiting: no host sync and no barrier inside a call.

``ring_all_reduce`` and ``ring_all_reduce_group`` launch their kernels for
CUDA tensors and take the plain versions for CPU tensors only;
``launches_ring`` counts the fold kernel's launches, ``launches_ring_hop``
the hop kernel's.  Wire and logical bytes are the dense convention's: a
ring moves exactly the bytes ``CommRecord`` charges a dense all-reduce.
"""

from __future__ import annotations

import copy
import ctypes
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.comm.xla import XlaTransport
from repro_torch.kernels import _build

launches_ring = 0
launches_ring_hop = 0
# None, or a list to which each group-ring step on the card appends a pair
# of timing CUDA events recorded on its stream before and after it (its
# waits on the neighbours, its kernel and its counter write)
step_events: list | None = None


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


def _group_payload(x: torch.Tensor, mask: torch.Tensor | None, m: int
                   ) -> tuple[torch.Tensor, int, int]:
    """This rank's flat f32 row, N and the chunk ceil(N / M)."""
    if x.dtype != torch.float32:
        raise ValueError(f"ring_all_reduce_group takes float32, got {x.dtype}")
    if mask is not None and (mask.numel() != 1 or mask.dtype != torch.float32
                             or mask.device != x.device):
        raise ValueError(
            f"mask must be this rank's float32 entry (1,) on {x.device}, got "
            f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    flat = x.reshape(-1)
    n = flat.numel()
    return flat, n, -(-n // m)


def _ring_group_cpu(flat, mask, group, m: int, r: int, n: int, chunk: int
                    ) -> torch.Tensor:
    """The hops as gloo send/recv of one chunk each, the add in the plain
    version's operand order."""
    if mask is not None:
        flat = mask.reshape(()) * flat
    o = flat.new_zeros((m, chunk))
    o.view(-1)[:n] = flat
    ranks = dist.get_process_group_ranks(group)
    right, left = ranks[(r + 1) % m], ranks[(r - 1) % m]
    buf = torch.empty(chunk, dtype=torch.float32)

    def hop(send_c: int) -> None:
        ops = [dist.P2POp(dist.isend, o[send_c].contiguous(), right, group),
               dist.P2POp(dist.irecv, buf, left, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    for s in range(m - 1):            # reduce-scatter: fold into chunk c
        c = (r - s - 1) % m
        hop((r - s) % m)
        o[c] = buf + o[c]
    for s in range(m - 1):            # all-gather: copy the finished chunk
        hop((r + 1 - s) % m)
        o[(r - s) % m] = buf
    return o.view(-1)[:n]


class RingStep(NamedTuple):
    """Step ``t`` of one call of the group ring on one rank.  Call k's steps
    count from base = k (2M - 1): when the step is done the rank writes base
    + t + 1 into its counter, and before it starts its stream waits until
    the left neighbour's counter reaches base + ``wait_left`` and the right
    neighbour's base + ``wait_right`` (None: no wait)."""

    t: int
    chunk: int | None      # read from the left, written here; None: stage
    add: bool              # fold (reduce-scatter) or copy (all-gather)
    wait_left: int | None
    wait_right: int | None


def hop_schedule(m: int, r: int) -> tuple[RingStep, ...]:
    """Rank r's 2M - 1 steps of a call over M ranks: the stage (the payload
    into the row), then the reduce-scatter's M - 1 folds and the
    all-gather's M - 1 copies, ``ring_all_reduce_plain``'s chunks.

    Hop t waits until the left neighbour has finished step t - 1: the chunk
    it reads is done.  Around the ring those waits chain, so the right
    neighbour has then finished step t - M + 1, which covers every read
    of this row a hop could overwrite (the all-gather's hop s overwrites
    the partial the right neighbour's fold s read, at its step s + 1 <= t -
    M + 1); so a hop waits on the left alone, and a rank may run up to M -
    1 steps ahead of its right neighbour.  The stage overwrites the whole
    row, so it waits until the right neighbour has finished the call
    before (its last copy reads this row)."""
    steps = [RingStep(0, None, False, None, 0)]
    for s in range(m - 1):
        steps.append(RingStep(1 + s, (r - s - 1) % m, True, 1 + s, None))
    for s in range(m - 1):
        steps.append(RingStep(m + s, (r - s) % m, False, m + s, None))
    return tuple(steps)


_flush: bool | None = None


def _wait_flush(lib) -> bool:
    """Whether the stream waits flush remote writes: the card's
    CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES.  Raises where the card
    has no 64-bit stream memory operations: the route has no other way to
    order its hops."""
    global _flush
    if _flush is None:
        caps = (ctypes.c_int * 2)()
        _build.check(lib.vq_ring_sync_caps(caps), "vq_ring_sync_caps")
        if not caps[0]:
            raise RuntimeError(
                "ring_all_reduce_group: the card reports "
                "CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS = 0; the "
                "hops wait for each other through cuStreamWaitValue64")
        _flush = bool(caps[1])
    return _flush


class _Staging:
    """This rank's staging allocation (cudaMalloc: the progress counter,
    then the padded row) and its neighbours', mapped over CUDA IPC, for one
    group and size; ``calls`` counts the calls enqueued on it."""

    def __init__(self, lib, group, dev: torch.device, floats: int, m: int,
                 r: int):
        self.lib = lib
        self.group = group       # kept alive with the mapping
        self.dev = dev
        self.flush = _wait_flush(lib)
        self.schedule = hop_schedule(m, r)
        self.calls = 0
        self.stream = None       # the raw stream of the last call
        ptr = ctypes.c_void_p()
        _build.check(lib.vq_ring_alloc(4 * floats, ctypes.byref(ptr)),
                     "vq_ring_alloc")       # the counter is 0 on return
        self.mine = ptr.value
        handle = ctypes.create_string_buffer(64)
        _build.check(lib.vq_ring_export(self.mine, handle), "vq_ring_export")
        handles = [None] * m
        dist.all_gather_object(handles, handle.raw, group=group)
        self.mapped = []
        for i in dict.fromkeys(((r - 1) % m, (r + 1) % m)):  # 1 at M = 2
            theirs = ctypes.create_string_buffer(handles[i], 64)
            out = ctypes.c_void_p()
            _build.check(lib.vq_ring_open(theirs, ctypes.byref(out)),
                         "vq_ring_open")
            self.mapped.append(out.value)
        self.left, self.right = self.mapped[0], self.mapped[-1]

    def release(self) -> None:
        """Wait for this rank's enqueued steps, unmap the neighbours'
        allocations, wait for the group to do the same, and free this
        one."""
        torch.cuda.synchronize(self.dev)
        for ptr in self.mapped:
            _build.check(self.lib.vq_ring_close(ptr), "vq_ring_close")
        dist.barrier(group=self.group)
        _build.check(self.lib.vq_ring_free(self.mine), "vq_ring_free")


# (id of the group, floats) -> _Staging, opened in the order the ranks
# call, which is the same on every rank (the ring is a collective)
_staging: dict[tuple[int, int], _Staging] = {}


def release_group_buffers() -> None:
    """Free every staging buffer and mapping (``process_group.destroy``)."""
    while _staging:
        _staging.pop(next(iter(_staging))).release()


def _ring_group_cuda(flat, mask, group, m: int, r: int, n: int, chunk: int
                     ) -> torch.Tensor:
    """The steps of ``hop_schedule`` enqueued on the current stream, one
    ``vq_ring_step`` each (its stream waits on the neighbours' counters, its
    kernel, the write of this rank's); the finished row copied out after
    them."""
    global launches_ring_hop
    lib = _build.library()
    dev = flat.device
    key = (id(group), m * chunk)
    with _build.on_device(dev):
        st = _staging.get(key)
        if st is None:
            st = _staging[key] = _Staging(lib, group, dev, m * chunk, m, r)
        stream = _build.current_stream(dev)
        if st.calls and stream != st.stream:
            # a call on another stream than the last: this rank's own steps
            # are ordered by its stream, not by the counters
            torch.cuda.current_stream(dev).wait_stream(
                torch.cuda.ExternalStream(st.stream, device=dev)
                if st.stream else torch.cuda.default_stream(dev))
        st.stream = stream
        src = flat.contiguous()
        base = st.calls * len(st.schedule)
        st.calls += 1
        for step in st.schedule:
            if step_events is not None:
                timed = [torch.cuda.Event(enable_timing=True)
                         for _ in range(2)]
                timed[0].record()
            wl, wr = step.wait_left, step.wait_right
            _build.check(lib.vq_ring_step(
                st.left, 0 if wl is None else base + wl,
                st.right, 0 if wr is None else base + wr, st.flush,
                src.data_ptr(), None if mask is None else mask.data_ptr(), n,
                m, -1 if step.chunk is None else step.chunk, chunk,
                int(step.add), st.mine, base + step.t + 1, stream),
                "vq_ring_step")
            if step.chunk is not None:
                launches_ring_hop += 1
            if step_events is not None:
                timed[1].record()
                step_events.append(tuple(timed))
        out = torch.empty(n, dtype=torch.float32, device=dev)
        _build.check(lib.vq_ring_copy_f32(out.data_ptr(), st.mine, n, stream),
                     "vq_ring_copy_f32")
    return out


def ring_all_reduce_group(x_local: torch.Tensor, group,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """The ring sum over the ranks of ``group`` of their ``x_local`` (any
    shape, f32; or of ``mask * x_local`` with ``mask`` this rank's (1,)
    entry): every rank gets the same tensor, shaped like ``x_local``, bit
    for bit ``ring_all_reduce_plain`` of the ranks' stacked rows.

    CPU tensors hop over gloo send/recv; CUDA tensors launch the hop kernel
    2 (M - 1) times over CUDA IPC, enqueued on the current stream without a
    host wait.  A group of one returns the (masked) input."""
    m = dist.get_world_size(group)
    r = dist.get_rank(group)
    flat, n, chunk = _group_payload(x_local, mask, m)
    if m == 1 or n == 0:
        return x_local.clone() if mask is None else mask.reshape(()) * x_local
    if flat.device.type == "cpu":
        out = _ring_group_cpu(flat, mask, group, m, r, n, chunk)
    elif flat.device.type == "cuda":
        out = _ring_group_cuda(flat, mask, group, m, r, n, chunk)
    else:
        raise ValueError(f"ring_all_reduce_group runs on cuda or cpu, got "
                         f"{flat.device}")
    return out.reshape(x_local.shape)


class RingTransport(XlaTransport):
    """Dense merges over the ring kernel; records under ``"ring"``.

    Sums return the ring sum; means the ring sum divided by M (a tensor, as
    the reference's ``ring.py:159-162`` divides) and cast back to x's dtype;
    the masked sum is the ring of ``mask * x`` (the reference's
    ``xla.py:57-63``), the mask applied as the kernel loads."""

    name = "ring"

    def __init__(self, group=None):
        super().__init__(group=group)
        self.reduce = ring_all_reduce

    def plain(self) -> RingTransport:
        out = copy.copy(self)    # shares the log
        if self.group is None:
            out.reduce = ring_all_reduce_plain
        return out

    def _sum(self, x, mask=None):
        x = x.to(torch.float32).contiguous()
        mask = None if mask is None else mask.to(torch.float32).contiguous()
        if self.group is not None:
            return ring_all_reduce_group(x[0], self.group, mask)
        return self.reduce(x, mask)

    def _mean(self, x):
        if not x.is_floating_point():
            return x[0]        # passes through, as in XlaTransport
        # a tensor divisor on x's device: tensor / python scalar rounds as a
        # multiply by the reciprocal on the card, which is not exact at M = 3
        # or 6; torch.full fills it on the device (torch.tensor would copy
        # from the host and wait for the stream)
        m = torch.full((), self._workers(x), dtype=torch.float32,
                       device=x.device)
        return (self._sum(x) / m).to(x.dtype)
