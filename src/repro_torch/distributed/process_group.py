"""One worker a process: the port's ``torch.distributed`` world.

The reference has no counterpart: JAX is single-controller, and one program
sees every device of its mesh.  Here each worker is a process of a
``torch.distributed`` process group, holds its own rows on its own device,
and reduces with collectives (``comm.XlaTransport(group=)``,
``comm.RingTransport(group=)``).  ``Topology.make_groups`` cuts the world
into a group for each tier, as the reference's ``make_mesh`` cuts a device
grid into axes.

The backend, chosen once by ``choose_backend``:

  * ``"gloo"`` on the CPU;
  * ``"nccl"`` on the card when every rank of a machine has a card of its
    own (the local world is no larger than the card count);
  * ``"gloo"`` over CUDA tensors when ranks share a card: NCCL refuses two
    ranks on one device.  gloo reduces CUDA tensors itself for the ops in
    ``GLOO_CUDA_OPS`` (through host memory, inside gloo); the collectives
    here copy a CUDA tensor to the host and back around every other op,
    because gloo's other ops do not take CUDA tensors (its send/recv aborts
    the process on one, on an H100 with PyTorch 2.11).  The ring's hops
    never go through gloo on the card: they run the hop kernel over CUDA
    IPC (``comm.ring.ring_all_reduce_group``).

Each rank's device is ``cuda:{LOCAL_RANK % device_count}``, or the CPU when
the caller asks for it; asking for CUDA where there is none raises
(``device.resolve``), and no rank carries on on the CPU.

``init`` reads a torchrun world (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or takes ``rank``, ``world_size`` and a
``dist.FileStore``; ``spawn`` runs a function in local processes on a
``FileStore`` under a temporary directory, as the tests do.  ``current()``
is this process's ``World``, whose ``topology`` every rank knows (flat unless
the caller sets another with ``set_topology``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.topology import Topology

#: Collectives gloo runs on CUDA tensors itself (their names in
#: ``torch.distributed``); checked on an H100 with gloo from PyTorch 2.11.
#: Any other op on a CUDA tensor under gloo is staged through the host
#: here.
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@dataclasses.dataclass
class World:
    """This process's place in the world."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str
    topology: Topology
    #: the ranks on this machine (torchrun's LOCAL_WORLD_SIZE)
    local_world_size: int = 1


_world: World | None = None


def choose_backend(device: torch.device, *, local_world_size: int,
                   device_count: int) -> str:
    """``"gloo"`` on the CPU; on the card ``"nccl"`` when every local rank
    has a card of its own, else ``"gloo"`` (ranks share a card)."""
    if device.type == "cpu":
        return "gloo"
    return "nccl" if local_world_size <= device_count else "gloo"


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init(backend: str | None = None, *, rank: int | None = None,
         world_size: int | None = None, store=None,
         device: str | torch.device | None = None) -> World:
    """Join the world and return it.  ``rank`` / ``world_size`` default to
    torchrun's ``RANK`` / ``WORLD_SIZE``; without a ``store`` the group
    meets at ``MASTER_ADDR:MASTER_PORT`` (``env://``).  ``backend=None``
    takes ``choose_backend``'s, printed on rank 0."""
    global _world
    if _world is not None:
        raise RuntimeError("process_group.init: this process is already in "
                           "a world; call destroy() first")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("process_group.init needs rank and world_size, or "
                         "torchrun's RANK and WORLD_SIZE")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside 0..{world_size - 1}")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    dev = device_lib.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    chosen = backend or choose_backend(dev, local_world_size=local_world,
                                       device_count=n_cards)
    kw = {"backend": chosen, "rank": rank, "world_size": world_size}
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    if chosen == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    _world = World(rank=rank, world_size=world_size, local_rank=local_rank,
                   device=dev, backend=chosen,
                   topology=Topology.flat(world_size),
                   local_world_size=local_world)
    if rank == 0:
        why = ("the CPU" if dev.type == "cpu" else
               f"{local_world} local rank(s) on {n_cards} card(s)")
        print(f"process group: backend {chosen} ({why}), world "
              f"{world_size}, device {dev.type}", flush=True)
    return _world


def current() -> World:
    """This process's world; raises outside one."""
    if _world is None:
        raise RuntimeError("not in a process-group world: call "
                           "process_group.init (or run under spawn)")
    return _world


def in_world() -> bool:
    return _world is not None


def ranks_per_device() -> int:
    """How many ranks of this machine share this rank's device: the local
    world on the CPU, and on the card the local ranks whose card is this
    rank's (``LOCAL_RANK % device_count``)."""
    w = current()
    if w.device.type != "cuda":
        return w.local_world_size
    n = torch.cuda.device_count()
    return sum(1 for r in range(w.local_world_size)
               if r % n == w.local_rank % n)


def set_topology(topology: Topology) -> None:
    """The topology every rank runs under (the launcher's ``--hosts``);
    it must hold the world's ranks."""
    w = current()
    if topology.total_workers != w.world_size:
        raise ValueError(
            f"a {topology.describe()} topology holds "
            f"{topology.total_workers} workers, the world has "
            f"{w.world_size} ranks")
    w.topology = topology


def world_group():
    """A new process group spanning the world in rank order: a caller's
    own, so its collectives never share a group with another thread's."""
    import numpy as np

    from repro_torch.topology import grid_groups
    return grid_groups(np.arange(current().world_size), ("world",)).groups[0]


def destroy() -> None:
    """Release the ring's staging buffers and leave the world."""
    global _world
    if _world is None:
        return
    from repro_torch.comm import ring
    ring.release_group_buffers()
    dist.destroy_process_group()
    _world = None


# -- collectives on tensors of this rank's device ------------------------------

def _staged(op: str, t: torch.Tensor) -> bool:
    """Does op on t go through host memory (gloo, a CUDA tensor, an op gloo
    does not run on CUDA tensors)?"""
    return (t.device.type == "cuda" and current().backend == "gloo"
            and op not in GLOO_CUDA_OPS)


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index inside ``group``."""
    return dist.get_rank(group)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """t reduced over the group (``"sum"``, ``"min"`` or ``"max"``), in
    place; returns t."""
    if _staged("all_reduce", t):
        host = t.cpu()
        dist.all_reduce(host, op=_OPS[op], group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's t stacked in the group's order: (group size, ...)."""
    p = group_size(group)
    src = t.contiguous()
    if _staged("all_gather", src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(p)]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """t from the group's rank ``src`` onto every member, in place (every
    rank passes a tensor of the same shape and dtype); returns t."""
    root = src if group is None else dist.get_global_rank(group, src)
    if _staged("broadcast", t):
        host = t.cpu()
        dist.broadcast(host, src=root, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=root, group=group)
    return t


def all_gather_object(obj, group=None) -> list:
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group=None) -> None:
    dist.barrier(group=group)


# -- collectives inside autograd (Megatron's conjugate pair) ------------------------

def _f32_sum(t: torch.Tensor, group, scope: str | None = None
             ) -> torch.Tensor:
    """A new tensor: the f32 sum of t over the group, cast back to t's
    dtype."""
    return reduce_along(t, group, scope=scope).to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, sum over the group backward: the input of a
    computation every rank of the group holds the same of, whose
    ranks' shares of the gradient add up (the experts of expert
    parallelism, the stages of a pipeline)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.scope = group, current_scope()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _f32_sum(g, ctx.group, ctx.scope), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward, identity backward: the output of a
    computation split over the group, every rank's downstream the same."""

    @staticmethod
    def forward(ctx, x, group):
        return _f32_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """Sum over the group both ways: a statistic of every rank's own data
    that each rank's loss reads whole, its gradients averaged over the
    group afterwards (a data-parallel batch's shares)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.scope = group, current_scope()
        return _f32_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _f32_sum(g, ctx.group, ctx.scope), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverGroup.apply(x, group)


# -- the placement's collectives, recorded ----------------------------------------
#
# The tensor-parallel placement (``models.common.Placed``) moves activations
# and weights with the collectives below.  Each appends a ``Collective`` to
# every open ``CollectiveLog`` (``record_collectives``): its kind under the
# reference's HLO name, the axis, and its RESULT bytes on this rank, as the
# reference's ``hlo_analysis`` counts a collective.  Over a ``RecordingGroup``
# (a layout that only records: ``RecordingLayout``) nothing moves, and on
# the ``meta`` device nothing is computed: the dry run runs a cell's step so
# (``distributed.hlo_analysis.lower_cell``).

@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str          # all-gather | reduce-scatter | all-reduce
    axis: str          # a recording group's axis; "" over a real group
    nbytes: int        # the result's bytes on this rank
    scope: str         # "" outside a layer loop, else the stack's name


class CollectiveLog:
    """The ``Collective``s of the placement, in call order."""

    def __init__(self):
        self.records: list[Collective] = []

    def bytes_by_kind(self) -> dict:
        out: dict = {}
        for r in self.records:
            out[r.kind] = out.get(r.kind, 0) + r.nbytes
        return out


_logs: list[CollectiveLog] = []
_scope = [""]


@contextlib.contextmanager
def record_collectives(log: CollectiveLog | None = None):
    """Append the placement's collectives to ``log`` (a new one by
    default) while the block runs; yields the log."""
    log = CollectiveLog() if log is None else log
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


@contextlib.contextmanager
def collective_scope(name: str):
    """Tag the collectives of the block with ``name`` (a layer stack's,
    whose records the dry run multiplies by its layer count)."""
    _scope.append(name)
    try:
        yield
    finally:
        _scope.pop()


def current_scope() -> str:
    return _scope[-1]


def _note(kind: str, group, out: torch.Tensor, scope: str | None) -> None:
    """Record a collective; ``scope`` is the one its forward ran in (a
    backward runs after the layer loop has left its scope)."""
    if _logs:
        axis = group.axis if isinstance(group, RecordingGroup) else ""
        rec = Collective(kind, axis, out.numel() * out.element_size(),
                         _scope[-1] if scope is None else scope)
        for log in _logs:
            log.records.append(rec)


@dataclasses.dataclass(frozen=True)
class RecordingGroup:
    """One axis of a ``RecordingLayout``: its size and this rank's index;
    a collective over it records and moves nothing."""

    axis: str
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class RecordingLayout:
    """A layout that only records, with the part of ``topology.Groups``'
    interface the placement reads (``axes``, ``shape``, ``coords``,
    ``group``): the rank at ``coords`` of a grid of ``shape``."""

    axes: tuple
    shape: tuple
    coords: tuple

    @classmethod
    def of(cls, sizes: dict, coords: dict | None = None
           ) -> "RecordingLayout":
        coords = coords or {}
        return cls(tuple(sizes), tuple(int(v) for v in sizes.values()),
                   tuple(int(coords.get(a, 0)) for a in sizes))

    def group(self, axis: str) -> RecordingGroup:
        i = self.axes.index(axis)
        return RecordingGroup(axis, self.shape[i], self.coords[i])


def size_of(group) -> int:
    return group.size if isinstance(group, RecordingGroup) else \
        group_size(group)


def rank_of(group) -> int:
    return group.rank if isinstance(group, RecordingGroup) else \
        group_rank(group)


def gather_along(t: torch.Tensor, dim: int, group,
                 scope: str | None = None) -> torch.Tensor:
    """Every rank's t concatenated along ``dim`` in the group's order (an
    all-gather)."""
    p = size_of(group)
    if p == 1:      # a group of one moves nothing (nor does XLA's)
        return t
    if isinstance(group, RecordingGroup):
        shape = list(t.shape)
        shape[dim] *= p
        out = t.new_empty(shape)
    else:
        out = torch.cat(tuple(all_gather(t, group)), dim=dim)
    _note("all-gather", group, out, scope)
    return out


def reduce_along(t: torch.Tensor, group, op: str = "sum",
                 scope: str | None = None) -> torch.Tensor:
    """A new f32 tensor: t's sum (or max) over the group (an all-reduce;
    a bf16 t is summed in f32)."""
    out = t.to(torch.float32, copy=True).contiguous()
    if size_of(group) == 1:
        return out
    if not isinstance(group, RecordingGroup):
        all_reduce(out, op, group)
    _note("all-reduce", group, out, scope)
    return out


def reduce_scatter_along(t: torch.Tensor, dim: int, group,
                         scope: str | None = None) -> torch.Tensor:
    """This rank's slice along ``dim`` of t's f32 sum over the group (a
    reduce-scatter).  gloo takes no reduce-scatter of CUDA tensors, so it
    runs as an all-reduce and a slice; it is recorded as what it is."""
    p, r = size_of(group), rank_of(group)
    n = t.shape[dim] // p
    if p == 1:
        return t.to(torch.float32, copy=True)
    if isinstance(group, RecordingGroup):
        shape = list(t.shape)
        shape[dim] = n
        out = t.new_empty(shape, dtype=torch.float32)
    else:
        full = t.to(torch.float32, copy=True).contiguous()
        all_reduce(full, "sum", group)
        out = full.narrow(dim, r * n, n).contiguous()
    _note("reduce-scatter", group, out, scope)
    return out


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along a dim forward, reduce-scatter backward: a shard
    (of the sequence, of a weight) entering a computation whose ranks each
    hold a partial of its gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.scope = dim, group, current_scope()
        return gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_along(g, ctx.dim, ctx.group,
                                     ctx.scope).to(g.dtype), None, None)


class _ScatterToGroup(torch.autograd.Function):
    """Reduce-scatter along a dim forward, all-gather backward: a partial
    (a row-parallel product) leaving as this rank's shard of the sum."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.scope = dim, group, current_scope()
        return reduce_scatter_along(x, dim, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (gather_along(g.contiguous(), ctx.dim, ctx.group, ctx.scope),
                None, None)


class _SplitToGroup(torch.autograd.Function):
    """This rank's slice along a dim forward, the slice's gradient padded
    with zeros backward (no collective): a value every rank holds whole
    leaving as this rank's shard; its gradient is then each rank's partial
    of the whole one."""

    @staticmethod
    def forward(ctx, x, dim, group):
        p, r = size_of(group), rank_of(group)
        n = x.shape[dim] // p
        ctx.dim, ctx.at, ctx.full = dim, r * n, x.shape[dim]
        return x.narrow(dim, r * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.full
        out = g.new_zeros(shape)
        out.narrow(ctx.dim, ctx.at, g.shape[ctx.dim]).copy_(g)
        return out, None, None


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherFromGroup.apply(x, dim, group)


def scatter_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shard of x's sum over the group (summed in f32, cast back to
    x's dtype)."""
    return _ScatterToGroup.apply(x, dim, group)


def split_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _SplitToGroup.apply(x, dim, group)


# -- local worlds ---------------------------------------------------------------

def _child(rank: int, fn, nprocs: int, store_path: str, out_dir: str,
           device, args) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, nprocs)
    world = init(rank=rank, world_size=nprocs, store=store, device=device)
    try:
        result = fn(rank, world, *args)
    finally:
        destroy()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(fn, nprocs: int, *args, device: str | torch.device | None = None
          ) -> list:
    """Run ``fn(rank, world, *args)`` in ``nprocs`` local processes, joined
    on a ``FileStore`` under a temporary directory; returns each rank's
    result (picklable), in rank order.  A rank's exception is raised here,
    naming the rank."""
    import torch.multiprocessing as mp
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    dev = str(device_lib.resolve(device))
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        try:
            mp.start_processes(
                _child, args=(fn, nprocs, os.path.join(tmp, "store"), tmp,
                              dev, args),
                nprocs=nprocs, start_method="spawn")
        except mp.ProcessRaisedException as e:
            raise RuntimeError(f"rank {e.error_index} of {nprocs} failed:\n"
                               f"{e}") from None
        except mp.ProcessExitedException as e:
            raise RuntimeError(f"rank {e.error_index} of {nprocs} exited "
                               f"with code {e.exit_code}") from None
        results = []
        for r in range(nprocs):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
