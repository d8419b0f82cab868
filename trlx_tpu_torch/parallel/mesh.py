"""The port's mesh, process bootstrap and host collectives: the counterpart of
``trlx_tpu.parallel.mesh``.

The JAX package runs one controller over a ``jax.sharding.Mesh`` of four
named axes (dp, fsdp, tp, sp). The port runs SPMD, one process a card, under
``torchrun --nproc_per_node n``: ``init_distributed`` reads torchrun's
environment and joins the default process group (NCCL where each rank has a
card of its own, gloo on the CPU or when the caller asks for it: several
processes sharing one card). ``make_mesh`` lays the processes out in the JAX
order, (dp, fsdp, tp, sp) with sp fastest: global rank
((dp·F + fsdp)·T + tp)·S + sp. Each process knows its coordinates and holds
one ``torch.distributed`` subgroup per axis (``collectives.AxisGroup``), plus
the data group (dp × fsdp: the ranks that hold different rows of a batch).
Parameters are split over fsdp and tp by ``parallel.sharding``'s rules; the
batch is split over the data axes; every sp rank of a data rank holds the
same rows and the ring splits attention only.

**A JAX process is a host, a port process is one card.** The JAX package's
per-process quantities (``num_rollouts``, ``chunk_size``, ``batch_size``:
rows a host feeds) are per NODE here: ``node_count()`` is
``WORLD_SIZE // LOCAL_WORLD_SIZE``, and a node's ranks are consecutive (its
index is torchrun's ``GROUP_RANK``: rank // LOCAL_WORLD_SIZE). N ranks of one node run, row for row, what one JAX host runs
over an N-device mesh. Failure detection (heartbeats, fingerprints, the
collective guard) counts per rank: a port process can die alone.

An sp group is the ring's interface: ``ranks`` (the ranks this process
plays), ``size``, ``rotate`` (each rank's tensors to rank + 1), and
``scatter_seq`` / ``gather_seq`` (the sequence chunks of the ranks played,
and the full sequence back). Two implement it:

- ``DistSpGroup``: one rank a process, over the sp subgroup;
- ``LocalSpGroup(n)``: all n ranks in one process, each rank's chunk a list
  entry. The ring body runs once a rank, and ``rotate`` hands each rank the
  chunk it would have received, so autograd routes every gradient to its
  owner. The counterpart of the JAX package's single-process mesh over
  several devices; chosen only where a caller builds it into a mesh, whose
  other axes are then 1.

Every rank issues the same collectives in the same order, in the forward,
in autograd's backward and in remat's recompute: each op waits on its own
requests before it returns, and no collective sits behind a rank-dependent
branch.

**Two sets of groups.** The overlapped pipeline runs rollouts on a producer
thread (and the reward on its score worker) while the main thread trains.
Two threads must never share a communicator: their collectives would reach
it in different orders on different ranks. So ``make_mesh(...,
producer_groups=True)`` builds a second group of every axis, "data" and
"world" (and a second sp ring), after the first set and in the same order on
every rank; a thread inside ``producer_collectives()`` (the producer's, and
a score worker it starts) gets the second set from ``Mesh.group``,
``Mesh.sp_group`` and the host collectives below, every other thread the
first. Over gloo (host staging) the separate groups are enough. Over NCCL
the producer also enqueues on a stream of its own (``pipeline.overlap``),
since two communicators whose kernels share one stream in different orders
on different ranks deadlock across ranks.
"""

import os
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from trlx_tpu_torch.parallel.collectives import SOLO, AxisGroup, all_gather_object, all_gather_parts, ring_exchange

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP)
# Axes over which the batch dimension is sharded.
DATA_AXES = (AXIS_DP, AXIS_FSDP)

_GLOBAL_MESH = None
_THREAD = threading.local()  # .set: the group set this thread's collectives use


def group_set() -> str:
    """The group set of the calling thread: "producer" inside
    ``producer_collectives()``, else "main"."""
    return getattr(_THREAD, "set", "main")


@contextmanager
def producer_collectives(name: str = "producer"):
    """Within, this thread's collectives take the mesh's second group set
    (``name`` "main" restores the first, e.g. for a thread that inherits)."""
    prev = group_set()
    _THREAD.set = name
    try:
        yield
    finally:
        _THREAD.set = prev


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(backend: Optional[str] = None):
    """Join the default process group from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). NCCL when each rank of the node has a card of its own
    (``LOCAL_WORLD_SIZE`` at most the visible cards), each process on the
    card ``LOCAL_RANK``; gloo on the CPU. ``backend`` overrides the choice
    (gloo for several processes sharing one card: NCCL refuses two ranks on
    one device). More ranks than cards with no ``backend`` raises. A no-op
    for a single process and when the group exists already (a caller that
    built its own)."""
    if _initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if backend is None:
        if not torch.cuda.is_available():
            backend = "gloo"
        elif int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])) <= torch.cuda.device_count():
            backend = "nccl"
        else:
            raise RuntimeError(
                f"{os.environ.get('LOCAL_WORLD_SIZE', os.environ['WORLD_SIZE'])} ranks on this node but "
                f"{torch.cuda.device_count()} card(s): NCCL takes one rank a card; pass backend='gloo' to "
                "share a card")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend)


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def node_count() -> int:
    """The nodes of the run: ``WORLD_SIZE // LOCAL_WORLD_SIZE`` (one JAX
    host each); 1 without torchrun's ``LOCAL_WORLD_SIZE``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    n = world_size()
    if local <= 0 or n == 1:
        return 1
    if n % local:
        raise ValueError(f"WORLD_SIZE {n} is not a multiple of LOCAL_WORLD_SIZE {local}")
    return n // local


def resolve_mesh_shape(shape: Sequence[int], n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """Resolve a mesh shape with at most one -1 ("fill the remaining
    devices"): (-1, 1, 1, 1) on 8 devices is (8, 1, 1, 1). Devices are the
    processes of the default group unless ``n_devices`` is given."""
    n_devices = world_size() if n_devices is None else n_devices
    shape = tuple(int(s) for s in shape)
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape can have at most one -1, got {shape}")
    fixed = int(np.prod([s for s in shape if s != -1]))
    if -1 in shape:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed mesh product {fixed}")
        shape = tuple(n_devices // fixed if s == -1 else s for s in shape)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} devices, have {n_devices}")
    return shape


class Mesh:
    """The axis sizes (``shape``, by axis name), this process's coordinates
    (``coords``), one ``AxisGroup`` per axis, for the data axes together and
    for every process (``group(name)``: "dp", "fsdp", "tp", "sp", "data" or
    "world"), and the sp group of the ring; with ``producer`` a second set
    of both, which threads inside ``producer_collectives()`` get."""

    def __init__(self, shape: Tuple[int, ...], sp_group, coords: Tuple[int, ...] = (0, 0, 0, 0),
                 groups: Optional[dict] = None, producer: Optional[Tuple[dict, object]] = None):
        self.shape = dict(zip(MESH_AXES, shape))
        self.coords = dict(zip(MESH_AXES, coords))
        self.groups = dict(groups or {})
        self._sp = {"main": sp_group}
        self.producer_groups = None
        if producer is not None:
            self.producer_groups = dict(producer[0])
            self._sp["producer"] = producer[1]

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def _groups(self) -> dict:
        if group_set() == "main":
            return self.groups
        if self.producer_groups is None:
            if not self.groups:
                return self.groups  # one process: every group is SOLO
            raise RuntimeError("a producer thread's collectives need the mesh's second group set: "
                               "make_mesh(..., producer_groups=True)")
        return self.producer_groups

    def group(self, name: str) -> AxisGroup:
        return self._groups().get(name, SOLO)

    @property
    def sp_group(self):
        """The sp ring of the calling thread's group set."""
        if group_set() == "main" or "producer" not in self._sp:
            return self._sp["main"]
        return self._sp["producer"]

    @property
    def data_size(self) -> int:
        """dp × fsdp: the ranks that hold different rows of a batch."""
        return self.shape[AXIS_DP] * self.shape[AXIS_FSDP]

    @property
    def data_index(self) -> int:
        """This process's index over the data axes (dp slowest)."""
        return self.coords[AXIS_DP] * self.shape[AXIS_FSDP] + self.coords[AXIS_FSDP]

    @property
    def sharded(self) -> bool:
        """Parameters are split (fsdp or tp above 1)."""
        return self.shape[AXIS_FSDP] > 1 or self.shape[AXIS_TP] > 1

    def __repr__(self):
        return f"Mesh({self.shape}, {type(self.sp_group).__name__})"


def axis_lines(shape: Tuple[int, ...]) -> dict:
    """The process groups of a mesh: for each axis of size > 1 (and the data
    axes together as "data"), the lists of global ranks that vary along it
    with every other coordinate fixed, each in axis order (rank =
    np.ravel_multi_index(coords, shape): sp fastest, the JAX package's
    device order)."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    spans = {a: (i,) for i, a in enumerate(MESH_AXES)}
    spans["data"] = (0, 1)
    out = {}
    for name, axes in spans.items():
        size = int(np.prod([shape[i] for i in axes]))
        if size == 1:
            continue
        rest = [i for i in range(4) if i not in axes]
        out[name] = [[int(r) for r in line] for line in np.transpose(grid, rest + list(axes)).reshape(-1, size)]
    return out


def _axis_groups(shape: Tuple[int, ...], rank: int) -> dict:
    """One subgroup per line of ``axis_lines``: every process creates every
    group, in the same order (``new_group`` is collective), and keeps the
    ones it is in."""
    groups = {}
    for name, lines in axis_lines(shape).items():
        for ranks in lines:
            pg = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = AxisGroup(pg, ranks, ranks.index(rank), name)
    return groups


def make_mesh(shape: Sequence[int] = (-1, 1, 1, 1), sp_group=None, producer_groups: bool = False) -> Mesh:
    """Build the (dp, fsdp, tp, sp) mesh over the default group's processes
    (every process calls it: the subgroups are made collectively), or over
    ``sp_group`` (a ``LocalSpGroup``: n sp ranks in this process, every
    other axis 1). ``producer_groups``: also the second group set of the
    overlapped pipeline's threads (the module docstring), made after the
    first in the same order on every rank."""
    if sp_group is not None:
        shape = resolve_mesh_shape(shape, sp_group.size)
        if any(s > 1 for s in shape[:3]):
            raise ValueError(f"mesh {shape}: a LocalSpGroup plays sp ranks in one process; dp, fsdp and tp "
                             "need a process a rank")
        return Mesh(shape, sp_group)
    shape = resolve_mesh_shape(shape, world_size())
    rank = process_rank()
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = _axis_groups(shape, rank) if world_size() > 1 else {}
    if world_size() > 1:
        groups["world"] = AxisGroup(dist.group.WORLD, range(world_size()), rank, "world")
    sp = DistSpGroup(groups["sp"].pg) if shape[3] > 1 else LocalSpGroup(1)
    producer = None
    if producer_groups and world_size() > 1:
        second = _axis_groups(shape, rank)
        second["world"] = AxisGroup(dist.new_group(list(range(world_size()))), range(world_size()), rank, "world")
        producer = (second, DistSpGroup(second["sp"].pg) if shape[3] > 1 else LocalSpGroup(1))
    return Mesh(shape, sp, coords, groups, producer)


def set_mesh(mesh: Optional[Mesh]):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def peek_mesh() -> Optional[Mesh]:
    """The process-global mesh if one was set, else None (no side effects,
    unlike ``get_mesh``)."""
    return _GLOBAL_MESH


def get_mesh(shape: Sequence[int] = (-1, 1, 1, 1)) -> Mesh:
    """The process-global mesh, made on first use."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = make_mesh(shape)
    return _GLOBAL_MESH


def is_main_process() -> bool:
    """Rank 0: the process that writes logs, checkpoints and exports."""
    return process_rank() == 0


def _world_pg():
    """The process group of every process for the calling thread's group
    set: the default group, or the producer set's own."""
    if group_set() == "main" or _GLOBAL_MESH is None:
        return None
    return _GLOBAL_MESH.group("world").pg


def barrier(name: str = "barrier"):
    """Every process waits for the others (a no-op for one process),
    guarded by the collective deadline."""
    if world_size() > 1:
        from trlx_tpu_torch.resilience.distributed import collective_guard

        with collective_guard(f"barrier:{name}"):
            dist.barrier(group=_world_pg())


def broadcast_host(value, deadline: Optional[float] = None):
    """Rank 0's picklable host value on every process (identity for one
    process): decisions and host results every rank must share. Guarded by
    the collective deadline, or by ``deadline`` (a fleet role's wait for
    rank 0, ``fleet.runner.RoleWorld.decide``)."""
    if world_size() == 1:
        return value
    from trlx_tpu_torch.resilience.distributed import collective_guard

    box = [value]
    with collective_guard("broadcast_host", deadline=deadline):
        dist.broadcast_object_list(box, src=0, group=_world_pg())
    return box[0]


def allgather_host(x, group: Optional[AxisGroup] = None) -> np.ndarray:
    """Each process's host rows (a numpy array) → every process's rows,
    concatenated along axis 0 in rank order (in ``group``'s order over its
    ranks when given; ``np.asarray(x)`` for one process). Guarded by the
    collective deadline (``resilience.distributed.collective_guard``)."""
    if world_size() == 1 or (group is not None and group.size == 1):
        return np.asarray(x)
    from trlx_tpu_torch.resilience.distributed import collective_guard

    with collective_guard("allgather_host"):
        if group is not None:
            parts = all_gather_object(np.asarray(x), group)
        else:
            parts = [None] * world_size()
            dist.all_gather_object(parts, np.asarray(x), group=_world_pg())
    return np.concatenate(parts, axis=0)


# ---------------------------------------------------------------------------
# sp groups
# ---------------------------------------------------------------------------


def _take(x: torch.Tensor, rank: int, n: int, perm: Optional[torch.Tensor]) -> torch.Tensor:
    """Rank ``rank``'s chunk of x's sequence (dim 1), in ``perm`` order."""
    t = x.shape[1] // n
    return x.narrow(1, rank * t, t) if perm is None else x.index_select(1, perm[rank * t:(rank + 1) * t])


class LocalSpGroup:
    """All ``n`` ranks of an sp ring played in one process: every
    collective is list indexing, and autograd does the rest."""

    def __init__(self, n: int):
        self.size = int(n)
        self.ranks = tuple(range(self.size))

    def rotate(self, items):
        """Rank r's item goes to rank r + 1: rank r receives rank r − 1's."""
        return [items[(i - 1) % self.size] for i in range(self.size)]

    def scatter_seq(self, x: torch.Tensor, perm: Optional[torch.Tensor] = None):
        return [_take(x, r, self.size, perm) for r in self.ranks]

    def gather_seq(self, chunks, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = torch.cat(list(chunks), dim=1)
        return out if perm is None else out.index_select(1, torch.argsort(perm))


class DistSpGroup:
    """This process's one rank of an sp ring over a ``torch.distributed``
    group (the mesh's sp subgroup; the default group when none is given)."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = (self.rank,)
        self._global = [dist.get_global_rank(self.group, r) for r in range(self.size)]

    def _exchange(self, tensors, step: int):
        """Send each tensor to rank + step, receive each from rank − step
        (one batch of point-to-point ops), and wait."""
        dst = self._global[(self.rank + step) % self.size]
        src = self._global[(self.rank - step) % self.size]
        return ring_exchange(tensors, dst, src, self.group)

    def _all_gather(self, x: torch.Tensor):
        return all_gather_parts(x, self.size, self.group)

    def rotate(self, items):
        (item,) = items
        return [tuple(_Rotate.apply(self, *item))]

    def scatter_seq(self, x: torch.Tensor, perm: Optional[torch.Tensor] = None):
        return [_ScatterSeq.apply(x, self, perm)]

    def gather_seq(self, chunks, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        (chunk,) = chunks
        return _GatherSeq.apply(chunk, self, perm)


class _Rotate(torch.autograd.Function):
    """The ring step (``lax.ppermute`` to rank + 1): its transpose sends each
    cotangent back to rank − 1. Inputs that need no gradient (the key mask)
    get none and are not sent back."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(group._exchange(xs, +1))

    @staticmethod
    def backward(ctx, *gs):
        need = ctx.needs_input_grad[1:]
        back = iter(ctx.group._exchange([g for g, n in zip(gs, need) if n], -1))
        return (None, *[next(back) if n else None for n in need])


class _ScatterSeq(torch.autograd.Function):
    """The ring's entry: this rank's chunk of the (replicated) sequence, in
    ``perm`` order. Its transpose all-gathers the chunks' gradients, so every
    rank ends with the full gradient of the replicated input."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _take(x, group.rank, group.size, perm).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = torch.cat(ctx.group._all_gather(g), dim=1)
        if ctx.perm is not None:
            full = full.index_select(1, torch.argsort(ctx.perm))
        return full, None, None


class _GatherSeq(torch.autograd.Function):
    """The ring's exit: every rank's output chunk, all-gathered into the
    full sequence in natural order. Its transpose takes this rank's slice of
    the (replicated) cotangent, with no communication."""

    @staticmethod
    def forward(ctx, chunk, group, perm):
        ctx.group, ctx.perm = group, perm
        out = torch.cat(group._all_gather(chunk), dim=1)
        return out if perm is None else out.index_select(1, torch.argsort(perm))

    @staticmethod
    def backward(ctx, g):
        return _take(g, ctx.group.rank, ctx.group.size, ctx.perm).contiguous(), None, None
