"""The port's mesh, process bootstrap and host collectives: the counterpart of
``trlx_tpu.parallel.mesh``.

The JAX package runs one controller over a ``jax.sharding.Mesh`` of four
named axes (dp, fsdp, tp, sp). The port runs SPMD, one process a card, under
``torchrun --nproc_per_node n``: ``init_distributed`` reads torchrun's
environment and joins the default process group (NCCL on CUDA, gloo on the
CPU). Of the four axes only sp (sequence parallelism: ring attention) is
ported; a mesh with dp, fsdp or tp above 1 raises (ROADMAP §A11). Every sp
rank holds the same full batch and runs the same non-attention compute; the
ring splits attention only.

An sp group is the ring's interface: ``ranks`` (the ranks this process
plays), ``size``, ``rotate`` (each rank's tensors to rank + 1), and
``scatter_seq`` / ``gather_seq`` (the sequence chunks of the ranks played,
and the full sequence back). Two implement it:

- ``DistSpGroup``: one rank a process, over a ``torch.distributed`` group;
- ``LocalSpGroup(n)``: all n ranks in one process, each rank's chunk a list
  entry. The ring body runs once a rank, and ``rotate`` hands each rank the
  chunk it would have received, so autograd routes every gradient to its
  owner. The counterpart of the JAX package's single-process mesh over
  several devices; chosen only where a caller builds it into a mesh.

Every rank issues the same collectives in the same order, in the forward,
in autograd's backward and in remat's recompute: each op waits on its own
requests before it returns, and no collective sits behind a rank-dependent
branch.
"""

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP)
# Axes over which the batch dimension is sharded.
DATA_AXES = (AXIS_DP, AXIS_FSDP)

_GLOBAL_MESH = None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed():
    """Join the default process group from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL when CUDA is available, gloo otherwise, each
    process on the card ``LOCAL_RANK``. A no-op for a single process and
    when the group exists already (a caller that built its own)."""
    if _initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo")


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_rank() -> int:
    return dist.get_rank() if _initialized() else 0


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
    """The axis sizes (``shape``, by axis name) and the sp group."""

    def __init__(self, shape: Tuple[int, ...], sp_group):
        self.shape = dict(zip(MESH_AXES, shape))
        self.sp_group = sp_group

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def __repr__(self):
        return f"Mesh({self.shape}, {type(self.sp_group).__name__})"


def make_mesh(shape: Sequence[int] = (-1, 1, 1, 1), sp_group=None) -> Mesh:
    """Build the (dp, fsdp, tp, sp) mesh over the default group's processes,
    or over ``sp_group`` (a ``LocalSpGroup``: n ranks in this process). Only
    sp may exceed 1; sp = 1 is a ring of one."""
    n = world_size() if sp_group is None else sp_group.size
    shape = resolve_mesh_shape(shape, n)
    over = [f"{a}={s}" for a, s in zip(MESH_AXES, shape) if a != AXIS_SP and s > 1]
    if over:
        raise NotImplementedError(
            f"mesh {shape}: {', '.join(over)} is not ported yet (ROADMAP §A11: data, fully sharded and tensor "
            "parallelism); the port shards the sequence over sp only, e.g. train.mesh [1, 1, 1, n]"
        )
    if sp_group is None:
        sp_group = DistSpGroup() if shape[3] > 1 else LocalSpGroup(1)
    return Mesh(shape, sp_group)


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


def barrier():
    """Every process waits for the others (a no-op for one process)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_host(value):
    """Rank 0's picklable host value on every process (identity for one
    process): decisions and host results every rank must share."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def allgather_host(x) -> np.ndarray:
    """Each process's host rows (a numpy array) → every process's rows,
    concatenated along axis 0 in rank order (``np.asarray(x)`` for one
    process)."""
    if world_size() == 1:
        return np.asarray(x)
    parts = [None] * world_size()
    dist.all_gather_object(parts, np.asarray(x))
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
    group (the default group: every process of the run)."""

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
        ops, outs = [], []
        for x in tensors:
            x = x.contiguous()
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.isend, x, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, src, self.group))
            outs.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def _all_gather(self, x: torch.Tensor):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

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
