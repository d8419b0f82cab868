"""The port's one collectives module: every dp, fsdp, tp and sp collective
goes through it (the sp ring's point-to-point exchange too, which
``mesh.py``'s ``DistSpGroup`` drives).

A mesh axis is an ``AxisGroup``: a ``torch.distributed`` subgroup with the
global ranks it spans in axis order, this process's index in it and its
backend's name. A group of size 1 is ``SOLO``, and every op on it is the
identity, so a single process runs none of this.

**Where a tensor travels, by the group's backend name, decided in
``_staged`` only.** On an NCCL group the backend's own ops run on the tensors
where they lie (CUDA). On a gloo group a CUDA tensor is staged through host
memory explicitly: copied to the host, reduced or gathered there, and copied
back; a CPU tensor is used as it is. gloo runs its ops on host memory, and
several processes that share one card (NCCL refuses two ranks on one device)
reach each other only through gloo. A sum staged through the host adds in
float32 and is cast back to the tensor's dtype (gloo has no bfloat16 sum);
NCCL sums in the tensor's dtype. Host bytes (``broadcast_bytes``) go the
other way on an NCCL group: through a buffer on this process's card, since
NCCL moves CUDA memory only. Nothing here catches an error to pick a route.

**Order.** Every rank of a group issues the same collectives in the same
order: each op here waits for its own result before it returns, and the
callers put no collective behind a rank-dependent branch (``mesh.py``'s rule
for the sp ring, kept for every axis).

**CUDA graphs.** A step that issues a collective can be captured only when
every such collective can be: an NCCL group, never a staged one
(``capturable``). ``ops/generate.py`` reads that one rule.

The autograd operators are Megatron's: ``copy_to`` (identity forward,
all-reduce backward) at the input of a column-parallel product,
``reduce_from`` (all-reduce forward, identity backward) at the output of a
row-parallel one, and ``gather_from`` (all-gather forward, own slice
backward) where replicated compute follows a sharded tensor.

``TRAFFIC`` counts, per op, the calls, the payload bytes this process put in
and the seconds spent staging through the host; ``traffic()`` reads it and
``reset_traffic()`` clears it.
"""

import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TRAFFIC = {}


def reset_traffic():
    TRAFFIC.clear()


def traffic() -> dict:
    """{op: {"calls", "bytes", "stage_s"}} since the last reset."""
    return {k: dict(v) for k, v in TRAFFIC.items()}


def _count(op: str, x: torch.Tensor, stage_s: float = 0.0):
    rec = TRAFFIC.setdefault(op, {"calls": 0, "bytes": 0, "stage_s": 0.0})
    rec["calls"] += 1
    rec["bytes"] += x.numel() * x.element_size()
    rec["stage_s"] += stage_s


class AxisGroup:
    """One mesh axis (or the data axes together) as seen by this process:
    ``ranks`` (global, in axis order), ``size``, ``rank`` (this process's
    index) and ``backend``."""

    def __init__(self, pg, ranks: Sequence[int], rank: int, name: str = ""):
        self.pg = pg
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.rank = int(rank)
        self.name = name
        self.backend = str(dist.get_backend(pg)) if pg is not None else "none"

    @property
    def capturable(self) -> bool:
        """A collective over this group can sit inside a CUDA graph."""
        return self.size == 1 or self.backend == "nccl"

    def __repr__(self):
        return f"AxisGroup({self.name}, ranks={self.ranks}, rank={self.rank}, {self.backend})"


SOLO = AxisGroup(None, (0,), 0, "solo")


def _staged(group: AxisGroup, x: torch.Tensor) -> bool:
    """The one routing rule: a CUDA tensor on a gloo group goes through host
    memory; everything else stays where it lies."""
    return group.backend == "gloo" and x.is_cuda


def _to_host(x: torch.Tensor, reduce: bool) -> torch.Tensor:
    h = x.detach().to("cpu", copy=True)
    return h.float() if reduce and h.dtype in (torch.bfloat16, torch.float16) else h


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, group: AxisGroup, op: str = "sum", _name: str = "all_reduce") -> torch.Tensor:
    """The elementwise reduction of ``x`` over the group, as a new tensor
    in x's dtype and place (``x`` itself for a group of one)."""
    if group.size == 1:
        return x
    if _staged(group, x):
        t0 = time.perf_counter()
        h = _to_host(x, reduce=True)
        stage = time.perf_counter() - t0
        dist.all_reduce(h, op=_OPS[op], group=group.pg)
        t1 = time.perf_counter()
        out = h.to(device=x.device, dtype=x.dtype)
        _count(_name, x, stage + time.perf_counter() - t1)
        return out
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=_OPS[op], group=group.pg)
    _count(_name, x)
    return out


def all_gather(x: torch.Tensor, group: AxisGroup, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    if group.size == 1:
        return x
    x = x.detach().contiguous()
    if _staged(group, x):
        t0 = time.perf_counter()
        h = x.to("cpu", copy=True)
        stage = time.perf_counter() - t0
        parts = [torch.empty_like(h) for _ in range(group.size)]
        dist.all_gather(parts, h, group=group.pg)
        t1 = time.perf_counter()
        out = torch.cat(parts, dim=dim).to(x.device)
        _count("all_gather", x, stage + time.perf_counter() - t1)
        return out
    if group.backend == "nccl":
        flat = torch.empty((group.size * x.numel(),), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(flat, x.reshape(-1), group=group.pg)
        parts = flat.view(group.size, *x.shape).unbind(0)
    else:
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x, group=group.pg)
    _count("all_gather", x)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group: AxisGroup, dim: int = 0) -> torch.Tensor:
    """This rank's part (along ``dim``, in group order) of the sum of ``x``
    over the group."""
    if group.size == 1:
        return x
    n = x.shape[dim] // group.size
    if group.backend == "nccl" and not _staged(group, x):
        src = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((n,) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, group=group.pg)
        _count("reduce_scatter", x)
        return out.movedim(0, dim).contiguous()
    # gloo: an all-to-all of the pieces (each rank sends rank j its j-th
    # piece), then the sum of the pieces received in rank order, in f32 on
    # the host for a CUDA tensor (staged by the rule above).
    staged = _staged(group, x)
    t0 = time.perf_counter()
    src = x.detach().movedim(dim, 0).contiguous()
    if staged:
        src = _to_host(src, reduce=True)
    stage = time.perf_counter() - t0
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=group.pg)
    t1 = time.perf_counter()
    out = recv.view(group.size, n, *recv.shape[1:]).sum(0)
    out = out.to(device=x.device, dtype=x.dtype).movedim(0, dim).contiguous()
    _count("reduce_scatter", x, (stage + time.perf_counter() - t1) if staged else 0.0)
    return out


def broadcast(x: torch.Tensor, group: AxisGroup, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group."""
    if group.size == 1:
        return x
    if _staged(group, x):
        h = x.detach().to("cpu", copy=True)
        dist.broadcast(h, src=group.ranks[src], group=group.pg)
        _count("broadcast", x)
        return h.to(x.device)
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=group.ranks[src], group=group.pg)
    _count("broadcast", x)
    return out


def broadcast_bytes(data: Optional[np.ndarray], nbytes: int, group: AxisGroup, src: int = 0) -> np.ndarray:
    """Group rank ``src``'s host array ``data`` (None on the other ranks)
    as ``nbytes`` host bytes (a uint8 array) on every rank; ``data`` itself
    on ``src``."""
    if group.size == 1:
        return data
    if group.rank == src:
        buf = torch.from_numpy(np.ascontiguousarray(data).reshape(-1).view(np.uint8))
    else:
        buf = torch.empty(int(nbytes), dtype=torch.uint8)
    if group.backend == "nccl":
        buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
    dist.broadcast(buf, src=group.ranks[src], group=group.pg)
    _count("broadcast", buf)
    return data if group.rank == src else buf.cpu().numpy()


def ring_exchange(tensors, dst: int, src: int, pg) -> list:
    """The sp ring's step: send each tensor to global rank ``dst`` and
    receive a tensor of its shape from ``src`` over ``pg`` (one batch of
    point-to-point ops), and wait. Returns the received tensors."""
    ops, outs = [], []
    for x in tensors:
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dst, pg))
        ops.append(dist.P2POp(dist.irecv, buf, src, pg))
        outs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def all_gather_parts(x: torch.Tensor, size: int, pg) -> list:
    """Every rank's ``x`` over ``pg`` (``size`` ranks), as a list in rank
    order (the sp ring's gather)."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return parts


def all_gather_object(obj, group: AxisGroup) -> list:
    """Every rank's picklable host object, in group order."""
    if group.size == 1:
        return [obj]
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out


# ---------------------------------------------------------------------------
# autograd operators
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Megatron's f: x unchanged; its gradient summed over the group."""
    return x if group.size == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Megatron's g: the sum of every rank's partial x; the gradient passes
    through unchanged."""
    return x if group.size == 1 else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along ``dim``, for compute that every
    rank then repeats; the gradient is this rank's slice of the (identical)
    gradient of the whole."""
    return x if group.size == 1 else _GatherFrom.apply(x, group, dim)


def global_sum(t: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """``t`` (detached) summed over ``group``; ``t`` itself without one."""
    if group is None or group.size == 1:
        return t.detach()
    return all_reduce(t.detach(), group)
