"""Collective communication over a mesh axis (port of
paddle_tpu/parallel/collective.py) on torch.distributed.

JAX runs these inside `shard_map` over a named axis; here every process
is one rank of the axis, and an axis is an `AxisGroup`: the c10d process
group of the axis's ranks (`Mesh.group(name)`, or `world_group()` for
the group `init_distributed` made). Each function is called by every
rank of the group, in the same order, and returns a new tensor as its
JAX counterpart returns a new array:

| JAX (`lax`)            | here                                       |
|------------------------|--------------------------------------------|
| psum / pmean / pmax    | all_reduce (sum, mean, max, min)           |
| all_gather             | all_gather (tiled concatenates)            |
| psum_scatter           | reduce_scatter (an all_reduce, then a part)|
| masked psum            | broadcast from `root`                      |
| ppermute               | ppermute (isend / irecv pairs)             |
| all_to_all (tiled)     | all_to_all (one all_to_all_single)         |
| axis_index / psum(1)   | axis_index / axis_size                     |

Gloo carries host tensors: a gloo group given CUDA tensors copies them
to host memory, runs the collective there and copies the result back.
It does so always, by design, so a gloo data plane has one code path
whatever the devices of its ranks.

Training differentiates through collectives, which JAX's partitioner
transposes for it. The port writes each transpose down as a
`torch.autograd.Function` (the trainer's contract,
parallel/trainer.py):

| function           | forward               | backward                      |
|--------------------|-----------------------|-------------------------------|
| copy_to_axis       | identity              | all-reduce sum                |
| reduce_from_axis   | all-reduce sum        | identity                      |
| all_reduce_mean    | all-reduce mean       | all-reduce mean               |
| gather_for_use     | all-gather            | batch axis: reduce-scatter    |
|                    |                       | mean; else the rank's slice   |
| reduce_scatter_sum | reduce-scatter sum    | all-gather / axis size        |
| broadcast          | `root`'s x            | all-reduce sum, kept by root  |
| ppermute           | send by `perm`        | send by the inverse `perm`    |
| all_to_all         | parts by rank         | the reverse all_to_all        |

`all_reduce_buckets` and `gather_for_use` move many tensors in flat
buckets, one collective a bucket, both ways: on gloo each collective
stages through host memory, so the number of calls is the cost.
`STATS` counts every
collective call of the process and its host wall time (on gloo the
call returns when the result is back; on nccl it returns once queued).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

# every collective call of the process: {"calls", "seconds"}
STATS: Dict[str, float] = {"calls": 0, "seconds": 0.0}

# the bytes of one flat bucket (all_reduce_buckets, gather_for_use): the
# LM's 141 MB of f32 gradients (chip_smoke.py's mesh_train) go in 5
# calls, and a bucket's copy in host memory (gloo) stays at tens of MB
BUCKET_BYTES = 32 << 20


def _timed(work, t0: float) -> None:
    work.wait()
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class AxisGroup:
    """The ranks of one mesh axis: a c10d process group (or backend),
    its `backend` name, this process's `rank` in it and its `size`."""

    __slots__ = ("pg", "backend", "rank", "size")

    def __init__(self, pg, backend: str):
        self.pg = pg
        self.backend = backend
        self.rank = int(pg.rank())
        self.size = int(pg.size())

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous tensor the backend can carry: host memory for
        gloo, the tensor's own device for nccl. Always a copy, so the
        collectives below never write their input."""
        if self.backend == "gloo":
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone().contiguous()


def world_group() -> AxisGroup:
    """The process's default group (the one `init_distributed` made)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.distributed.init_distributed first")
    return AxisGroup(dist.distributed_c10d._get_default_group(),
                     dist.get_backend())


def all_reduce(x: torch.Tensor, axis: AxisGroup,
               op: str = "sum") -> torch.Tensor:
    """Every rank gets the reduction of every rank's `x` (ncclAllReduce,
    all_reduce_op_handle.cc:103)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    t0 = time.perf_counter()
    buf = axis._wire(x)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _REDUCE_OPS[op]
    _timed(axis.pg.allreduce([buf], opts), t0)
    if op == "mean":
        buf = buf / axis.size
    return buf.to(x.device)


def all_gather(x: torch.Tensor, axis: AxisGroup, axis_dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's `x` in rank order: concatenated along `axis_dim`
    when `tiled`, else stacked on a new leading axis at `axis_dim`."""
    t0 = time.perf_counter()
    buf = axis._wire(x)
    outs = [torch.empty_like(buf) for _ in range(axis.size)]
    _timed(axis.pg.allgather([outs], [buf]), t0)
    out = (torch.cat(outs, dim=axis_dim) if tiled
           else torch.stack(outs, dim=axis_dim))
    return out.to(x.device)


def reduce_scatter(x: torch.Tensor, axis: AxisGroup, axis_dim: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """This rank's part (along `axis_dim`, in rank order) of the
    reduction over ranks (ReduceOpHandle, reduce_op_handle.cc:296): one
    ncclReduceScatter on nccl; gloo has no reduce-scatter, so there it is
    an all_reduce followed by the rank's part, the same values."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduce op {op!r}")
    if x.shape[axis_dim] % axis.size:
        raise ValueError(f"dim {axis_dim} of {tuple(x.shape)} does not "
                         f"split over {axis.size} ranks")
    if axis.backend != "nccl":
        return all_reduce(x, axis, op).chunk(axis.size, dim=axis_dim)[
            axis.rank].contiguous()
    t0 = time.perf_counter()
    buf = axis._wire(x.movedim(axis_dim, 0))
    out = buf.new_empty((buf.shape[0] // axis.size, *buf.shape[1:]))
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    _timed(axis.pg._reduce_scatter_base(out, buf, opts), t0)
    if op == "mean":
        out = out / axis.size
    return out.movedim(0, axis_dim).contiguous()


def _broadcast(x: torch.Tensor, axis: AxisGroup, root: int) -> torch.Tensor:
    t0 = time.perf_counter()
    buf = axis._wire(x)
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    _timed(axis.pg.broadcast([buf], opts), t0)
    return buf.to(x.device)


def _ppermute(x: torch.Tensor, axis: AxisGroup,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    t0 = time.perf_counter()
    buf = axis._wire(x)
    out = torch.zeros_like(buf)
    peer = functools.partial(dist.get_global_rank, axis.pg)
    # on nccl one ncclGroupStart/End around every pair: posted apart, a
    # ring whose ranks all send first can hang on the P2P stream (gloo
    # posts them one by one, none waited on before all are posted)
    ops = ([dist.P2POp(dist.isend, buf, peer(dst), axis.pg)
            for src, dst in perm if src == axis.rank]
           + [dist.P2POp(dist.irecv, out, peer(src), axis.pg)
              for src, dst in perm if dst == axis.rank])
    works = dist.batch_isend_irecv(ops) if ops else []
    for w in works:
        w.wait()
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return out.to(x.device)


def _all_to_all(x: torch.Tensor, axis: AxisGroup, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = axis.size
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    t0 = time.perf_counter()
    # rank j's part (along split_axis) leads, so one flat exchange
    # sends part j to rank j
    parts = x.movedim(split_axis, 0)
    parts = parts.reshape((n, parts.shape[0] // n) + tuple(parts.shape[1:]))
    buf = axis._wire(parts)
    out = torch.empty_like(buf)
    _timed(dist.all_to_all_single(out, buf, group=axis.pg, async_op=True),
           t0)
    out = out.to(x.device)
    got = [out[j].movedim(0, split_axis) for j in range(n)]
    return torch.cat(got, dim=concat_axis)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, root):
        ctx.axis, ctx.root = axis, root
        return _broadcast(x, axis, root)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.axis)
        return (total if ctx.axis.rank == ctx.root
                else torch.zeros_like(total)), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(g, ctx.axis, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.cfg = (axis, concat_axis, split_axis)
        return _all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.cfg), None, None, None


def broadcast(x: torch.Tensor, axis: AxisGroup,
              root: int = 0) -> torch.Tensor:
    """Every rank gets `root`'s `x` (ncclBcast,
    broadcast_op_handle.cc:114; JAX's masked psum). Differentiable: the
    transpose of the masked psum gives `root` the sum of every rank's
    gradient and the other ranks zeros."""
    return _Broadcast.apply(x, axis, root)


def ppermute(x: torch.Tensor, axis: AxisGroup,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Point-to-point shifts: for each (src, dst) of `perm`, rank dst
    gets rank src's `x`; a rank that no pair names as dst gets zeros, as
    `lax.ppermute` gives. Every send and receive is posted before any is
    waited on (on nccl in one group), so a ring does not deadlock.
    Differentiable: the gradient goes back by the inverse permutation."""
    return _Ppermute.apply(x, axis, tuple(perm))


def all_to_all(x: torch.Tensor, axis: AxisGroup, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """`lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`:
    `x` cut into axis-size parts along `split_axis`, part j sent to rank
    j, and the parts received joined along `concat_axis` in rank order.
    Differentiable: the gradient goes back by the reverse all_to_all."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """The indices of `tensors` in buckets of one device and dtype, each
    closed once it holds BUCKET_BYTES or more."""
    groups: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out: List[List[int]] = []
    for idx in groups.values():
        bucket: List[int] = []
        size = 0
        for i in idx:
            bucket.append(i)
            size += tensors[i].numel() * tensors[i].element_size()
            if size >= BUCKET_BYTES:
                out.append(bucket)
                bucket, size = [], 0
        if bucket:
            out.append(bucket)
    return out


def all_reduce_buckets(tensors: Sequence[torch.Tensor], axis: AxisGroup,
                       op: str = "mean") -> List[torch.Tensor]:
    """The all_reduce of every tensor of `tensors`, in flat buckets of up
    to BUCKET_BYTES of one device and dtype: one collective a bucket.
    Returns new tensors in the given order."""
    out: List[torch.Tensor] = [None] * len(tensors)
    for bucket in _buckets(tensors):
        flat = all_reduce(torch.cat(
            [tensors[k].reshape(-1) for k in bucket]), axis, op)
        for k, part in zip(bucket, flat.split(
                [tensors[k].numel() for k in bucket])):
            out[k] = part.view_as(tensors[k])
    return out


# -- differentiable collectives (the trainer's contract) ---------------------

class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis, "mean")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, "mean"), None


class _GatherForUse(torch.autograd.Function):
    """Shards of one dtype gathered over `axis` through one flat buffer:
    forward one all-gather, backward one reduce-scatter mean (a batch
    axis) or the rank's own slice. Rank r's part of a leaf is row r's
    span of the buffer, contiguous, so it is viewed, never copied."""

    @staticmethod
    def forward(ctx, axis, dims, batch, *xs):
        ctx.axis, ctx.dims, ctx.batch = axis, dims, batch
        ctx.shapes = [x.shape for x in xs]
        rows = all_gather(torch.cat([x.reshape(-1) for x in xs]), axis,
                          tiled=False)                    # [ranks, N]
        outs, off = [], 0
        for x, d in zip(xs, dims):
            n = x.numel()
            outs.append(torch.cat([rows[r, off:off + n].view(x.shape)
                                   for r in range(axis.size)], d))
            off += n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        axis = ctx.axis
        if ctx.batch:
            rows = gs[0].new_empty((axis.size,
                                    sum(s.numel() for s in ctx.shapes)))
            off = 0
            for g, d, s in zip(gs, ctx.dims, ctx.shapes):
                for r, part in enumerate(g.chunk(axis.size, d)):
                    rows[r, off:off + s.numel()].view(s).copy_(part)
                off += s.numel()
            mine = reduce_scatter(rows, axis, 0, "mean")[0]
        else:
            mine = torch.cat([g.chunk(axis.size, d)[axis.rank].reshape(-1)
                              for g, d in zip(gs, ctx.dims)])
        parts = mine.split([s.numel() for s in ctx.shapes])
        return (None, None, None,
                *(p.view(s) for p, s in zip(parts, ctx.shapes)))


class _ReduceScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim) / ctx.axis.size, None, None


def copy_to_axis(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """`x` as it is; its gradient summed over the axis's ranks: the
    input of a column-parallel layer, whose ranks each give part of the
    input's gradient."""
    return _CopyToAxis.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum of every rank's `x`; the gradient passed through as it is:
    the output of a row-parallel layer, whose consumers are replicated
    over the axis."""
    return _ReduceFromAxis.apply(x, axis)


def all_reduce_mean(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The mean of every rank's `x`, with the mean of the ranks'
    gradients as its gradient (the batch statistics of sync-BN)."""
    return _AllReduceMean.apply(x, axis)


def gather_for_use(xs: Sequence[torch.Tensor], axis: AxisGroup,
                   dims: Sequence[int], batch: bool) -> List[torch.Tensor]:
    """Every rank's shard of each tensor of `xs` joined along its dim of
    `dims` (leaves the forward needs whole), in flat buckets of up to
    BUCKET_BYTES: one all-gather a bucket. Backward over a batch axis
    (`batch`, whose ranks hold different data) the reduce-scatter mean
    of the ranks' gradients, one a bucket; over an axis the compute is
    replicated on, each rank's own slice."""
    out: List[torch.Tensor] = [None] * len(xs)
    for bucket in _buckets(xs):
        done = _GatherForUse.apply(axis, tuple(dims[k] for k in bucket),
                                   batch, *(xs[k] for k in bucket))
        for k, t in zip(bucket, done):
            out[k] = t
    return out


def reduce_scatter_sum(x: torch.Tensor, axis: AxisGroup,
                       dim: int = 0) -> torch.Tensor:
    """This rank's part along `dim` of the sum over ranks; backward the
    ranks' gradients gathered and divided by the axis size (over a batch
    axis, each rank's loss is its part of the global mean)."""
    return _ReduceScatterSum.apply(x, axis, dim)


def ring_perm(n: int, shift: int = 1) -> Tuple[Tuple[int, int], ...]:
    """The ring's pairs for `ppermute`: rank i's value to rank i + shift
    (mod n)."""
    return tuple((i, (i + shift) % n) for i in range(n))


def axis_index(axis: AxisGroup) -> int:
    return axis.rank


def axis_size(axis: AxisGroup) -> int:
    return axis.size


def barrier(axis: AxisGroup) -> None:
    """A collective that orders phases: no rank leaves before every rank
    has entered (send_barrier / fetch_barrier)."""
    all_reduce(torch.zeros(()), axis)


__all__ = ["AxisGroup", "STATS", "all_gather", "all_reduce", "all_to_all",
           "all_reduce_buckets", "all_reduce_mean", "axis_index",
           "axis_size", "barrier", "broadcast", "copy_to_axis",
           "gather_for_use", "ppermute", "reduce_from_axis",
           "reduce_scatter", "reduce_scatter_sum", "ring_perm",
           "world_group"]
