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
| axis_index / psum(1)   | axis_index / axis_size                     |

Gloo carries host tensors: a gloo group given CUDA tensors copies them
to host memory, runs the collective there and copies the result back.
It does so always, by design, so a gloo data plane has one code path
whatever the devices of its ranks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

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
    buf = axis._wire(x)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _REDUCE_OPS[op]
    axis.pg.allreduce([buf], opts).wait()
    if op == "mean":
        buf = buf / axis.size
    return buf.to(x.device)


def all_gather(x: torch.Tensor, axis: AxisGroup, axis_dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's `x` in rank order: concatenated along `axis_dim`
    when `tiled`, else stacked on a new leading axis at `axis_dim`."""
    buf = axis._wire(x)
    outs = [torch.empty_like(buf) for _ in range(axis.size)]
    axis.pg.allgather([outs], [buf]).wait()
    out = (torch.cat(outs, dim=axis_dim) if tiled
           else torch.stack(outs, dim=axis_dim))
    return out.to(x.device)


def reduce_scatter(x: torch.Tensor, axis: AxisGroup, axis_dim: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """This rank's part (along `axis_dim`, in rank order) of the
    reduction over ranks (ReduceOpHandle, reduce_op_handle.cc:296). Gloo
    has no reduce-scatter, so every backend takes it as an all_reduce
    followed by the rank's part: the same values."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduce op {op!r}")
    if x.shape[axis_dim] % axis.size:
        raise ValueError(f"dim {axis_dim} of {tuple(x.shape)} does not "
                         f"split over {axis.size} ranks")
    return all_reduce(x, axis, op).chunk(axis.size, dim=axis_dim)[
        axis.rank].contiguous()


def broadcast(x: torch.Tensor, axis: AxisGroup,
              root: int = 0) -> torch.Tensor:
    """Every rank gets `root`'s `x` (ncclBcast,
    broadcast_op_handle.cc:114)."""
    buf = axis._wire(x)
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    axis.pg.broadcast([buf], opts).wait()
    return buf.to(x.device)


def ppermute(x: torch.Tensor, axis: AxisGroup,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Point-to-point shifts: for each (src, dst) of `perm`, rank dst
    gets rank src's `x`; a rank that no pair names as dst gets zeros, as
    `lax.ppermute` gives. Sends are posted before receives, so a ring
    does not deadlock."""
    buf = axis._wire(x)
    out = torch.zeros_like(buf)
    works = [axis.pg.send([buf], dst, 0) for src, dst in perm
             if src == axis.rank]
    works += [axis.pg.recv([out], src, 0) for src, dst in perm
              if dst == axis.rank]
    for w in works:
        w.wait()
    return out.to(x.device)


def ring_perm(n: int, shift: int = 1) -> Tuple[Tuple[int, int], ...]:
    return tuple((i, (i + shift) % n) for i in range(n))


def axis_index(axis: AxisGroup) -> int:
    return axis.rank


def axis_size(axis: AxisGroup) -> int:
    return axis.size


def barrier(axis: AxisGroup) -> None:
    """A collective that orders phases: no rank leaves before every rank
    has entered (send_barrier / fetch_barrier)."""
    all_reduce(torch.zeros(()), axis)


__all__ = ["AxisGroup", "all_gather", "all_reduce", "axis_index",
           "axis_size", "barrier", "broadcast", "ppermute",
           "reduce_scatter", "ring_perm", "world_group"]
