"""Collectives over a named mesh dim, differentiable, and the allreduce
bandwidth probe (port of ``tpu_composer/parallel/collectives.py``).

Each op takes a local tensor, a ``DeviceMesh`` and a dim name; over a dim
of size 1 (or without a mesh) it returns its input. Each is a
``torch.autograd.Function`` whose backward is the JAX transpose, so a
sharded region's entry and exit are conjugate pairs:

- :func:`shard` keeps this rank's slice of a replicated tensor; its
  backward gathers the slices' cotangents (the sum over the dim of each
  rank's zero-padded slice);
- :func:`all_gather` rebuilds a replicated tensor from the slices; its
  backward keeps this rank's slice of the (replicated) cotangent;
- :func:`enter_parallel` passes a replicated tensor into a region where
  each rank computes part of its consumers; its backward sums the
  partial cotangents over the dim;
- :func:`all_reduce` sums the partial results at the region's exit; its
  backward passes the replicated cotangent through;
- :func:`ppermute` (and :func:`ring_shift`, which sends to
  ``(i + shift) % n``) is transposed by the inverse permutation,
  :func:`all_to_all` by the reverse all-to-all and
  :func:`reduce_scatter` by the gather.

Transport: NCCL takes CUDA tensors. gloo, the backend of several ranks
on one card (NCCL refuses two ranks on one GPU), takes host tensors, so
under gloo every op stages a CUDA tensor through the host, one explicit
branch in :func:`_to_wire`. Every kernel still runs on the card.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.parallel.mesh import axis_size


def backend(mesh: Optional[DeviceMesh]) -> str:
    """The transport between the mesh's ranks ("gloo", "nccl"), or
    "none" for a single device."""
    if mesh is None or not dist.is_initialized():
        return "none"
    return str(dist.get_backend())


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend takes it: gloo reads host memory, so
    a CUDA tensor crosses through the host; NCCL reads it in place."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().contiguous().cpu()
    return x.detach().contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = _to_wire(x, group).clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = _to_wire(x, group)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = _to_wire(x, group)
    parts = [c.contiguous() for c in
             t.chunk(dist.get_world_size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.device)


def _exchange(x: torch.Tensor, group, split: int, concat: int
              ) -> torch.Tensor:
    n = dist.get_world_size(group)
    t = _to_wire(x, group)
    send = torch.stack(t.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat).to(x.device)


def _permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """What arrives here when each rank ``src`` of ``perm``'s (src, dst)
    pairs (a bijection of group ranks) sends ``x`` to ``dst``."""
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    dst = next(d for s, d in perm if s == me)
    src = next(s for s, d in perm if d == me)
    if dst == me:
        return x.clone()
    t = _to_wire(x, group)
    recv = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[dst], group),
           dist.P2POp(dist.irecv, recv, ranks[src], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[me].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _exchange(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.concat, ctx.split), None, None, \
            None


def all_reduce(x, mesh: Optional[DeviceMesh], dim: str):
    """Sum over mesh dim ``dim`` (``psum``) of partial results whose sum
    is used replicated; the backward passes the cotangent through."""
    if axis_size(mesh, dim) == 1:
        return x
    return _AllReduce.apply(x, mesh.get_group(dim))


def enter_parallel(x, mesh: Optional[DeviceMesh], dim: str):
    """The identity, whose backward sums the cotangent over ``dim``: the
    entry of a replicated tensor into a region where each rank of
    ``dim`` computes a different part of what consumes it."""
    if axis_size(mesh, dim) == 1:
        return x
    return _EnterParallel.apply(x, mesh.get_group(dim))


def all_gather(x, mesh: Optional[DeviceMesh], dim: str, axis: int = 0):
    """Concatenate every rank's ``x`` along tensor axis ``axis`` in rank
    order (tiled ``all_gather``); the backward keeps this rank's slice."""
    if axis_size(mesh, dim) == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(dim), axis)


def shard(x, mesh: Optional[DeviceMesh], dim: str, axis: int = 0):
    """This rank's slice of a replicated ``x`` along ``axis``; the
    backward gathers the slices' cotangents."""
    if axis_size(mesh, dim) == 1:
        return x
    return _Shard.apply(x, mesh.get_group(dim), axis)


def reduce_scatter(x, mesh: Optional[DeviceMesh], dim: str,
                   scatter_dimension: int = 0):
    """Sum over ``dim`` and keep this rank's slice along
    ``scatter_dimension`` (tiled ``psum_scatter``)."""
    if axis_size(mesh, dim) == 1:
        return x
    return _ReduceScatter.apply(x, mesh.get_group(dim), scatter_dimension)


def ppermute(x, mesh: Optional[DeviceMesh], dim: str,
             perm: Sequence[Tuple[int, int]]):
    """Send ``x`` along the (src, dst) pairs of ``perm``, indices along
    ``dim`` (``ppermute``: a bijection); the backward sends the
    cotangents back along the inverse pairs."""
    if axis_size(mesh, dim) == 1:
        return x
    return _Permute.apply(x, mesh.get_group(dim), tuple(perm))


def ring_shift(x, mesh: Optional[DeviceMesh], dim: str, shift: int = 1):
    """Rotate shards around the ``dim`` ring: rank i sends ``x`` to rank
    (i + shift) % n, the building block of ring attention."""
    n = axis_size(mesh, dim)
    return ppermute(x, mesh, dim, [(i, (i + shift) % n) for i in range(n)])


def all_to_all(x, mesh: Optional[DeviceMesh], dim: str, split_axis: int,
               concat_axis: int):
    """Split ``x`` into n chunks along ``split_axis``, send chunk j to
    rank j, and concatenate what arrives along ``concat_axis`` in rank
    order (tiled ``all_to_all``)."""
    if axis_size(mesh, dim) == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(dim), split_axis, concat_axis)


def sum_over_(t: torch.Tensor, mesh: Optional[DeviceMesh],
              dims: Iterable[str]) -> None:
    """Sum ``t`` over every mesh dim in ``dims``, in place (no gradient):
    the train step's reduction of gradients."""
    for name in dims:
        if axis_size(mesh, name) > 1:
            t.copy_(_sum(t, mesh.get_group(name)))


def sum_over_world(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the default group (no gradient)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    return _sum(x, dist.group.WORLD)


def allreduce_bandwidth_gbps(mesh: Optional[DeviceMesh] = None,
                             size_mb: float = 64.0, iters: int = 10,
                             dtype: torch.dtype = torch.bfloat16) -> float:
    """Allreduce bus bandwidth (GB/s) over every rank of ``mesh``:
    each rank contributes its own buffer of ``size_mb`` MB and the sum
    reaches every rank; NCCL's busbw convention, 2·(n−1)/n × bytes over
    the time. One device (or no mesh): 0.0, as the JAX package reports.
    Under gloo the time includes the staging through the host
    (:func:`backend` names the transport)."""
    n = 1 if mesh is None else mesh.size()
    if n < 2:
        return 0.0
    group = dist.group.WORLD
    elems = int(size_mb * 1e6 / torch.tensor([], dtype=dtype).element_size())
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    x = torch.ones(elems, dtype=dtype, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    _sum(x, group)  # warm up the connections
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        _sum(x, group)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return 2 * (n - 1) / n * x.numel() * x.element_size() / dt / 1e9
