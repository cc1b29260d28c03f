"""The sharded trainer's collectives on ``torch.distributed``, with exact
transposes.

Counterparts of ``jax.lax.all_gather`` / ``psum`` / ``ppermute`` inside the
JAX package's ``shard_map``. Each differentiable collective is one
``torch.autograd.Function`` whose backward is its exact transpose:

- ``all_gather`` (concatenate every rank's rows along dim 0) <->
  ``reduce_scatter`` (sum the cotangents and keep this rank's rows);
- ``psum`` of a value every rank then holds as one replicated value: its
  cotangent is the same on every rank and passes through unchanged;
- ``ppermute`` (send to a partner rank) <-> the inverse permutation.

So the loss needs no 1/N scale: every rank back-propagates a unit cotangent
of the one replicated loss. (The JAX package divides its loss by the device
count instead, because there the transpose of psum is psum.) A step must
build the same graph on every rank, so that backward reaches the
collectives in the same order everywhere.

Transport: NCCL moves CUDA tensors; gloo moves CPU tensors. When ranks share
one card, NCCL refuses them, so they run gloo and a CUDA tensor is staged
through pinned host memory on its way in and out of each collective
(``staged``). Without a process group (one rank, no ``init_distributed``)
every collective is the identity on a one-rank group.

``timings``: set to a dict and every collective adds its seconds under its
kind (the device synchronized around it), and the host staging inside them
under ``"host_staging"``; None (the default) records nothing.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

timings: Optional[dict] = None


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def group_rank(group) -> int:
    return dist.get_rank(group) if group is not None else 0


def staged(group, x: torch.Tensor) -> bool:
    """Whether ``x`` crosses ``group`` through host memory: a CUDA tensor
    on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


@contextlib.contextmanager
def _timed(kind: str, device) -> Iterator[None]:
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[kind] = timings.get(kind, 0.0) + time.perf_counter() - t0


def _to_host(x: torch.Tensor) -> torch.Tensor:
    with _timed("host_staging", x.device):
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
    return buf


def _to_device(buf: torch.Tensor, device) -> torch.Tensor:
    with _timed("host_staging", device):
        return buf.to(device)


def all_gather_raw(x: torch.Tensor, group, kind: str = "gather") -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in group-rank order."""
    n = group_size(group)
    if group is None:
        return x.clone()
    with _timed(kind, x.device):
        src = x.contiguous()
        st = staged(group, src)
        if st:
            src = _to_host(src)
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return _to_device(out, x.device) if st else out


def reduce_scatter_raw(x: torch.Tensor, group, kind: str = "reduce_scatter") -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's block of dim 0."""
    n = group_size(group)
    if group is None:
        return x.clone()
    with _timed(kind, x.device):
        src = x.contiguous()
        st = staged(group, src)
        if st:
            src = _to_host(src)
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return _to_device(out, x.device) if st else out


def all_reduce_raw(x: torch.Tensor, group, kind: str = "psum") -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor)."""
    if group is None:
        return x.clone()
    with _timed(kind, x.device):
        st = staged(group, x)
        buf = _to_host(x) if st else x.clone().contiguous()
        dist.all_reduce(buf, group=group)
        return _to_device(buf, x.device) if st else buf


def ppermute_raw(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]],
                 kind: str = "ppermute") -> torch.Tensor:
    """``x`` moved along ``pairs`` of (source, destination) group ranks; a
    rank no pair sends to gets zeros."""
    me = group_rank(group)
    out = torch.zeros_like(x)
    send = [d for s, d in pairs if s == me]
    recv = [s for s, d in pairs if d == me]
    if group is None or not (send or recv) or (send == [me] and recv == [me]):
        return x.clone() if recv else out
    with _timed(kind, x.device):
        st = staged(group, x)
        src = _to_host(x) if st else x.contiguous()
        buf = torch.empty_like(src) if recv else None
        ops = []
        ranks = dist.get_process_group_ranks(group)
        for d in send:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], group))
        for s in recv:
            ops.append(dist.P2POp(dist.irecv, buf, ranks[s], group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if recv:
            out = _to_device(buf, x.device) if st else buf
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group = group
        return all_gather_raw(x, group, kind)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs, kind):
        ctx.group, ctx.pairs, ctx.kind = group, pairs, kind
        return ppermute_raw(x, group, pairs, kind)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.pairs]
        return ppermute_raw(g, ctx.group, inverse, ctx.kind), None, None, None


def all_gather(x: torch.Tensor, group, kind: str = "gather") -> torch.Tensor:
    """Differentiable all-gather along dim 0; backward reduce-scatters."""
    return _AllGather.apply(x, group, kind)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ranks of a value every rank then holds as
    one replicated value; backward passes the cotangent through."""
    return _PSum.apply(x, group)


def ppermute(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]],
             kind: str = "ppermute") -> torch.Tensor:
    """Differentiable ``ppermute_raw``; backward runs the inverse pairs."""
    return _PPermute.apply(x, group, tuple(pairs), kind)
