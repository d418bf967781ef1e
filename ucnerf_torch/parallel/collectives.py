"""Collectives with exact adjoints, for what ``shard_map`` gives JAX.

The rule of every multi-rank step: each rank computes the replicated
loss, and the gradient of each replicated parameter is the mean over the
ranks of its local gradient (``average_gradients``).  A collective inside
the loss must then carry each rank's share back to it:

- ``all_gather`` (per-ray outputs, concatenated in rank order): its
  adjoint is a sum reduce-scatter.  Every rank holds the same cotangent
  of the gathered tensor, so its slice comes back summed over the N
  ranks, N times its own share, and the mean over ranks gives the
  serial gradient.
- ``all_reduce_sum`` (the view-sharded cascade's partial sums): its
  adjoint is an all-reduce of the cotangents, for the same reason.

Both are built on ``dist.all_reduce``, which NCCL and gloo both run on
CUDA tensors (gloo has no reduce-scatter, and gathers only host
tensors): the gather sums a zero buffer that holds each rank's slice at
its offset, which is exact.  ``STATS`` accumulates the milliseconds of
each kind (``<kind>_ms``); each call synchronizes the device before and
after it, so the time includes the wait for the slowest rank.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

STATS = collections.defaultdict(float)


def reset_stats():
    STATS.clear()


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _all_reduce(t: torch.Tensor, group, kind: str):
    _sync(t)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _sync(t)
    STATS[f"{kind}_ms"] += (time.perf_counter() - t0) * 1e3


def gather_rows(x: torch.Tensor, group, kind: str = "gather"):
    """[m, ...] on each of the group's N ranks -> [N*m, ...], rank order;
    no autograd."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0]
    out = x.new_zeros((n * m, *x.shape[1:]))
    out[r * m:(r + 1) * m] = x
    _all_reduce(out, group, kind)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group, "gather_grad")
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _all_reduce(y, group, "reduce")
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group, "reduce_grad")
        return g, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Rows of every rank of ``group`` in rank order; backward is the sum
    reduce-scatter."""
    return _AllGather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group``; backward all-reduces the
    cotangents."""
    return _AllReduceSum.apply(x, group)


def average_gradients(params, group):
    """Each parameter's ``.grad`` becomes its mean over the ranks of
    ``group``: one all-reduce of the gradients flattened in order.  Every
    rank passes the same parameters in the same order."""
    grads = [p.grad for p in params]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat, group, "grad_allreduce")
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_metrics(metrics: dict, group) -> dict:
    """Each (detached, scalar) metric's mean over the ranks of ``group``."""
    names = sorted(metrics)
    vals = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                        for k in names])
    _all_reduce(vals, group, "metrics")
    vals /= dist.get_world_size(group)
    return dict(zip(names, vals.unbind()))


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` in place as rank ``src`` of ``group`` holds it."""
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t
