"""Collectives of the parallel layer as autograd Functions on
``torch.distributed`` process groups: the counterparts of ``lax.psum``,
``lax.all_gather`` and ``lax.ppermute``, which the JAX package leaves to
GSPMD and shard_map (transformer_stm_tpu/parallel/).

What a collective's backward must do depends on what the ranks do with its
result, so each use names its rule:

- ``all_reduce_sum(x, group, grad)``: the sum of the ranks' x.  With
  ``grad="identity"`` every rank then computes the same loss from the sum
  (a row-parallel product under tensor parallelism), and the gradient of a
  rank's x is the gradient of the sum.  With ``grad="sum"`` each rank
  feeds the sum into a loss of its own and the losses add up (BatchNorm
  statistics synced over the data axis): the gradient is the sum of the
  ranks' gradients.
- ``replicated_input(x, group)``: the identity on an x that every rank
  holds whole and from which each computes a part (the input of a
  column-parallel product): the backward sums the ranks' partial
  gradients.
- ``all_gather(x, dim, group, grad)``: the ranks' x concatenated along
  ``dim`` in rank order.  With ``grad="sum"`` each rank's loss reads the
  whole (sequence parallelism: the gathered keys serve every rank's
  queries), and the gradient of a rank's x is its slice of the summed
  gradient; with ``grad="slice"`` every rank computes the same loss from
  the whole (a channel-sharded convolution), and it is the slice of the
  rank's own gradient.
- ``ppermute(x, shift, group)``: rank r's x goes to rank (r + shift) mod
  the group's size; the backward sends the gradient back, by -shift.

Each runs its collective at every group size, one rank included, where it
is an identity (``ppermute`` at one rank copies x without a call).  The
collectives are stream-ordered on the card: NCCL waits for the work queued
on the current stream before it, which is where every kernel wrapper of the
port launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

GRAD_RULES = ("identity", "sum")
GATHER_GRAD_RULES = ("sum", "slice")


def _summed(x, group):
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _gathered(x, dim: int, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _permuted(x, shift: int, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if shift % n == 0:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad):
        ctx.group, ctx.grad = group, grad
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.grad == "identity" else _summed(g, ctx.group),
                None, None)


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        ctx.size = x.shape[dim]
        return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _summed(g, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _permuted(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _permuted(g, -ctx.shift, ctx.group), None, None


def all_reduce_sum(x, group, grad: str = "identity"):
    """The sum of x over the ranks of ``group``, on every rank; ``grad``
    names the backward's rule (module docstring)."""
    if grad not in GRAD_RULES:
        raise ValueError(f"grad={grad!r}, want one of {GRAD_RULES}")
    return _AllReduceSum.apply(x, group, grad)


def replicated_input(x, group):
    """x as it is; its gradient summed over ``group``."""
    return _ReplicatedInput.apply(x, group)


def all_gather(x, dim: int, group, grad: str = "sum"):
    """The ranks' x concatenated along ``dim`` in rank order (all of the
    same shape); ``grad`` names the backward's rule (module docstring)."""
    if grad not in GATHER_GRAD_RULES:
        raise ValueError(f"grad={grad!r}, want one of {GATHER_GRAD_RULES}")
    return _AllGather.apply(x, dim % x.dim(), group, grad)


def ppermute(x, shift: int, group):
    """Rank r's x, on rank (r + shift) mod the group's size."""
    return _PPermute.apply(x, shift, group)
