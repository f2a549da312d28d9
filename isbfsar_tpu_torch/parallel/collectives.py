"""Differentiable collectives, each with the backward its caller needs.

Two conventions meet in the trainer:

* Ranks that compute DIFFERENT losses (dp, and the sp ranks' own frame
  slices): the step differentiates the sum of every rank's loss, and the
  gradient all-reduce (DDP, FSDP) divides by the ranks. A collective that
  combines the ranks' values must then sum the gradient over the ranks in
  its backward: :func:`all_reduce_sum` (synced BatchNorm's sums) and
  :func:`gather_cat` (sp's frame features) do.
* Ranks that compute the SAME loss from split features (tp): Megatron's
  pair, :func:`tp_reduce` (forward sum, backward identity) where a
  contraction over the split dimension ends, and :func:`tp_copy` (forward
  identity, backward sum) where a replicated tensor enters the split
  computation.

Each is written out here (forward and backward over ``torch.distributed``)
rather than taken from ``torch.distributed.nn``, whose backward for a
gather uses an all-to-all or a reduce-scatter, which gloo lacks for CUDA
tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.group = dim, group
        ctx.rank = dist.get_rank(group)
        ctx.size = x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)  # NCCL takes contiguous tensors
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks; the backward sums the gradient over them."""
    return _AllReduceSum.apply(x, group)


def gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward gives each rank its slice of the gradient summed over the ranks."""
    return _GatherCat.apply(x, dim, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial results; identity backward."""
    return _TPReduce.apply(x, group)


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the ranks' partial gradients."""
    return _TPCopy.apply(x, group)
