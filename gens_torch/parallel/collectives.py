"""Differentiable collectives over a view group (counterpart of the autodiff
rules of ``psum`` and ``all_gather`` in gens_tpu/parallel/sharded.py).

Each is a ``torch.autograd.Function`` built on ``all_reduce`` alone, which
both NCCL and gloo take for CUDA tensors (``torch.distributed.nn``'s
all-gather backward needs reduce-scatter or all-to-all, which gloo lacks
for them).

The gradient rule of the sharded step: every rank backpropagates its own
share of the group's loss, and the shares' parameter gradients are summed
afterwards. So:

- :func:`all_reduce_sum` (the aggregation triplet Σf·m, Σf²·m, Σm): every
  rank's volumes come from the sum, so the sum's cotangent is the group's
  sum of the ranks' cotangents;
- :func:`all_gather_views` (features for blending and MFC): the gathered
  tensor's cotangent, summed over the group, restricted to this rank's
  slice;
- :func:`share_sum` (a loss numerator): the value is the group's sum, the
  gradient is that of this rank's own term.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGatherViews(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        i = dist.get_rank(group)
        rows = x.shape[0]
        ctx.group, ctx.rows = group, slice(i * rows, (i + 1) * rows)
        # every rank writes its rows into zeros: the sum is the gather, exact
        out = x.new_zeros((n * rows,) + tuple(x.shape[1:]))
        out[ctx.rows] = x.detach()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group)[ctx.rows], None


class _ShareSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group``; backward: Σ of the cotangents over ``group``."""
    return _AllReduceSum.apply(x, group)


def all_gather_views(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` (same shape everywhere) stacked along dim 0 in rank
    order; backward: this rank's rows of the group's summed cotangent."""
    return _AllGatherViews.apply(x, group)


def share_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` as the value; the identity as the gradient."""
    return _ShareSum.apply(x, group)
