"""Two torch operations as a CUDA graph can hold them. ``torch.linalg.inv``
checks its result for singular matrices, and ``torch.cumprod``'s gradient
checks its input for zeros; each check reads a device value back to the
host, which a stream being captured cannot do. While a capture is under
way on the current stream these give the same values without the check;
otherwise they are torch's own operations.
"""

from __future__ import annotations

import torch


def _capturing(x: torch.Tensor) -> bool:
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def inverse(m: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.inv(m)``; while capturing, a singular matrix gives
    non-finite values in place of an error."""
    if _capturing(m):
        return torch.linalg.inv_ex(m).inverse
    return torch.linalg.inv(m)


class _CumprodNoZero(torch.autograd.Function):
    """``torch.cumprod`` whose gradient is torch's for an input with no
    zero, the reversed cumulative sum of output·grad divided by the
    input, taken without looking for zeros."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        out = torch.cumprod(x, dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, out = ctx.saved_tensors
        w = out * grad
        return w.flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim).div(x), None


def cumprod_no_zero(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumprod(x, dim)`` of an ``x`` with no zero element; while
    capturing, its gradient does not check that (a zero there would give
    a non-finite gradient)."""
    if _capturing(x):
        return _CumprodNoZero.apply(x, dim)
    return torch.cumprod(x, dim)
