"""Parameter initializers of the JAX package's flax modules, for a fresh
training run (``--mode train`` without ``--resume``).

flax's ``lecun_normal`` and ``he_normal`` are variance scaling with a
truncated normal: std = sqrt(scale / fan_in) / 0.8796..., cut at ±2 std,
where fan_in counts the kernel's input channels times its receptive field.
The draws come from torch's generator, so they are not JAX's numbers; the
families and scales are the same.
"""

from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def variance_scaling_(t: torch.Tensor, scale: float, fan_in: int
                      ) -> torch.Tensor:
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


def lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    return variance_scaling_(t, 1.0, fan_in)


def he_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    return variance_scaling_(t, 2.0, fan_in)


def dense(d_in: int, d_out: int) -> torch.nn.Linear:
    """A flax ``nn.Dense`` as ``nn.Linear``: lecun-normal weight, zero
    bias."""
    lin = torch.nn.Linear(d_in, d_out)
    lecun_normal_(lin.weight, d_in)
    torch.nn.init.zeros_(lin.bias)
    return lin
