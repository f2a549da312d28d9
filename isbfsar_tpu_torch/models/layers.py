"""Layers shared by the port's nets, with Flax's parameter names and numerics.

* :class:`BatchNorm` (inference) normalizes as ``flax.linen.BatchNorm`` does,
  in float32 and cast back to the input dtype, with one ``F.batch_norm``
  kernel (its statistics and affine parameters stay float32).
* :class:`Conv` takes the compute dtype of its input and casts its stored
  weights to it, as a Flax ``nn.Conv(dtype=...)`` does; ``padding="SAME"``
  pads like XLA (for stride 2 on even sizes: 0 before, 1 after).
* :class:`LayerNorm` uses Flax's fast variance ``E[x²] - E[x]²`` and eps 1e-6.
* :func:`init_random` fills a net with seeded random weights (LeCun normal
  kernels, zero biases, identity normalization), as Flax initializes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, self.eps)


class Conv(nn.Module):
    """2D convolution in NCHW with Flax's padding semantics."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding="SAME",
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.kernel = kernel
        self.padding = padding  # "SAME" or a symmetric int
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if pad == "SAME":
            lo_hi = []
            for n in (x.shape[3], x.shape[2]):  # F.pad order: last dim first
                out = -(-n // self.stride)
                total = max((out - 1) * self.stride + self.kernel - n, 0)
                lo_hi += [total // 2, total - total // 2]
            if lo_hi[0] == lo_hi[1] and lo_hi[2] == lo_hi[3]:
                pad = (lo_hi[2], lo_hi[0])
            else:
                x, pad = F.pad(x, lo_hi), 0
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, pad, 1, self.groups)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


@torch.no_grad()
def init_random(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded Flax-style initialization of every Conv, Linear and norm."""
    for m in module.modules():
        if isinstance(m, (Conv, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    return module
