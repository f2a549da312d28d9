"""Layers shared by the port's nets, with Flax's parameter names and numerics.

* :class:`BatchNorm` normalizes as ``flax.linen.BatchNorm`` does, in float32
  and cast back to the input dtype: in inference (the default) with its
  running averages, in one ``F.batch_norm`` kernel; in training (``train=True``,
  Flax's ``use_running_average=False``) with the batch's mean and biased
  variance ``E[x²] - E[x]²`` (Flax's fast variance, clamped at 0). The
  running averages move only through :meth:`BatchNorm.update`, by its
  ``momentum`` (``BN_MOMENTUM`` = 0.9 unless the net says otherwise) with
  that same biased variance (torch's own update would take the unbiased
  one). With a process group in its ``group`` (:func:`sync_batch_stats`),
  a training forward first sums its ``Σx``, ``Σx²`` and count over the
  group (a differentiable all-reduce, whose backward sums the gradient over
  the ranks), so every rank normalizes with the statistics of the whole
  batch across the group, as one device would; ``nn.SyncBatchNorm``
  refuses CPU tensors.
* :class:`Conv` takes the compute dtype of its input and casts its stored
  weights to it, as a Flax ``nn.Conv(dtype=...)`` does; ``padding="SAME"``
  pads like XLA (for stride 2 on even sizes: 0 before, 1 after).
* :class:`LayerNorm` uses Flax's fast variance ``E[x²] - E[x]²`` and eps 1e-6.
* :func:`init_random` fills a net with seeded random weights (truncated
  LeCun normal kernels, zero biases, identity normalization), as Flax
  initializes.
* :func:`train_block` runs one block of a net in training, optionally
  recomputed in the backward pass (``torch.utils.checkpoint``, the
  counterpart of Flax's ``nn.remat`` around the block): the block returns
  its BatchNorms' batch statistics from inside the checkpoint and they are
  collected outside it, so the recomputation moves no running average a
  second time and the step is the same, bit for bit.
* :func:`pin_float32_matmul` turns TF32 off for matmuls and cuDNN
  convolutions (process-wide PyTorch state): where the JAX code computes in
  float32 (``Precision.HIGHEST``), so must the port; :func:`float32_device`
  does so for the trainer and the evaluators.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from isbfsar_tpu_torch.parallel.collectives import all_reduce_sum


# the running averages' default momentum in training: the JAX nets' BatchNorms
# pass 0.9 (JAX models/resnet.py:98-100, yolov4.py:55, effnetv2.py:91 and
# :143, gaze.py:84 and :130); the head detector's trunk keeps Flax's default
# (JAX models/detection.py:56, ``FLAX_BN_MOMENTUM``)
BN_MOMENTUM = 0.9
FLAX_BN_MOMENTUM = 0.99


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = None  # the process group training statistics are taken over

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:  # NCHW
        """``train`` normalizes with the batch's statistics and appends
        ``(self, mean, var)`` (detached) to ``stats`` if it is a list, for
        the caller to hand to :meth:`update` or to drop; the running
        averages are read only in inference and never written here."""
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0,
                                self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least float32, as Flax
        if self.group is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            c = xf.shape[1]
            count = torch.full((1,), float(xf.numel() // c), dtype=xf.dtype, device=xf.device)
            sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                             count]), self.group)
            mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        if stats is not None:
            stats.append((self, mean.detach(), var.detach()))
        return y.to(x.dtype)

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running averages toward one batch's statistics, as Flax's
        ``batch_stats`` update does."""
        self.mean.copy_(self.momentum * self.mean + (1.0 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1.0 - self.momentum) * var)


def sync_batch_stats(module: nn.Module, group) -> None:
    """Every BatchNorm of ``module`` takes its training statistics over
    ``group`` (None: over its own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def update_running_stats(stats: list) -> None:
    """Apply the batch statistics a training forward collected, in the order
    they were computed."""
    for norm, mean, var in stats:
        norm.update(mean, var)


def _block_with_stats(block: nn.Module, x: torch.Tensor):
    """One block in training, returning its output and its BatchNorms'
    batch statistics (the function a checkpoint recomputes)."""
    stats = []
    return block(x, True, stats), stats


def train_block(block: nn.Module, x: torch.Tensor, remat: bool,
                stats: Optional[list]) -> torch.Tensor:
    """``block(x, True, stats)``, recomputed in the backward pass when
    ``remat``. The blocks draw no random numbers: no RNG state to restore."""
    if not remat:
        return block(x, True, stats)
    out, block_stats = checkpoint(_block_with_stats, block, x, use_reentrant=False,
                                  preserve_rng_state=False)
    if stats is not None:
        stats.extend(block_stats)
    return out


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


# standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_random(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded Flax-style initialization of every Conv, Linear and norm."""
    for m in module.modules():
        if isinstance(m, (Conv, nn.Linear)):
            # Flax's lecun_normal: a normal truncated at two deviations,
            # widened so that the variance stays 1 / fan_in
            std = 1.0 / math.sqrt(m.weight[0].numel()) / _TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    return module


def pin_float32_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def float32_device(device) -> torch.device:
    """``device`` for float32 work: a CUDA device without a card raises, and
    on the card TF32 is turned off (:func:`pin_float32_matmul`)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but no CUDA device is available")
        pin_float32_matmul()
    return device
