"""ResNet-18 and ResNet-50 trunks (port of ``isbfsar_tpu/models/resnet.py``), NCHW.

ResNet-18 is the GazeNet backbone of the focus path, ResNet-50 the RGB
extractor of the recognizer (``models/trx.py::RGBExtractor``). Stem: a 7x7
stride-2 convolution padded (3, 3), BatchNorm, ReLU and a 3x3/2 max-pool
padded (1, 1) with -inf, as Flax's ``max_pool`` pads. Then four stages of
:class:`BasicBlock` (ResNet-18: 2, 2, 2, 2) or :class:`Bottleneck`
(ResNet-50: 3, 4, 6, 3) and a global average pool, which returns float32
features. BatchNorm eps 1e-5, momentum 0.9. The convolutions compute in
``dtype`` and cast their float32 weights to it, as the Flax modules do.

``forward(x, train=True, stats=...)`` is Flax's ``train=True`` with
``mutable=["batch_stats"]``: every BatchNorm normalizes with its batch's
statistics and appends them to ``stats`` in call order
(``layers.update_running_stats`` applies them). ``remat`` recomputes each
residual block in the backward pass (``torch.utils.checkpoint``, per block
as Flax's ``nn.remat`` around the block; around the whole net it would save
nothing): a block inside the checkpoint returns its statistics, which are
collected outside it, so the recomputation in the backward pass moves no
running average a second time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.models.layers import BatchNorm, Conv, train_block

_EPS = 1e-5


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(filters, _EPS)
        self.conv2 = Conv(filters, filters, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(filters, _EPS)
        if stride != 1 or cin != filters:
            self.downsample_conv = Conv(cin, filters, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(filters, _EPS)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, stats))
        y = self.bn2(self.conv2(y), train, stats)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), train, stats)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to ``filters * 4``, with a projected
    shortcut where the shape changes."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = Conv(cin, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, _EPS)
        self.conv2 = Conv(filters, filters, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(filters, _EPS)
        self.conv3 = Conv(filters, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout, _EPS)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv(cin, cout, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(cout, _EPS)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, stats))
        y = F.relu(self.bn2(self.conv2(y), train, stats))
        y = self.bn3(self.conv3(y), train, stats)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), train, stats)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """(b, 3, s, s) -> (b, width * 2**(stages - 1) * block.expansion)
    float32 pooled features."""

    def __init__(self, stage_sizes: Sequence[int], block=BasicBlock, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.conv1 = Conv(3, width, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(width, _EPS)
        self.blocks = []
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"layer{i + 1}_{j}"
                setattr(self, name, block(cin, width * 2**i, stride))
                self.blocks.append(name)
                cin = width * 2**i * block.expansion

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train, stats))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            block = getattr(self, name)
            x = train_block(block, x, self.remat, stats) if train else block(x)
        # the mean accumulates in float32 and is rounded to the compute type,
        # as jnp.mean does for bfloat16
        return x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype).to(torch.float32)


def resnet18(dtype: torch.dtype = torch.bfloat16) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block=BasicBlock, dtype=dtype)


def resnet50(dtype: torch.dtype = torch.bfloat16, remat: bool = False) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block=Bottleneck, dtype=dtype, remat=remat)
