"""EfficientNetV2 backbone and MetrABS head (port of
``isbfsar_tpu/models/effnetv2.py``), NCHW.

Fused-MBConv and MBConv+SE stages; (b, 3, s, s) in [0, 1] ->
(b, 1280, s/32, s/32) float32. BatchNorm eps 1e-3. Stride-2 convs pad
like XLA's ``SAME`` (0 before, 1 after on even sizes), not symmetrically.
``forward(x, train=True, stats=...)`` trains with batch statistics
(``models/layers.py::BatchNorm``); ``remat`` recomputes each MBConv in the
backward pass, as the JAX net's ``nn.remat(MBConv)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.models.layers import BatchNorm, Conv, train_block


@dataclasses.dataclass(frozen=True)
class StageSpec:
    fused: bool  # fused-MBConv (conv3x3 expand) vs MBConv (1x1 expand + depthwise)
    expand: int
    kernel: int
    stride: int
    filters: int
    blocks: int
    se_ratio: float = 0.0


# EfficientNetV2-L (paper table 10); input 256 -> output 8x8.
V2_L = (
    StageSpec(True, 1, 3, 1, 32, 4),
    StageSpec(True, 4, 3, 2, 64, 7),
    StageSpec(True, 4, 3, 2, 96, 7),
    StageSpec(False, 4, 3, 2, 192, 10, 0.25),
    StageSpec(False, 6, 3, 1, 224, 19, 0.25),
    StageSpec(False, 6, 3, 2, 384, 25, 0.25),
    StageSpec(False, 6, 3, 1, 640, 7, 0.25),
)

# smaller variants for tests and lighter deployments
V2_S = (
    StageSpec(True, 1, 3, 1, 24, 2),
    StageSpec(True, 4, 3, 2, 48, 4),
    StageSpec(True, 4, 3, 2, 64, 4),
    StageSpec(False, 4, 3, 2, 128, 6, 0.25),
    StageSpec(False, 6, 3, 1, 160, 9, 0.25),
    StageSpec(False, 6, 3, 2, 256, 15, 0.25),
)

V2_TINY = (  # test-only: tiny but same topology family
    StageSpec(True, 1, 3, 1, 8, 1),
    StageSpec(True, 2, 3, 2, 16, 1),
    StageSpec(False, 2, 3, 2, 24, 1, 0.25),
    StageSpec(False, 2, 3, 2, 32, 1, 0.25),
    StageSpec(False, 2, 3, 2, 48, 1, 0.25),
)

_EPS = 1e-3


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.reduce = Conv(channels, reduced, 1)
        self.expand = Conv(reduced, channels, 1)

    def forward(self, x):
        pooled = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
        s = self.expand(F.silu(self.reduce(pooled)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, spec: StageSpec, inp: int, out: int, stride: int):
        super().__init__()
        self.spec = spec
        self.residual = stride == 1 and inp == out
        mid = inp * spec.expand
        k = spec.kernel
        if spec.fused and spec.expand != 1:
            self.expand_conv = Conv(inp, mid, k, stride, bias=False)
            self.expand_bn = BatchNorm(mid, _EPS)
            self.project_conv = Conv(mid, out, 1, bias=False)
            self.project_bn = BatchNorm(out, _EPS)
        elif spec.fused:
            self.project_conv = Conv(inp, out, k, stride, bias=False)
            self.project_bn = BatchNorm(out, _EPS)
        else:
            self.expand_conv = Conv(inp, mid, 1, bias=False)
            self.expand_bn = BatchNorm(mid, _EPS)
            self.depthwise_conv = Conv(mid, mid, k, stride, groups=mid, bias=False)
            self.depthwise_bn = BatchNorm(mid, _EPS)
            if spec.se_ratio > 0:
                self.se = SqueezeExcite(mid, max(1, int(inp * spec.se_ratio)))
            self.project_conv = Conv(mid, out, 1, bias=False)
            self.project_bn = BatchNorm(out, _EPS)

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        spec = self.spec
        t = (train, stats)
        if spec.fused and spec.expand != 1:
            y = F.silu(self.expand_bn(self.expand_conv(x), *t))
            y = self.project_bn(self.project_conv(y), *t)
        elif spec.fused:
            y = F.silu(self.project_bn(self.project_conv(x), *t))
        else:
            y = F.silu(self.expand_bn(self.expand_conv(x), *t))
            y = F.silu(self.depthwise_bn(self.depthwise_conv(y), *t))
            if spec.se_ratio > 0:
                y = self.se(y)
            y = self.project_bn(self.project_conv(y), *t)
        return y + x if self.residual else y


class EfficientNetV2(nn.Module):
    """(b, 3, s, s) float in [0, 1] -> (b, head_filters, s/32, s/32) float32."""

    def __init__(self, stages=V2_L, stem_filters: int = 32, head_filters: int = 1280,
                 dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.stem_conv = Conv(3, stem_filters, 3, 2, bias=False)
        self.stem_bn = BatchNorm(stem_filters, _EPS)
        self.blocks = []  # registered under the Flax names stage{s}_block{b}
        cin = stem_filters
        for si, spec in enumerate(stages):
            for bi in range(spec.blocks):
                block = MBConv(spec, cin, spec.filters, spec.stride if bi == 0 else 1)
                self.add_module(f"stage{si}_block{bi}", block)
                self.blocks.append(block)
                cin = spec.filters
        self.head_conv = Conv(cin, head_filters, 1, bias=False)
        self.head_bn = BatchNorm(head_filters, _EPS)

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        x = F.silu(self.stem_bn(self.stem_conv(x.to(self.dtype)), train, stats))
        for block in self.blocks:
            x = train_block(block, x, self.remat, stats) if train else block(x)
        x = F.silu(self.head_bn(self.head_conv(x), train, stats))
        return x.to(torch.float32)


class MetrabsHead(nn.Module):
    """1280 -> 288 heatmap head over the 8x8 grid: NCHW features in,
    NHWC (b, 8, 8, 288) logits out (the layout ``split_head_logits`` reads)."""

    def __init__(self, n_in: int = 1280, n_out: int = 288):
        super().__init__()
        self.conv_final = nn.Linear(n_in, n_out)

    def forward(self, feats):
        return self.conv_final(feats.permute(0, 2, 3, 1))


# ------------------------------------------------- upstream weight mapping


def metrabs_tf_name_map(stages: Sequence[StageSpec] = V2_L):
    """Explicit automl-effnetv2 TF layer-scope -> flax module-path map.

    The MetrABS checkpoint's backbone is google-automl's EfficientNetV2
    (vendored at isarandi/metrabs src/backbones/efficientnet/
    effnetv2_model.py; the reference extracts its variables with
    ``model.crop_model.variables`` and pours them into a fresh Keras model
    via ``set_weights``, reference setup/2_extract_bbone_heads.py:36-47).
    TF layer scopes per that implementation:

    - ``stem/conv2d`` + ``stem/tpu_batch_normalization``
    - per block ``blocks_{i}`` (global index across stages):
      MBConv: ``conv2d`` (expand) + ``tpu_batch_normalization``,
      ``depthwise_conv2d`` + ``tpu_batch_normalization_1``,
      ``se/conv2d`` (reduce) + ``se/conv2d_1`` (expand),
      ``conv2d_1`` (project) + ``tpu_batch_normalization_2``.
      Fused, expand!=1: ``conv2d`` (expand, kxk) + ``tpu_batch_normalization``,
      ``conv2d_1`` (project 1x1) + ``tpu_batch_normalization_1``.
      Fused, expand==1: ``conv2d`` (single kxk) + ``tpu_batch_normalization``.
    - ``head/conv2d`` + ``head/tpu_batch_normalization``

    Values are Flax module paths, which are the port's module names too.
    Feed the result to ``utils.checkpoint.import_tf_name_map`` (it strips
    the leading ``efficientnetv2-l/`` model scope automatically).
    """
    bn = "tpu_batch_normalization"
    m = {
        "stem/conv2d": ("stem_conv",),
        f"stem/{bn}": ("stem_bn",),
        "head/conv2d": ("head_conv",),
        f"head/{bn}": ("head_bn",),
    }
    b = 0
    for si, spec in enumerate(stages):
        for bi in range(spec.blocks):
            blk = f"blocks_{b}"
            flax_blk = f"stage{si}_block{bi}"
            if spec.fused:
                if spec.expand != 1:
                    m[f"{blk}/conv2d"] = (flax_blk, "expand_conv")
                    m[f"{blk}/{bn}"] = (flax_blk, "expand_bn")
                    m[f"{blk}/conv2d_1"] = (flax_blk, "project_conv")
                    m[f"{blk}/{bn}_1"] = (flax_blk, "project_bn")
                else:
                    m[f"{blk}/conv2d"] = (flax_blk, "project_conv")
                    m[f"{blk}/{bn}"] = (flax_blk, "project_bn")
            else:
                m[f"{blk}/conv2d"] = (flax_blk, "expand_conv")
                m[f"{blk}/{bn}"] = (flax_blk, "expand_bn")
                m[f"{blk}/depthwise_conv2d"] = (flax_blk, "depthwise_conv")
                m[f"{blk}/{bn}_1"] = (flax_blk, "depthwise_bn")
                if spec.se_ratio > 0:
                    m[f"{blk}/se/conv2d"] = (flax_blk, "se", "reduce")
                    m[f"{blk}/se/conv2d_1"] = (flax_blk, "se", "expand")
                m[f"{blk}/conv2d_1"] = (flax_blk, "project_conv")
                m[f"{blk}/{bn}_2"] = (flax_blk, "project_bn")
            b += 1
    return m
