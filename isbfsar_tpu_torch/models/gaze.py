"""The focus nets (port of ``isbfsar_tpu/models/gaze.py``), NCHW.

* :class:`BlazeFaceLite`: a single-shot face detector, (b, 3, 128, 128)
  RGB in [0, 1] -> 896 anchor boxes, 6 landmarks each and sigmoid scores,
  decoded from two anchor grids (16x16 with 2 anchors a cell, 8x8 with 6).
* :class:`LandmarkRefiner`: (b, 3, 64, 64) face crop -> (b, 6, 2)
  landmarks in crop-normalized [0, 1] coordinates.
* :class:`GazeNet`: ResNet-18 -> Dense(2), a normalized face crop ->
  (pitch, yaw) radians.
* :class:`HopeNet`: ResNet-50 -> three 66-bin heads, a square face crop ->
  (yaw, pitch, roll) degrees (the head-pose alternative,
  ``focus/head_pose.py``).

The modules keep the Flax module names, so ``weights.convert_focus``
maps the bundle's keys one to one. Each net computes in ``dtype``; the
dense layers and the decode run in float32, as in the JAX modules.
``forward(x, train=True, stats=...)`` trains with batch statistics
(``models/layers.py::BatchNorm``), as the focus trainers do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.models.layers import BatchNorm, Conv
from isbfsar_tpu_torch.models.resnet import resnet18, resnet50

_EPS = 1e-5  # Flax's BatchNorm default


def pitchyaw_to_vector(pitchyaw: torch.Tensor) -> torch.Tensor:
    """(..., 2) pitch/yaw radians -> (..., 3) unit gaze vector (ETH-XGaze frame)."""
    pitch, yaw = pitchyaw[..., 0], pitchyaw[..., 1]
    return torch.stack([-torch.cos(pitch) * torch.sin(yaw), -torch.sin(pitch),
                        -torch.cos(pitch) * torch.cos(yaw)], dim=-1)


def vector_to_pitchyaw(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) gaze vector -> (..., 2) pitch/yaw radians; the inverse of
    :func:`pitchyaw_to_vector` for unit vectors (ETH-XGaze convention)."""
    n = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    pitch = torch.asin(torch.clamp(-n[..., 1], -1.0, 1.0))
    yaw = torch.atan2(-n[..., 0], -n[..., 2])
    return torch.stack([pitch, yaw], dim=-1)


class GazeNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.ResNet_0 = resnet18(dtype)
        self.gaze_fc = nn.Linear(512, 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        return self.gaze_fc(self.ResNet_0(x, train, stats))


class HopeNet(nn.Module):
    """(b, 3, s, s) RGB in [0, 1] -> (b, 3) (yaw, pitch, roll) degrees: a
    ResNet-50, then per angle a float32 Dense to 66 bins, a softmax and the
    bin expectation ``* 3 - 99`` (3-degree bins over [-99, 99])."""

    n_bins = 66

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.ResNet_0 = resnet50(dtype)
        for name in ("yaw", "pitch", "roll"):
            setattr(self, f"fc_{name}", nn.Linear(2048, self.n_bins))
        self.register_buffer("bins", torch.arange(self.n_bins, dtype=torch.float32),
                             persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        feats = self.ResNet_0(x, train, stats)
        angles = []
        for name in ("yaw", "pitch", "roll"):
            probs = torch.softmax(getattr(self, f"fc_{name}")(feats).to(torch.float32), dim=-1)
            angles.append((probs * self.bins).sum(dim=-1) * 3.0 - 99.0)
        return torch.stack(angles, dim=-1)


class LandmarkRefiner(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, f in enumerate((24, 48, 96, 192)):  # 64 -> 4
            setattr(self, f"conv{i}", Conv(cin, f, 3, 2, bias=False))
            setattr(self, f"bn{i}", BatchNorm(f, _EPS))
            cin = f
        self.fc1 = nn.Linear(4 * 4 * 192, 128)
        self.fc2 = nn.Linear(128, 12)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(4):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train, stats))
        # flatten in the JAX layout (h, w, c)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
        out = self.fc2(F.relu(self.fc1(x)))
        return torch.sigmoid(out).reshape(x.shape[0], 6, 2)


class _BlazeBlock(nn.Module):
    """Depthwise 5x5 (SAME), pointwise, BatchNorm; the residual is
    max-pooled 2x2/2 when the block strides and zero-padded on channels."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.pad = filters - cin
        self.dw = Conv(cin, cin, 5, stride, groups=cin, bias=False)
        self.pw = Conv(cin, filters, 1, bias=False)
        self.bn = BatchNorm(filters, _EPS)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> torch.Tensor:
        y = self.bn(self.pw(self.dw(x)), train, stats)
        residual = F.max_pool2d(x, 2, 2) if self.stride == 2 else x
        if self.pad:
            residual = F.pad(residual, (0, 0, 0, 0, 0, self.pad))
        return F.relu(y + residual)


# Per-anchor base side lengths (fraction of the frame): two small-face
# priors on the fine grid, medium to full-frame faces on the coarse grid.
ANCHOR_SIZES_16 = (0.10, 0.25)
ANCHOR_SIZES_8 = (0.30, 0.42, 0.56, 0.70, 0.85, 1.00)


def blaze_anchors(input_size: int = 128) -> torch.Tensor:
    """(896, 2) anchor centers in [0, 1]: 2 a cell on 16x16, 6 a cell on 8x8."""
    anchors = []
    for grid, per_cell in ((input_size // 8, 2), (input_size // 16, 6)):
        xs = (torch.arange(grid, dtype=torch.float32) + 0.5) / grid
        cy, cx = torch.meshgrid(xs, xs, indexing="ij")
        c = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
        anchors.append(c.repeat_interleave(per_cell, dim=0))
    return torch.cat(anchors, dim=0)


def blaze_anchor_sizes(input_size: int = 128) -> torch.Tensor:
    """(896,) per-anchor base size, in the order of :func:`blaze_anchors`."""
    n16 = (input_size // 8) ** 2
    n8 = (input_size // 16) ** 2
    return torch.cat([torch.tensor(ANCHOR_SIZES_16, dtype=torch.float32).repeat(n16),
                      torch.tensor(ANCHOR_SIZES_8, dtype=torch.float32).repeat(n8)])


class BlazeFaceLite(nn.Module):
    """(b, 3, 128, 128) in [0, 1] -> (boxes (b, 896, 4) [x1, y1, x2, y2] in
    [0, 1], landmarks (b, 896, 6, 2), scores (b, 896)). The anchor tables
    are buffers made at construction, so the forward copies nothing from
    the host; the focus detector always feeds 128x128."""

    n_landmarks = 6
    input_size = 128

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(3, 24, 5, 2)
        blocks = [("b0", 24, 1), ("b1", 28, 1), ("b2", 32, 2), ("b3", 36, 1), ("b4", 42, 1),
                  ("mid_down", 48, 2), ("mid0", 48, 1), ("mid1", 48, 1),
                  ("deep_down", 96, 2), ("deep0", 96, 1), ("deep1", 96, 1)]
        cin = 24
        self.blocks = []
        for name, f, s in blocks:
            setattr(self, name, _BlazeBlock(cin, f, s))
            self.blocks.append(name)
            cin = f
        n_out = 4 + 2 * self.n_landmarks + 1
        self.head16 = Conv(48, 2 * n_out, 1)
        self.head8 = Conv(96, 6 * n_out, 1)
        self.register_buffer("anchors", blaze_anchors(self.input_size), persistent=False)
        self.register_buffer("sizes", blaze_anchor_sizes(self.input_size), persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False, stats: Optional[list] = None):
        b = x.shape[0]
        if x.shape[2:] != (self.input_size, self.input_size):
            raise ValueError(f"BlazeFaceLite takes {self.input_size}x{self.input_size} inputs, "
                             f"got {tuple(x.shape[2:])}")
        x = F.relu(self.stem(x.to(self.dtype)))
        feat16 = None
        for name in self.blocks:
            x = getattr(self, name)(x, train, stats)
            if name == "mid1":
                feat16 = x  # (b, 48, 16, 16) at 128 px
        n_out = 4 + 2 * self.n_landmarks + 1
        raw = torch.cat([
            self.head16(feat16).to(torch.float32).permute(0, 2, 3, 1).reshape(b, -1, n_out),
            self.head8(x).to(torch.float32).permute(0, 2, 3, 1).reshape(b, -1, n_out),
        ], dim=1)  # (b, 896, n_out)

        anchors = self.anchors[None]
        center = anchors + raw[..., 0:2] / 128.0
        wh = torch.exp(raw[..., 2:4] * 0.2) * self.sizes[None, :, None]
        boxes = torch.cat([center - wh / 2, center + wh / 2], dim=-1)
        lms = anchors[:, :, None] + raw[..., 4:4 + 2 * self.n_landmarks].reshape(
            b, -1, self.n_landmarks, 2) / 128.0
        scores = torch.sigmoid(raw[..., -1])
        return boxes, lms, scores
