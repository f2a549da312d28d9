"""The single-stage head detector and the mutual-gaze heads (port of
``isbfsar_tpu/models/detection.py``), NCHW.

* :class:`HeadDetectorNet`: a ResNet-18-style trunk (strides 8, 16, 32),
  an :class:`FPN` and one shared 3x3 classification conv and one shared box
  conv over its three levels (one anchor size a level, 3 aspect ratios),
  decoded in the graph: (b, 3, s, s) RGB in [0, 1] -> boxes (b, N, 4)
  x1y1x2y2 in [0, 1] and sigmoid scores (b, N). The anchors are flattened
  in the JAX layout, (h, w, anchor) a level, fine level first.
* :class:`BinaryGazeClassifier`: 512 (or 2048) -> 256 -> 64 -> 1 sigmoid,
  "is looking at me".
* :class:`EyeKeypointMLP`: flattened eye keypoints -> 128 -> 64 -> 1 sigmoid.

The modules keep the Flax module names (``trunk``, ``fpn.lat{i}``,
``fpn.smooth{i}``, ``cls_head``, ``box_head``), so
``weights.convert_variables`` maps a Flax tree one to one. The trunk's
BatchNorms keep Flax's default momentum 0.99 (the JAX trunk passes none),
not the 0.9 of the other nets. The convolutions compute in ``dtype`` (bf16
by default, as JAX's); the decode and the dense heads in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.models.layers import FLAX_BN_MOMENTUM, BatchNorm, Conv
from isbfsar_tpu_torch.models.resnet import BasicBlock

_EPS = 1e-5  # Flax's BatchNorm default


def nearest_indices(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``'s source index of each output
    sample: ``floor((i + 0.5) * n_in / n_out)`` in float32, half-pixel
    centres (``F.interpolate(mode="nearest")`` takes ``floor(i * n_in /
    n_out)``, which differs at odd sizes)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return pos.floor().long()


class FPN(nn.Module):
    """Feature maps fine -> coarse, each to ``out_channels`` by a 1x1
    lateral, the coarser sum upsampled (nearest) into each finer one, then
    a 3x3 smoothing conv per level."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 128):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lat{i}", Conv(c, out_channels, 1))
            setattr(self, f"smooth{i}", Conv(out_channels, out_channels, 3))

    def forward(self, feats: Sequence[torch.Tensor]) -> list:
        laterals = [getattr(self, f"lat{i}")(f) for i, f in enumerate(feats)]
        outs = [laterals[-1]]
        for i in range(self.n - 2, -1, -1):
            h, w = laterals[i].shape[2:]
            top = outs[0]
            ys = nearest_indices(top.shape[2], h, top.device)
            xs = nearest_indices(top.shape[3], w, top.device)
            outs.insert(0, laterals[i] + top[:, :, ys[:, None], xs[None, :]])
        return [getattr(self, f"smooth{i}")(o) for i, o in enumerate(outs)]


class TrunkStages(nn.Module):
    """ResNet-18-style trunk returning the stride 8, 16 and 32 maps; its
    BatchNorms move their running averages by momentum 0.99."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, _EPS, FLAX_BN_MOMENTUM)
        self.stages = []
        cin = 64
        for i in range(4):
            names = []
            for j in range(2):
                name = f"layer{i + 1}_{j}"
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, name, BasicBlock(cin, 64 * 2**i, stride, FLAX_BN_MOMENTUM))
                names.append(name)
                cin = 64 * 2**i
            self.stages.append(names)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[list] = None) -> list:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train, stats))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, train, stats)
            if i >= 1:
                feats.append(x)
        return feats


FPN_CHANNELS = 128
ANCHOR_SIZES = (0.1, 0.25, 0.5)  # one a level, relative to the image
ASPECT_RATIOS = (0.75, 1.0, 1.33)


class HeadDetectorNet(nn.Module):
    """(b, 3, s, s) in [0, 1] -> (boxes (b, N, 4) [x1, y1, x2, y2] in
    [0, 1], scores (b, N)), N = 3 sum(h * w) over the three levels."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_a = len(ASPECT_RATIOS)
        self.trunk = TrunkStages(dtype)
        self.fpn = FPN((128, 256, 512), FPN_CHANNELS)
        # one conv each, shared by the three levels
        self.cls_head = Conv(FPN_CHANNELS, self.n_a, 3)
        self.box_head = Conv(FPN_CHANNELS, 4 * self.n_a, 3)
        self.register_buffer("ratios", torch.tensor(ASPECT_RATIOS, dtype=torch.float32),
                             persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False, stats: Optional[list] = None):
        b, n_a = x.shape[0], self.n_a
        pyramid = self.fpn(self.trunk(x, train, stats))
        all_boxes, all_scores = [], []
        sq = torch.sqrt(self.ratios)
        for p, size in zip(pyramid, ANCHOR_SIZES):
            h, w = p.shape[2], p.shape[3]
            # NCHW -> the JAX layout (h, w, anchor) before flattening
            cls = self.cls_head(p).to(torch.float32).permute(0, 2, 3, 1).reshape(b, h * w * n_a)
            reg = self.box_head(p).to(torch.float32).permute(0, 2, 3, 1).reshape(b, h, w, n_a, 4)
            gx = (torch.arange(w, dtype=torch.float32, device=x.device) + 0.5) / w
            gy = (torch.arange(h, dtype=torch.float32, device=x.device) + 0.5) / h
            aw = size * sq
            ah = size / sq
            cx = gx[None, :, None] + reg[..., 0] * 0.1 * aw
            cy = gy[:, None, None] + reg[..., 1] * 0.1 * ah
            bw = aw * torch.exp(torch.clamp(reg[..., 2] * 0.2, -4.0, 4.0))
            bh = ah * torch.exp(torch.clamp(reg[..., 3] * 0.2, -4.0, 4.0))
            boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
            all_boxes.append(boxes.reshape(b, h * w * n_a, 4))
            all_scores.append(torch.sigmoid(cls))
        return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


class BinaryGazeClassifier(nn.Module):
    """(b, in_features) float32 features -> (b, 1) sigmoid."""

    def __init__(self, in_features: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 256)
        self.fc2 = nn.Linear(256, 64)
        self.fc3 = nn.Linear(64, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.fc3(F.relu(self.fc2(F.relu(self.fc1(feats))))))


class EyeKeypointMLP(nn.Module):
    """(b, ...) keypoints, flattened to ``in_features`` -> (b, 1) sigmoid
    (the reference's 'JustOpenPose' variant; 14 (x, y) points by default)."""

    def __init__(self, in_features: int = 28):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 128)
        self.fc2 = nn.Linear(128, 64)
        self.fc3 = nn.Linear(64, 1)

    def forward(self, keypoints: torch.Tensor) -> torch.Tensor:
        y = keypoints.reshape(keypoints.shape[0], -1)
        return torch.sigmoid(self.fc3(F.relu(self.fc2(F.relu(self.fc1(y))))))
