"""YOLOv4 person detector (port of ``isbfsar_tpu/models/yolov4.py``), NCHW.

CSPDarknet-53 backbone (Mish), SPP + PAN neck (LeakyReLU 0.1) and three
anchor heads. Input (b, 3, s, s) in [0, 1]; output boxes (b, N, 1, 4) and
confs (b, N, 80) with N = 3 * ((s/8)^2 + (s/16)^2 + (s/32)^2) — 4032 at
s = 256. Module names follow the Flax module tree, so the converted bundle
loads with ``load_state_dict(strict=True)``.

``forward(x, train=True, stats=...)`` is Flax's ``train=True`` with
``mutable=["batch_stats"]`` (``models/layers.py::BatchNorm``); ``remat``
recomputes each whole CSP stage of the backbone in the backward pass, as
the JAX net's ``nn.remat(CSPStage)`` (the stage's inputs and outputs are
kept anyway, and per-ResBlock remat would keep the down, route, trunk and
merge activations, which dominate at slim widths).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.models.layers import BatchNorm, Conv, train_block

ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),  # stride 8
    ((36, 75), (76, 55), (72, 146)),  # stride 16
    ((142, 110), (192, 243), (459, 401)),  # stride 32
)
SCALE_XY = (1.2, 1.1, 1.05)


def _scaled(n: int, width: float) -> int:
    """Channel scaling for slim variants; width=1.0 is the reference arch."""
    return max(8, int(round(n * width / 8)) * 8) if width != 1.0 else n


class ConvBlock(nn.Module):
    def __init__(self, cin: int, filters: int, kernel: int = 3, stride: int = 1, act: str = "mish"):
        super().__init__()
        self.act = act
        linear = act == "linear"
        self.conv = Conv(cin, filters, kernel, stride, padding=(kernel - 1) // 2, bias=linear)
        self.bn = None if linear else BatchNorm(filters, 1e-4)

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train, stats)
        if self.act == "mish":
            x = F.mish(x)
        elif self.act == "leaky":
            x = F.leaky_relu(x, 0.1)
        return x


class ResBlock(nn.Module):
    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.conv1 = ConvBlock(cin, hidden, 1)
        self.conv2 = ConvBlock(hidden, out, 3)

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        return x + self.conv2(self.conv1(x, train, stats), train, stats)


class CSPStage(nn.Module):
    def __init__(self, cin: int, filters: int, n_blocks: int, first: bool = False):
        super().__init__()
        split = filters if first else filters // 2
        hidden = split // 2 if first else split
        self.down = ConvBlock(cin, filters, 3, 2)
        self.route = ConvBlock(filters, split, 1)
        self.trunk_in = ConvBlock(filters, split, 1)
        self.res = []  # registered below under the Flax names res0, res1, ...
        for i in range(n_blocks):
            block = ResBlock(split, hidden, split)
            self.res.append(block)
            self.add_module(f"res{i}", block)
        self.trunk_out = ConvBlock(split, split, 1)
        self.merge = ConvBlock(2 * split, filters, 1)

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        x = self.down(x, train, stats)
        route = self.route(x, train, stats)
        y = self.trunk_in(x, train, stats)
        for block in self.res:
            y = block(y, train, stats)
        y = self.trunk_out(y, train, stats)
        return self.merge(torch.cat([y, route], dim=1), train, stats)


class CSPDarknet53(nn.Module):
    def __init__(self, width: float = 1.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        c = lambda n: _scaled(n, width)
        deep = 1.0 if width == 1.0 else 0.25
        blocks = lambda n: max(1, int(round(n * deep)))
        self.stem = ConvBlock(3, c(32), 3)
        self.stage1 = CSPStage(c(32), c(64), 1, first=True)
        self.stage2 = CSPStage(c(64), c(128), blocks(2))
        self.stage3 = CSPStage(c(128), c(256), blocks(8))
        self.stage4 = CSPStage(c(256), c(512), blocks(8))
        self.stage5 = CSPStage(c(512), c(1024), blocks(4))

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        def stage(block, x):
            return train_block(block, x, self.remat, stats) if train else block(x)

        x = stage(self.stage2, stage(self.stage1, self.stem(x, train, stats)))
        d3 = stage(self.stage3, x)
        d4 = stage(self.stage4, d3)
        return d3, d4, stage(self.stage5, d4)


def _stack(owner: nn.Module, prefix: str, cin: int, filters) -> list:
    """Alternating 1x1/3x3 leaky conv stack, registered on ``owner`` as
    ``{prefix}{i}``; returns the blocks in order."""
    out = []
    for i, (f, k) in enumerate(filters):
        block = ConvBlock(cin, f, k, act="leaky")
        owner.add_module(f"{prefix}{i}", block)
        out.append(block)
        cin = f
    return out


def _run(x, stack, train: bool = False, stats: Optional[list] = None):
    for m in stack:
        x = m(x, train, stats)
    return x


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Neck(nn.Module):
    def __init__(self, width: float = 1.0):
        super().__init__()
        c = lambda n: _scaled(n, width)
        spp = [(c(512), 1), (c(1024), 3), (c(512), 1)]
        self._pre_spp = _stack(self, "pre_spp", c(1024), spp)
        self._post_spp = _stack(self, "post_spp", 4 * c(512), spp)
        self.p5_up = ConvBlock(c(512), c(256), 1, act="leaky")
        self.lat4 = ConvBlock(c(512), c(256), 1, act="leaky")
        self._p4 = _stack(self, "p4_", c(512), [(c(256), 1), (c(512), 3), (c(256), 1),
                                                (c(512), 3), (c(256), 1)])
        self.p4_up = ConvBlock(c(256), c(128), 1, act="leaky")
        self.lat3 = ConvBlock(c(256), c(128), 1, act="leaky")
        self._p3 = _stack(self, "p3_", c(256), [(c(128), 1), (c(256), 3), (c(128), 1),
                                                (c(256), 3), (c(128), 1)])

    def forward(self, d3, d4, d5, train: bool = False, stats: Optional[list] = None):
        t = (train, stats)
        x = _run(d5, self._pre_spp, *t)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        p5 = _run(torch.cat(pools[::-1], dim=1), self._post_spp, *t)
        up = _upsample2(self.p5_up(p5, *t))
        x = torch.cat([self.lat4(d4, *t), up], dim=1)
        p4 = _run(x, self._p4, *t)
        up = _upsample2(self.p4_up(p4, *t))
        x = torch.cat([self.lat3(d3, *t), up], dim=1)
        return _run(x, self._p3, *t), p4, p5


def decode_scale(raw: torch.Tensor, anchors: torch.Tensor, scale_xy: float, input_size: int,
                 n_classes: int):
    """(b, 3*(5+C), h, w) raw head -> (boxes (b, 3*h*w, 4) in [0,1] x1y1x2y2,
    confs (b, 3*h*w, C)), flattened in (h, w, anchor) order as in JAX.
    anchors: (3, 2) float32 pixel sizes on the device of ``raw``."""
    b, _, h, w = raw.shape
    n_anchor = len(anchors)
    raw = raw.to(torch.float32).permute(0, 2, 3, 1).reshape(b, h, w, n_anchor, 5 + n_classes)
    gx = torch.arange(w, dtype=torch.float32, device=raw.device)[None, :].expand(h, w)
    gy = torch.arange(h, dtype=torch.float32, device=raw.device)[:, None].expand(h, w)
    txy = torch.sigmoid(raw[..., 0:2]) * scale_xy - 0.5 * (scale_xy - 1.0)
    bx = (txy[..., 0] + gx[..., None]) / w
    by = (txy[..., 1] + gy[..., None]) / h
    anchor_wh = anchors / input_size
    bw = torch.exp(raw[..., 2]) * anchor_wh[:, 0]
    bh = torch.exp(raw[..., 3]) * anchor_wh[:, 1]
    boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], dim=-1)
    confs = torch.sigmoid(raw[..., 5:]) * torch.sigmoid(raw[..., 4:5])
    return boxes.reshape(b, h * w * n_anchor, 4), confs.reshape(b, h * w * n_anchor, n_classes)


class YOLOv4(nn.Module):
    def __init__(self, n_classes: int = 80, width: float = 1.0, dtype=torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dtype
        c = lambda n: _scaled(n, width)
        out_ch = 3 * (5 + n_classes)
        self.backbone = CSPDarknet53(width, remat)
        self.neck = Neck(width)
        self.head1_conv = ConvBlock(c(128), c(256), 3, act="leaky")
        self.head1_out = ConvBlock(c(256), out_ch, 1, act="linear")
        self.down4 = ConvBlock(c(128), c(256), 3, 2, act="leaky")
        self._h4 = _stack(self, "h4_", c(512), [(c(256), 1), (c(512), 3), (c(256), 1),
                                                (c(512), 3), (c(256), 1)])
        self.head2_conv = ConvBlock(c(256), c(512), 3, act="leaky")
        self.head2_out = ConvBlock(c(512), out_ch, 1, act="linear")
        self.down5 = ConvBlock(c(256), c(512), 3, 2, act="leaky")
        self._h5 = _stack(self, "h5_", c(1024), [(c(512), 1), (c(1024), 3), (c(512), 1),
                                                 (c(1024), 3), (c(512), 1)])
        self.head3_conv = ConvBlock(c(512), c(1024), 3, act="leaky")
        self.head3_out = ConvBlock(c(1024), out_ch, 1, act="linear")
        # a buffer, so that no step copies the anchors from the host (a CUDA
        # graph cannot record such a copy); not part of the state dict
        self.register_buffer("anchors", torch.tensor(ANCHORS, dtype=torch.float32),
                             persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False, stats: Optional[list] = None):
        input_size = x.shape[2]
        t = (train, stats)
        x = x.to(self.dtype)
        d3, d4, d5 = self.backbone(x, *t)
        p3, p4, p5 = self.neck(d3, d4, d5, *t)
        y1 = self.head1_out(self.head1_conv(p3, *t), *t)
        z = _run(torch.cat([self.down4(p3, *t), p4], dim=1), self._h4, *t)
        y2 = self.head2_out(self.head2_conv(z, *t), *t)
        z2 = _run(torch.cat([self.down5(z, *t), p5], dim=1), self._h5, *t)
        y3 = self.head3_out(self.head3_conv(z2, *t), *t)
        all_boxes, all_confs = [], []
        for raw, anchors, sxy in zip((y1, y2, y3), self.anchors, SCALE_XY):
            bx, cf = decode_scale(raw, anchors, sxy, input_size, self.n_classes)
            all_boxes.append(bx)
            all_confs.append(cf)
        return torch.cat(all_boxes, dim=1)[:, :, None, :], torch.cat(all_confs, dim=1)
