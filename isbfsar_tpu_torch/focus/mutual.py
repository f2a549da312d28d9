"""Mutual-gaze focus detection, the alternative focus path (port of
``isbfsar_tpu/focus/mutual.py``).

:class:`HeadDetector`: the frame resized (linear, antialiased, as
``jax.image.resize``) to ``input_size``, :class:`HeadDetectorNet`, and the
best-scoring head; ``estimate`` returns (box in pixels, score), or None
under ``score_thr``. :class:`MutualGazeDetector`: the same detector at 256,
a square crop of the best head at ``crop_size``
(``ops/image.py::square_box_crop_gather``), a ResNet-18 or ResNet-50
("mobilenet" maps to ResNet-18, as in JAX) and
:class:`BinaryGazeClassifier`; ``estimate`` returns (watching, box), with
watching = sigmoid above 0.5, or None under ``score_thr``.

Each runs on ``device`` (the card unless the caller asks for ``"cpu"``),
reads nothing back to the host until ``estimate`` copies its outputs in
one piece, and takes ``params`` in JAX's layout (Flax variables, numpy or
tensor leaves), or random weights from ``seed``. The nets compute in bf16
as JAX's do (``dtype`` overrides it, for parity checks in float32).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.configs import MutualGazeConfig
from isbfsar_tpu_torch.focus.detector import resize_linear
from isbfsar_tpu_torch.models.detection import BinaryGazeClassifier, HeadDetectorNet
from isbfsar_tpu_torch.models.layers import init_random, pin_float32_matmul
from isbfsar_tpu_torch.models.resnet import resnet18, resnet50
from isbfsar_tpu_torch.ops.image import square_box_crop_gather
from isbfsar_tpu_torch.utils.transfer import to_device
from isbfsar_tpu_torch.weights import convert_mutual_gaze, convert_variables

DETECTOR_INPUT = 256  # MutualGazeDetector's head-detector input size


def build_nets(nets: Mapping[str, torch.nn.Module], state_dicts: Optional[Mapping], seed: int,
               device: torch.device) -> None:
    """Load each net from ``state_dicts[name]``, or fill all of them from
    one seeded generator; then move them to ``device`` in inference mode."""
    gen = torch.Generator().manual_seed(seed)
    for name, net in nets.items():
        if state_dicts is None:
            init_random(net, gen)
        else:
            net.load_state_dict(state_dicts[name], strict=True)
        net.eval().to(device)


def detect_best(net: torch.nn.Module, frame: torch.Tensor, size: int):
    """(H, W, 3) BGR float frame -> the best box's (pixels (4,), score) from
    a detector whose outputs start with boxes and end with scores
    (``HeadDetectorNet``, ``BlazeFaceLite``), on the frame resized to
    ``size`` x ``size`` (argmax: the first of ties)."""
    h, w = frame.shape[0], frame.shape[1]
    x = resize_linear(frame[None], size, size).flip(-1) / 255.0
    out = net(x.permute(0, 3, 1, 2))
    boxes, scores = out[0], out[-1]
    best = torch.argmax(scores[0])
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=frame.device)
    return boxes[0, best] * scale, scores[0, best]


def backbone_for(name: str, dtype: torch.dtype):
    """(trunk, feature width): "resnet50" -> ResNet-50, else ResNet-18."""
    return (resnet50(dtype), 2048) if name == "resnet50" else (resnet18(dtype), 512)


class HeadDetector:
    """The standalone head detector (reference head_detector.py API)."""

    def __init__(self, config: MutualGazeConfig, params: Optional[Mapping] = None, seed: int = 0,
                 input_size: int = 256, device: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        """params: HeadDetectorNet's Flax variables; None: random from ``seed``."""
        pin_float32_matmul()
        self.config = config
        self.input_size = input_size
        self.device = torch.device(device)
        self.net = HeadDetectorNet(dtype)
        state = None if params is None else {"net": convert_variables(params)}
        build_nets({"net": self.net}, state, seed, self.device)

    @torch.inference_mode()
    def _forward_impl(self, frame: torch.Tensor) -> Dict[str, torch.Tensor]:
        box, score = detect_best(self.net, frame.to(torch.float32), self.input_size)
        return {"box": box, "score": score}

    def estimate(self, frame: np.ndarray) -> Optional[Tuple[np.ndarray, float]]:
        out = self._forward_impl(to_device(frame, self.device))
        host = torch.cat([out["box"], out["score"][None]]).cpu().numpy()
        score = float(host[4])
        if score < self.config.score_thr:
            return None
        return host[:4], score


class MutualGazeDetector:
    """Head crop -> backbone -> sigmoid "looking at me" (reference focus.py)."""

    def __init__(self, config: MutualGazeConfig, params: Optional[Mapping] = None, seed: int = 0,
                 device: str = "cuda", dtype: torch.dtype = torch.bfloat16):
        """params: ``{"detector", "backbone", "classifier"}``, each Flax
        variables (JAX's tree); None: random from ``seed``."""
        pin_float32_matmul()
        self.config = config
        self.device = torch.device(device)
        backbone, feat_dim = backbone_for(config.backbone, dtype)
        self.nets = {"detector": HeadDetectorNet(dtype), "backbone": backbone,
                     "classifier": BinaryGazeClassifier(feat_dim)}
        build_nets(self.nets, None if params is None else convert_mutual_gaze(params), seed,
                   self.device)

    @torch.inference_mode()
    def _forward_impl(self, frame: torch.Tensor) -> Dict[str, Any]:
        """(H, W, 3) BGR frame on the device -> box, score, watching and the crop."""
        box, score = detect_best(self.nets["detector"], frame.to(torch.float32), DETECTOR_INPUT)
        crop = square_box_crop_gather(frame, box, self.config.crop_size)
        x = (crop.flip(-1) / 255.0)[None].permute(0, 3, 1, 2)
        watching = self.nets["classifier"](self.nets["backbone"](x))[0, 0]
        return {"box": box, "score": score, "watching": watching, "crop": crop}

    def estimate(self, frame: np.ndarray):
        """(is_watching, head box) or None under ``score_thr`` (reference
        focus.py)."""
        out = self._forward_impl(to_device(frame, self.device))
        host = torch.cat([out["box"], out["score"][None], out["watching"][None]]).cpu().numpy()
        if float(host[4]) < self.config.score_thr:
            return None
        return bool(float(host[5]) > 0.5), host[:4]
