"""The Hopenet head-pose detector, the alternative focus path (port of
``isbfsar_tpu/focus/head_pose.py``).

The frame resized (linear, antialiased) to 128x128, ``BlazeFaceLite`` and
its best face, a square crop of it at ``crop_size``
(``ops/image.py::square_box_crop_gather``) and :class:`HopeNet`'s
(yaw, pitch, roll) in degrees. ``estimate`` returns None under a 0.5 face
score, else ``{'bbox', 'yaw', 'pitch', 'roll'}``. No landmarks and no
Procrustes solve: the head-pose kernel is not on this path.

Runs on ``device`` (the card unless the caller asks for ``"cpu"``) in
``FocusConfig.compute_dtype``; ``params`` is JAX's ``{"face_det",
"hopenet"}`` tree of Flax variables, or None for random weights from
``seed``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.configs import FocusConfig
from isbfsar_tpu_torch.focus.mutual import build_nets, detect_best
from isbfsar_tpu_torch.models.gaze import BlazeFaceLite, HopeNet
from isbfsar_tpu_torch.models.layers import pin_float32_matmul
from isbfsar_tpu_torch.ops.image import square_box_crop_gather
from isbfsar_tpu_torch.utils.transfer import to_device
from isbfsar_tpu_torch.weights import convert_head_pose


class HeadPoseDetector:
    def __init__(self, config: Optional[FocusConfig] = None, params: Optional[Mapping] = None,
                 seed: int = 0, crop_size: int = 224, device: str = "cuda"):
        pin_float32_matmul()
        self.config = config or FocusConfig()
        self.crop_size = crop_size
        self.device = torch.device(device)
        dtype = getattr(torch, self.config.compute_dtype)
        self.nets = {"face_det": BlazeFaceLite(dtype), "hopenet": HopeNet(dtype)}
        build_nets(self.nets, None if params is None else convert_head_pose(params), seed,
                   self.device)

    @torch.inference_mode()
    def _forward_impl(self, frame: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(H, W, 3) BGR frame on the device -> box, score, angles (yaw,
        pitch, roll degrees) and the crop."""
        box, score = detect_best(self.nets["face_det"], frame.to(torch.float32), 128)
        crop = square_box_crop_gather(frame, box, self.crop_size)
        angles = self.nets["hopenet"]((crop.flip(-1) / 255.0)[None].permute(0, 3, 1, 2))[0]
        return {"box": box, "score": score, "angles": angles, "crop": crop}

    def estimate(self, frame: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
        """{'bbox', 'yaw', 'pitch', 'roll'} or None when no face."""
        out = self._forward_impl(to_device(frame, self.device))
        host = torch.cat([out["box"], out["score"][None], out["angles"]]).cpu().numpy()
        if float(host[4]) < 0.5:
            return None
        yaw, pitch, roll = (float(a) for a in host[5:8])
        return {"bbox": host[:4], "yaw": yaw, "pitch": pitch, "roll": roll}
