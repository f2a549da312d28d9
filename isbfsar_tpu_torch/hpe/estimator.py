"""Human pose estimation: frames -> absolute 3D skeletons (port of
``isbfsar_tpu/hpe/estimator.py``, the ``num_aug=0`` path).

YOLO input -> YOLOv4 -> best person box -> virtual camera -> crop warp ->
EfficientNetV2 + MetrABS head -> 2D/3D soft-argmax -> FOV mask -> absolute
reconstruction -> de-rotation -> 32 -> 30 joint matrix. Batched over a
leading frame axis where the JAX code ran one frame and was vmapped.

Nets are passed to ``_detect`` / ``_estimate_impl`` as a dict
``{"yolo", "bbone", "head"}``, the counterpart of the JAX params argument,
so the pipeline can hand in its cast copies.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from isbfsar_tpu_torch.configs import CameraIntrinsics, HPEConfig
from isbfsar_tpu_torch.models.effnetv2 import V2_L, EfficientNetV2, MetrabsHead
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.yolov4 import YOLOv4
from isbfsar_tpu_torch.ops.geometry import is_within_fov, mm, virtual_camera, warp_matrix
from isbfsar_tpu_torch.ops.image import yolo_preprocess
from isbfsar_tpu_torch.ops.nms import best_person_box
from isbfsar_tpu_torch.ops.reconstruct import reconstruct_absolute
from isbfsar_tpu_torch.ops.softargmax import decode_heatmap2d, decode_heatmap3d, split_head_logits
from isbfsar_tpu_torch.ops.warp import to_int32, warp_image
from isbfsar_tpu_torch.utils.skeleton import get_skeleton, joint_matrix
from isbfsar_tpu_torch.weights import convert_pose_stack


class HumanPoseEstimator:
    def __init__(
        self,
        config: HPEConfig,
        intrinsics: CameraIntrinsics,
        params: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        backbone_stages: Sequence = V2_L,
        frame_shape: Tuple[int, int] = (480, 640),
        yolo_width: float = 1.0,
        device: str = "cuda",
    ):
        """params: a pose-stack bundle tree ``{"yolo", "bbone", "head"}`` of
        Flax variables (``weights.load_calibrated``, or numpy trees from JAX);
        None initializes random weights from ``seed``."""
        self.config = config
        self.frame_shape = frame_shape
        self.device = torch.device(device)
        dtype = getattr(torch, config.compute_dtype)
        self.nets = {
            "yolo": YOLOv4(width=yolo_width, dtype=dtype),
            "bbone": EfficientNetV2(stages=backbone_stages, dtype=dtype),
            "head": MetrabsHead(),
        }
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            for name in ("yolo", "bbone", "head"):
                init_random(self.nets[name], gen)
        else:
            for name, sd in convert_pose_stack(params).items():
                self.nets[name].load_state_dict(sd, strict=True)
        for net in self.nets.values():
            net.eval().to(self.device)
        self.k_matrix = torch.from_numpy(intrinsics.matrix()).to(self.device)
        self.skeleton = get_skeleton(config.skeleton, config.skeletons_path)
        self.edges = self.skeleton.edges
        self.joint_matrix = torch.from_numpy(joint_matrix(
            config.skeleton, config.expand_joints_path, config.skeletons_path)).to(self.device)

    def _detect(self, nets: Dict[str, torch.nn.Module], frames: torch.Tensor, yolo_in=None):
        """frames (B, H, W, 3) -> clamped pixel boxes (x1, y1, x2, y2) int32,
        conf (B,), found (B,). yolo_in: optional (B, 1, S, S, 3) RGB/255."""
        cfg = self.config
        h, w = frames.shape[1], frames.shape[2]
        if yolo_in is None:
            yolo_in = yolo_preprocess(frames, cfg.yolo_input_size)
        boxes, confs = nets["yolo"](yolo_in[:, 0].permute(0, 3, 1, 2))
        box, conf, found = best_person_box(boxes, confs, cfg.yolo_thresh)
        zero = torch.zeros((), dtype=torch.int32, device=box.device)
        x1 = torch.maximum(to_int32(box[:, 0] * w), zero)
        y1 = torch.maximum(to_int32(box[:, 1] * h), zero)
        x2 = torch.maximum(to_int32(box[:, 2] * w), zero)
        y2 = torch.maximum(to_int32(box[:, 3] * h), zero)
        x2 = torch.maximum(x2, x1 + 1)
        y2 = torch.maximum(y2, y1 + 1)
        return (x1, y1, x2, y2), conf, found

    def _estimate_impl(self, nets: Dict[str, torch.nn.Module], frames: torch.Tensor, yolo_in=None):
        """frames (B, H, W, 3) BGR -> pose (B, J, 3), bbox (B, 4) int32 in
        (x1, x2, y1, y2) order, conf (B,), found (B,), visible (B,)."""
        cfg = self.config
        (x1, y1, x2, y2), conf, found = self._detect(nets, frames, yolo_in)
        f32 = lambda v: v.to(torch.float32)
        new_k, rot = virtual_camera(f32(x1), f32(x2), f32(y1), f32(y2), self.k_matrix, cfg.crop_size)
        h_mat = warp_matrix(self.k_matrix, new_k, rot)
        # round to nearest, not truncate: the I420 decode gives float BGR
        crop = warp_image(torch.round(frames.to(torch.float32)), h_mat, cfg.crop_size)
        bbone_in = (crop / 255.0).permute(0, 3, 1, 2)

        logits = nets["head"](nets["bbone"](bbone_in))  # (B, 8, 8, 288) NHWC
        logits2d, logits3d = split_head_logits(logits)
        pred3d = decode_heatmap3d(logits3d)
        c = cfg.crop_size
        pred2d = decode_heatmap2d(logits2d, scale=float(c - 1))
        fov = is_within_fov(pred2d, lower=18.0 * c / 256.0, upper=238.0 * c / 256.0)

        pred3d = reconstruct_absolute(pred2d, pred3d, new_k, fov)
        pred3d = mm(pred3d, rot)  # back to the original camera
        pose = torch.einsum("bjc,jn->bnc", pred3d, self.joint_matrix)
        visible = fov.sum(dim=1) >= fov.shape[1] / 4
        bbox = torch.stack([x1, x2, y1, y2], dim=-1)
        return pose, bbox, conf, found, visible
