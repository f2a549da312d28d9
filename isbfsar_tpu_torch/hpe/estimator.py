"""Human pose estimation: frames -> absolute 3D skeletons (port of
``isbfsar_tpu/hpe/estimator.py``).

YOLO input -> YOLOv4 -> best person box -> virtual camera -> crop warp ->
EfficientNetV2 + MetrABS head -> 2D/3D soft-argmax -> FOV mask -> absolute
reconstruction -> de-rotation -> 32 -> 30 joint matrix. Batched over a
leading frame axis where the JAX code ran one frame and was vmapped.

With ``HPEConfig.num_aug`` = A > 0 (test-time augmentation), each frame's
virtual camera is scaled, rotated and, for some augmentations, flipped A
ways; the B*A crops run through the nets as one batch, each crop reading
its own frame's pixels, and each frame's pose is aggregated over its A:
``"aug0"`` keeps augmentation 0's, ``"mean"`` the visibility-weighted mean
over the unflipped ones. Everything this reads lives on the device, so the
step stays one CUDA graph. With ``skeleton=None`` the pose is the full
122-joint expansion and ``edges`` is None.

Nets are passed to ``_detect`` / ``_estimate_impl`` / ``_box_impl`` as a
dict ``{"yolo", "bbone", "head"}``, the counterpart of the JAX params
argument, so the pipeline can hand in its cast copies.

The module path of the orchestrator calls :meth:`estimate_async`, which
enqueues the frame and starts the result's copy to the host without
waiting for the card, then :meth:`estimate_collect`, which waits for that
one copy and returns the reference's contract: a dict with ``pose``
(30, 3), ``edges`` and ``bbox`` (x1, x2, y1, y2), or None when no person is
found or too few joints are in view (``just_box``: the bbox alone).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.configs import CameraIntrinsics, HPEConfig
from isbfsar_tpu_torch.models.effnetv2 import V2_L, EfficientNetV2, MetrabsHead
from isbfsar_tpu_torch.models.layers import init_random, pin_float32_matmul
from isbfsar_tpu_torch.models.yolov4 import YOLOv4
from isbfsar_tpu_torch.ops.geometry import (is_within_fov, mm, tta_params, virtual_camera,
                                            warp_matrix)
from isbfsar_tpu_torch.ops.image import yolo_preprocess
from isbfsar_tpu_torch.ops.nms import best_person_box
from isbfsar_tpu_torch.ops.reconstruct import reconstruct_absolute
from isbfsar_tpu_torch.ops.softargmax import decode_heatmap2d, decode_heatmap3d, split_head_logits
from isbfsar_tpu_torch.ops.warp import to_int32, warp_image
from isbfsar_tpu_torch.utils.skeleton import get_skeleton, joint_matrix
from isbfsar_tpu_torch.utils.transfer import HostCopy, to_device
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
        just_box: Optional[bool] = None,
    ):
        """params: a pose-stack bundle tree ``{"yolo", "bbone", "head"}`` of
        Flax variables (``weights.load_calibrated``, or numpy trees from JAX);
        None initializes random weights from ``seed``. just_box: run the
        detector alone (default ``config.just_box``)."""
        self.config = config
        self.just_box = config.just_box if just_box is None else just_box
        self.frame_shape = frame_shape
        self.device = torch.device(device)
        # float32 convolutions in full float32, as JAX's (no TF32), also
        # where no pipeline or focus detector has turned TF32 off yet
        pin_float32_matmul()
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
        self.skeleton = (get_skeleton(config.skeleton, config.skeletons_path)
                         if config.skeleton else None)
        self.edges = self.skeleton.edges if self.skeleton is not None else None
        self.joint_matrix = torch.from_numpy(joint_matrix(
            config.skeleton, config.expand_joints_path, config.skeletons_path)).to(self.device)
        self._tta = self._tta_setup(config) if config.num_aug > 0 else None

    def _tta_setup(self, config: HPEConfig) -> Dict[str, torch.Tensor]:
        """The augmentations on the device: ``keep`` (A,) float32, 1 on the
        unflipped ones, ``rotflip`` (A, 3, 3) and ``scales`` (A,)."""
        flip, rotflip, scales = tta_params(config.num_aug)
        if config.tta_aggregate == "aug0" and bool(flip[0]):
            # aug 0 is flipped for num_aug % 4 in {2, 3}, and its kept pose
            # would be mirrored left to right: refused, as in JAX
            raise ValueError(
                f"tta_aggregate='aug0' with num_aug={config.num_aug}: "
                f"aug 0 is a flipped augmentation for this count and the "
                f"kept prediction would be left/right mirrored. Use "
                f"num_aug with num_aug % 4 in {{0, 1}} (e.g. 4, 5) or "
                f"tta_aggregate='mean'.")
        # the scales come out one short for an even count: pad with the last
        if len(scales) < config.num_aug:
            scales = np.concatenate([scales, np.repeat(scales[-1:], config.num_aug - len(scales))])
        return {"keep": torch.from_numpy(~flip).to(self.device, torch.float32),
                "rotflip": torch.from_numpy(rotflip).to(self.device),
                "scales": torch.from_numpy(scales.astype(np.float32)).to(self.device)}

    def _detect(self, nets: Dict[str, torch.nn.Module], frames: torch.Tensor, yolo_in=None,
                stages: Optional[dict] = None):
        """frames (B, H, W, 3) -> clamped pixel boxes (x1, y1, x2, y2) int32,
        conf (B,), found (B,). yolo_in: optional (B, 1, S, S, 3) RGB/255.
        stages: a dict that, when given, receives the intermediate tensors."""
        cfg = self.config
        h, w = frames.shape[1], frames.shape[2]
        if yolo_in is None:
            yolo_in = yolo_preprocess(frames, cfg.yolo_input_size)
        boxes, confs = nets["yolo"](yolo_in[:, 0].permute(0, 3, 1, 2))
        box, conf, found = best_person_box(boxes, confs, cfg.yolo_thresh)
        if stages is not None:
            stages.update(yolo_in=yolo_in, yolo_boxes=boxes, yolo_confs=confs)
        zero = torch.zeros((), dtype=torch.int32, device=box.device)
        x1 = torch.maximum(to_int32(box[:, 0] * w), zero)
        y1 = torch.maximum(to_int32(box[:, 1] * h), zero)
        x2 = torch.maximum(to_int32(box[:, 2] * w), zero)
        y2 = torch.maximum(to_int32(box[:, 3] * h), zero)
        x2 = torch.maximum(x2, x1 + 1)
        y2 = torch.maximum(y2, y1 + 1)
        return (x1, y1, x2, y2), conf, found

    def _box_impl(self, nets: Dict[str, torch.nn.Module], frames: torch.Tensor, yolo_in=None):
        """frames (B, H, W, 3) -> bbox (B, 4) int32 in the full path's
        (x1, x2, y1, y2) order, conf (B,), found (B,): the detector alone
        (``just_box``)."""
        (x1, y1, x2, y2), conf, found = self._detect(nets, frames, yolo_in)
        return torch.stack([x1, x2, y1, y2], dim=-1), conf, found

    def _estimate_impl(self, nets: Dict[str, torch.nn.Module], frames: torch.Tensor, yolo_in=None,
                       stages: Optional[dict] = None):
        """frames (B, H, W, 3) BGR -> pose (B, J, 3), bbox (B, 4) int32 in
        (x1, x2, y1, y2) order, conf (B,), found (B,), visible (B,).
        stages: a dict that, when given, receives the intermediate tensors
        in the order the step computes them (``stage_trace.py`` reads it)."""
        cfg = self.config
        (x1, y1, x2, y2), conf, found = self._detect(nets, frames, yolo_in, stages)
        f32 = lambda v: v.to(torch.float32)
        new_k, rot = virtual_camera(f32(x1), f32(x2), f32(y1), f32(y2), self.k_matrix, cfg.crop_size)
        b = frames.shape[0]
        frame_index = None
        if self._tta is not None:
            # (B, A) augmented cameras, flattened frame-major to B*A crops
            a = cfg.num_aug
            new_k = new_k[:, None].expand(b, a, 3, 3).clone()
            new_k[:, :, :2, :2] *= self._tta["scales"][:, None, None]
            rot = mm(self._tta["rotflip"].expand(b, a, 3, 3), rot[:, None].expand(b, a, 3, 3))
            new_k, rot = new_k.reshape(b * a, 3, 3), rot.reshape(b * a, 3, 3)
            frame_index = torch.arange(b, device=frames.device)[:, None].expand(b, a).reshape(-1)
        h_mat = warp_matrix(self.k_matrix, new_k, rot)
        # round to nearest, not truncate: the I420 decode gives float BGR
        crop = warp_image(torch.round(frames.to(torch.float32)), h_mat, cfg.crop_size, frame_index)
        bbone_in = (crop / 255.0).permute(0, 3, 1, 2)

        feats = nets["bbone"](bbone_in)
        logits = nets["head"](feats)  # (B, 8, 8, 288) NHWC
        logits2d, logits3d = split_head_logits(logits)
        pred3d = decode_heatmap3d(logits3d)
        c = cfg.crop_size
        pred2d = decode_heatmap2d(logits2d, scale=float(c - 1))
        fov = is_within_fov(pred2d, lower=18.0 * c / 256.0, upper=238.0 * c / 256.0)

        pred3d = reconstruct_absolute(pred2d, pred3d, new_k, fov)
        pred3d = mm(pred3d, rot)  # back to the original camera
        pose = torch.einsum("bjc,jn->bnc", pred3d, self.joint_matrix)
        if self._tta is None:
            visible = fov.sum(dim=1) >= fov.shape[1] / 4
        else:
            pose, visible = self._aggregate(pose.reshape(b, cfg.num_aug, *pose.shape[1:]),
                                            fov.reshape(b, cfg.num_aug, -1))
        bbox = torch.stack([x1, x2, y1, y2], dim=-1)
        if stages is not None:
            stages.update(box=bbox, homography=h_mat, crop=crop, trunk=feats, logits=logits,
                          pred2d=pred2d, abs3d=pred3d, pose=pose)
        return pose, bbox, conf, found, visible

    def _aggregate(self, poses: torch.Tensor, fov: torch.Tensor):
        """poses (B, A, J, 3), fov (B, A, 32) -> each frame's pose (B, J, 3)
        and visible (B,), by ``HPEConfig.tta_aggregate``."""
        vis = fov.sum(dim=2) >= fov.shape[2] / 4  # (B, A)
        if self.config.tta_aggregate == "aug0":
            return poses[:, 0], vis[:, 0]
        # the visibility-weighted mean over the unflipped augmentations; when
        # none of them is visible, their plain mean
        keep = self._tta["keep"]
        w_raw = keep * vis
        w_sum = w_raw.sum(dim=1, keepdim=True)
        keep_norm = keep / torch.clamp(keep.sum(), min=1.0)
        w = torch.where(w_sum > 0, w_raw / torch.clamp(w_sum, min=1e-6), keep_norm)
        # a sum over the augmentations in order, the same on every batch size
        pose = w[:, 0, None, None] * poses[:, 0]
        for i in range(1, poses.shape[1]):
            pose = pose + w[:, i, None, None] * poses[:, i]
        return pose, ((keep > 0) & vis).any(dim=1)

    # ------------------------------------------------------------ public API

    @torch.inference_mode()
    def estimate_async(self, frame) -> Tuple[str, HostCopy]:
        """Enqueue one (H, W, 3) BGR frame (a host uint8 array, or a tensor
        already on the device) and start the copy of its result to the host;
        waits for nothing on the card. Returns the token for
        :meth:`estimate_collect`: the result packed into one float32 row
        (bbox, conf and found, then pose and visible on the full path)."""
        if isinstance(frame, np.ndarray):
            frame = to_device(frame, self.device)
        frames = frame[None]
        if self.just_box:
            bbox, conf, found = self._box_impl(self.nets, frames)
            parts = (bbox, conf[:, None], found[:, None])
        else:
            pose, bbox, conf, found, visible = self._estimate_impl(self.nets, frames)
            parts = (bbox, conf[:, None], found[:, None], pose.reshape(1, -1), visible[:, None])
        packed = torch.cat([p.to(torch.float32) for p in parts], dim=1)[0]
        return ("box" if self.just_box else "full", HostCopy(packed))

    def estimate_collect(self, token) -> Optional[Dict[str, Any]]:
        """Wait for a dispatched frame's one host copy and decode the
        reference's dict-or-None contract."""
        kind, copy = token
        row = copy.numpy()
        x1, x2, y1, y2 = (int(v) for v in row[:4])
        if not row[5] > 0:  # found
            return None
        if kind == "box":
            return {"bbox": (x1, x2, y1, y2)}
        if not row[-1] > 0:  # visible
            return None
        return {"pose": row[6:-1].reshape(-1, 3).copy(), "edges": self.edges,
                "bbox": (x1, x2, y1, y2)}

    def estimate(self, frame) -> Optional[Dict[str, Any]]:
        """frame: (H, W, 3) BGR uint8. Returns the reference's dict contract."""
        return self.estimate_collect(self.estimate_async(frame))

    def warmup(self, n: int = 2) -> None:
        """Run the path ``n`` times on an empty frame (cuDNN's algorithm
        choice and lazy CUDA initialization happen here, not on a live frame)."""
        dummy = np.zeros(self.frame_shape + (3,), np.uint8)
        for _ in range(n):
            self.estimate_collect(self.estimate_async(dummy))
