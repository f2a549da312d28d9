"""Gaze-based focus detection: "is the human looking at the camera?" (port
of ``isbfsar_tpu/focus/detector.py``).

Per frame: BlazeFaceLite on the frame resized to 128x128, a score-weighted
box over the eight best anchors, the landmark refiner on a 64x64 crop of
that box, head pose from the six landmarks and the ETH-XGaze
normalization camera (one launch of the CUDA kernel of
``ops/head_pose.py`` on the card), a bilinear warp to the normalized crop,
and GazeNet's pitch and yaw.
:meth:`FocusDetector._forward_impl` runs all of it batched over frames and
reads nothing back to the host, so the pipeline's CUDA graph holds it.

On the host, :meth:`FocusDetector.estimate_collect` reads a frame's fields
with one device -> host copy and applies the close/far heuristic: a face
whose box covers more than ``area_thr`` of the frame is "close" and in
focus iff its normalized gaze z is below ``close_thr`` and its head yaw
under ``foc_rot_thr``; a far face is in focus iff its normalized head yaw
is under ``dist_thr``; ``is_focus`` is the majority over the last
``patience`` verdicts.

The constructor turns TF32 off for matmuls and cuDNN convolutions
(process-wide PyTorch state), as the pipeline does: the float32 operating
point must compute in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isbfsar_tpu_torch.configs import CameraIntrinsics, FocusConfig
from isbfsar_tpu_torch.focus.geometry import denormalize_gaze
from isbfsar_tpu_torch.models.gaze import BlazeFaceLite, GazeNet, LandmarkRefiner, pitchyaw_to_vector
from isbfsar_tpu_torch.models.layers import init_random, pin_float32_matmul
from isbfsar_tpu_torch.ops.head_pose import focus_geometry
from isbfsar_tpu_torch.ops.warp import warp_image_bilinear
from isbfsar_tpu_torch.utils.transfer import HostCopy, to_device
from isbfsar_tpu_torch.weights import convert_focus

TOP_K = 8  # anchors in the box ensemble


@dataclasses.dataclass
class Face:
    """One detected face (the reference's ptgaze ``Face`` fields)."""

    bbox: np.ndarray  # (2, 2) [[x1, y1], [x2, y2]] pixels
    landmarks: np.ndarray  # (6, 2) pixels
    score: float
    head_position: np.ndarray  # (3,) camera space
    head_pose_rotvec: np.ndarray  # (3,) axis-angle
    normalized_head_rot2d: np.ndarray  # (2,) rotvec xy of the head in the normalized camera
    gaze_vector: np.ndarray  # (3,) camera frame
    normalized_gaze_vector: np.ndarray  # (3,) normalized-camera frame
    normalized_image: Optional[np.ndarray] = None


def top_k_stable(scores: torch.Tensor, k: int):
    """The ``k`` largest of (B, n) scores, ties to the lower index, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no tie order)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def resize_linear(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) float32, triangle filter with
    antialiasing when downscaling, as ``jax.image.resize(..., "linear")``."""
    x = frames.to(torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


class FocusDetector:
    def __init__(
        self,
        config: FocusConfig,
        intrinsics: Optional[CameraIntrinsics] = None,
        params: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        frame_shape: Tuple[int, int] = (480, 640),
        device: str = "cuda",
    ):
        """params: a focus bundle tree ``{"face_det", "lm_refiner",
        "gaze_net"}`` of Flax variables (``weights.load_bundle("focus-ci")``,
        or numpy trees from JAX); None initializes random weights from ``seed``."""
        pin_float32_matmul()
        self.config = config
        self.frame_shape = frame_shape
        self.device = torch.device(device)
        dtype = getattr(torch, config.compute_dtype)
        self.nets = {"face_det": BlazeFaceLite(dtype), "lm_refiner": LandmarkRefiner(dtype),
                     "gaze_net": GazeNet(dtype)}
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            for name in ("face_det", "lm_refiner", "gaze_net"):
                init_random(self.nets[name], gen)
        else:
            for name, sd in convert_focus(params).items():
                self.nets[name].load_state_dict(sd, strict=True)
        for net in self.nets.values():
            net.eval().to(self.device)
        self.k_matrix = torch.from_numpy((intrinsics or CameraIntrinsics()).matrix()).to(self.device)
        self.focuses: list = []
        self.is_close: Optional[bool] = None
        self.is_focus: Optional[bool] = None

    # ---------------------------------------------------------------- fused

    @torch.inference_mode()
    def _forward_impl(self, nets: Dict[str, torch.nn.Module], frames: torch.Tensor,
                      stages: Optional[dict] = None):
        """(B, H, W, 3) BGR frames (uint8 or unrounded float) -> dict of
        per-frame face quantities with a leading batch axis. stages: a dict
        that, when given, receives the intermediate tensors in the order
        they are computed (``stage_trace.py`` reads it)."""
        cfg = self.config
        h, w = frames.shape[1], frames.shape[2]
        size = cfg.gaze_image_size
        frames = frames.to(torch.float32)

        det_in = resize_linear(frames, 128, 128).flip(-1) / 255.0
        boxes, _, scores = nets["face_det"](det_in.permute(0, 3, 1, 2))

        # the box: a score-weighted mean over the top-k anchors
        top_s, top_i = top_k_stable(scores, TOP_K)
        score = top_s[:, 0]
        wgt = top_s / torch.clamp(top_s.sum(dim=-1, keepdim=True), min=1e-6)
        top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
        unit = (top_boxes * wgt[..., None]).sum(dim=1)
        box = torch.stack([unit[:, 0] * w, unit[:, 1] * h, unit[:, 2] * w, unit[:, 3] * h], dim=-1)

        # landmark refinement on a 64x64 crop of the box, 1.4 times its side
        cx = (box[:, 0] + box[:, 2]) * 0.5
        cy = (box[:, 1] + box[:, 3]) * 0.5
        side = torch.clamp(1.4 * torch.maximum(box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]),
                           min=8.0)
        x0 = cx - side * 0.5
        y0 = cy - side * 0.5
        s_px = side / 64.0
        zero = torch.zeros_like(s_px)
        crop_mat = torch.stack([
            torch.stack([s_px, zero, x0], dim=-1),
            torch.stack([zero, s_px, y0], dim=-1),
            torch.stack([zero, zero, zero + 1.0], dim=-1),
        ], dim=1)
        lm_crop = warp_image_bilinear(frames, crop_mat, 64)
        ref = nets["lm_refiner"]((lm_crop.flip(-1) / 255.0).permute(0, 3, 1, 2))  # (B, 6, 2)
        landmarks = ref * side[:, None, None] + torch.stack([x0, y0], dim=-1)[:, None, :]

        # head pose, its rotation vector, the normalization camera and the
        # head's rotation in it
        geo = focus_geometry(landmarks.contiguous(), self.k_matrix, cfg.normalized_camera_distance,
                             cfg.normalized_camera_distance, size)
        crop = warp_image_bilinear(frames, geo.warp, size)
        pitchyaw = nets["gaze_net"]((crop.flip(-1) / 255.0).permute(0, 3, 1, 2))
        norm_gaze = pitchyaw_to_vector(pitchyaw)
        gaze = denormalize_gaze(norm_gaze, geo.r_norm)
        if stages is not None:
            stages.update(face_in=det_in, face_scores=scores, face_box=box, lm_crop=lm_crop,
                          landmarks=landmarks, head_rot=geo.rot, head_center=geo.center,
                          gaze_warp=geo.warp, gaze_crop=crop, pitchyaw=pitchyaw)
        return {
            "found": score > 0.5,
            "score": score,
            "bbox": box,
            "landmarks": landmarks,
            "head_position": geo.center,
            "head_rotvec": geo.rotvec,
            "normalized_head_rot2d": geo.head_rot2d,
            "gaze_vector": gaze,
            "normalized_gaze_vector": norm_gaze,
            "normalized_image": crop,
        }

    # ----------------------------------------------------------- public API

    @torch.inference_mode()
    def estimate_async(self, frame) -> Dict[str, Any]:
        """Enqueue one (H, W, 3) BGR frame (a host uint8 array, or a tensor
        already on the device, which the module path shares with the pose
        estimator) and start the copy of its small fields to the host in one
        piece; waits for nothing on the card. The normalized image stays on
        the device."""
        if isinstance(frame, np.ndarray):
            frame = to_device(frame, self.device)
        out = {k: v[0] for k, v in self._forward_impl(self.nets, frame[None]).items()}
        image = out.pop("normalized_image")
        return {"fields": _FieldCopy(out), "normalized_image": image}

    def estimate_collect(self, out: Mapping[str, Any], return_image: bool = False):
        """Read one frame's fields to the host with one device -> host copy
        (the image, a second one, only when asked), then apply the close/far
        rule and the ``patience`` vote. ``out`` is :meth:`estimate_async`'s
        token, or a dict of one frame's fields (tensors or host arrays).
        Returns (focus, Face), or None when no face was found."""
        cfg = self.config
        if isinstance(out.get("fields"), _FieldCopy):
            host = out["fields"].numpy()
        else:
            host = _FieldCopy({k: v for k, v in out.items() if k != "normalized_image"}).numpy()
        if not bool(host["found"]):
            return None
        image = out.get("normalized_image") if return_image else None
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        face = Face(
            bbox=np.asarray(host["bbox"], np.float64).reshape(2, 2),
            landmarks=np.asarray(host["landmarks"]),
            score=float(host["score"]),
            head_position=np.asarray(host["head_position"]),
            head_pose_rotvec=np.asarray(host["head_rotvec"]),
            normalized_head_rot2d=np.asarray(host["normalized_head_rot2d"]),
            gaze_vector=np.asarray(host["gaze_vector"]),
            normalized_gaze_vector=np.asarray(host["normalized_gaze_vector"]),
            normalized_image=None if image is None else np.asarray(image),
        )
        h, w = self.frame_shape
        area = ((face.bbox[1][0] - face.bbox[0][0]) * (face.bbox[1][1] - face.bbox[0][1])) / (w * h)
        if area > cfg.area_thr:  # close: the eyes decide
            self.is_close = True
            focus = bool(face.normalized_gaze_vector[2] < cfg.close_thr
                         and abs(face.head_pose_rotvec[1]) < cfg.foc_rot_thr)
        else:  # far: the head pose decides
            self.is_close = False
            focus = bool(abs(face.normalized_head_rot2d[1]) < cfg.dist_thr)
        self.focuses.append(focus)
        self.focuses = self.focuses[-cfg.patience:]
        # the majority vote is kept on is_focus; the instantaneous verdict is
        # returned, as the reference does
        self.is_focus = self.focuses.count(True) > len(self.focuses) / 2
        return focus, face

    def estimate(self, frame: np.ndarray, return_image: bool = False):
        """(focus, Face) or None when no face was found."""
        return self.estimate_collect(self.estimate_async(frame), return_image)

    def warmup(self, n: int = 2) -> None:
        dummy = np.zeros(self.frame_shape + (3,), np.uint8)
        for _ in range(n):
            self.estimate_async(dummy)["fields"].numpy()


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type a field of ``dtype`` is read back as (bf16 and fp16 as float32)."""
    if dtype in (torch.bfloat16, torch.float16):
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


class _FieldCopy:
    """One frame's fields copied to the host in one piece: tensors are
    packed into one float64 vector (exact for their float32, int and bool
    values) and copied with one :class:`HostCopy`; :meth:`numpy` splits it
    back into arrays of their own types. Host values pass through."""

    def __init__(self, fields: Mapping[str, Any]):
        tensors = {k: v for k, v in fields.items() if isinstance(v, torch.Tensor)}
        self._host = {k: v for k, v in fields.items() if k not in tensors}
        self._specs = [(k, tuple(v.shape), _host_dtype(v.dtype)) for k, v in tensors.items()]
        self._copy = HostCopy(torch.cat([v.reshape(-1).to(torch.float64)
                                         for v in tensors.values()])) if tensors else None

    def numpy(self) -> Dict[str, Any]:
        out = dict(self._host)
        if self._copy is not None:
            flat, offset = self._copy.numpy(), 0
            for k, shape, dtype in self._specs:
                n = int(np.prod(shape))
                out[k] = flat[offset:offset + n].reshape(shape).astype(dtype)
                offset += n
        return out
