"""The gaze-focus trainers (port of ``isbfsar_tpu/train/gazefocus.py``).

* :func:`render_face_scene` and :class:`SyntheticFaceSampler`: a schematic
  face with exact projective ground truth (6 landmarks of the canonical
  face, rotated by the head's yaw and projected), whose pupils encode the
  gaze label; drawn with ``utils/draw.py`` (cv2's circle and filled
  ellipse, pixel for pixel), the generator consumed in JAX's order.
* :class:`BlazeFaceTrainer` (:func:`blazeface_loss`),
  :class:`LandmarkRefinerTrainer` and :class:`GazeTrainer`: each net trained
  with batch statistics and JAX's optimizer (``train/optim.py``).
* :func:`make_refiner_crop`: the refiner's 64x64 crop, cv2's
  ``warpAffine`` as ``ops/image.py::warp_affine_linear_u8``.
* :func:`make_normalized_crop_fn`: the live detector's normalized gaze
  crop, batched: ``ops/head_pose.py::focus_geometry`` (on the card the
  ``head_pose.cu`` kernel, one launch a batch) gives each frame's ``warp``
  and ``r_norm``, and ``warp_image_bilinear`` samples the crops.
* :func:`train_focus_params`: the three phases, each from its own sampler,
  every batch's random numbers drawn in JAX's order before its crops are
  made; returns the tree ``FocusDetector(params=...)`` loads.

Every trainer takes ``device`` (the card by default) and an optional Flax
tree to start from (the JAX trainers draw their own init from ``seed``;
the port fills its nets with ``layers.init_random`` from ``seed``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.configs import CameraIntrinsics, FocusConfig
from isbfsar_tpu_torch.focus.geometry import CANONICAL_FACE_3D
from isbfsar_tpu_torch.models.gaze import (BlazeFaceLite, GazeNet, LandmarkRefiner,
                                           pitchyaw_to_vector, vector_to_pitchyaw)
from isbfsar_tpu_torch.ops.geometry import mm
from isbfsar_tpu_torch.ops.head_pose import focus_geometry
from isbfsar_tpu_torch.ops.image import resize_linear_u8, warp_affine_linear_u8
from isbfsar_tpu_torch.ops.warp import warp_image_bilinear
from isbfsar_tpu_torch.train.posestack import NetTrainer, pairwise_iou, smooth_l1
from isbfsar_tpu_torch.utils import draw

# ------------------------------------------------------- synthetic scenes

# canonical ear-to-ear width of CANONICAL_FACE_3D (metres)
_FACE_WIDTH = 0.14


def render_face_scene(
    area_frac: float,
    gaze_pitchyaw: Tuple[float, float] = (0.0, 0.0),
    center: Optional[Tuple[float, float]] = None,
    frame_hw: Tuple[int, int] = (480, 640),
    rng: Optional[np.random.Generator] = None,
    head_yaw: float = 0.0,
    intrinsics: Optional[CameraIntrinsics] = None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """A schematic face at the depth where it spans ``area_frac`` of the
    frame, its head turned by ``head_yaw``. Returns (frame uint8 BGR,
    {"bbox": (4,) x1y1x2y2 in [0, 1], "landmarks": (6, 2) in [0, 1] in the
    mediapipe order, "head_rotvec": (3,)}); the pupils shift with
    ``gaze_pitchyaw``."""
    rng = rng or np.random.default_rng(0)
    h, w = frame_hw
    k = (intrinsics or CameraIntrinsics()).matrix()
    f = float(k[0, 0])
    side = float(np.sqrt(area_frac * w * h))
    cx, cy = center if center is not None else (w / 2, h / 2)

    z = f * _FACE_WIDTH / side
    pos = np.asarray([(cx - k[0, 2]) / f * z, (cy - k[1, 2]) / f * z, z])
    c, s = np.cos(head_yaw), np.sin(head_yaw)
    rot_y = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pts3 = CANONICAL_FACE_3D @ rot_y.T + pos
    proj = pts3 @ k.T
    lms = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)  # (6, 2) pixels

    frame = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
    draw.ellipse(frame, (int(cx), int(cy)), (int(side / 2), int(side / 2)), (120, 150, 200))

    pitch, yaw = gaze_pitchyaw
    eye_r = max(3, int(side * 0.14))
    pupil_r = max(2, int(eye_r * 0.55))
    pupil_dx = int(np.clip(yaw, -1, 1) * (eye_r - pupil_r))
    pupil_dy = int(np.clip(pitch, -1, 1) * (eye_r - pupil_r))
    for ex, ey in lms[:2]:  # eyes
        draw.circle(frame, (int(ex), int(ey)), eye_r, (250, 250, 250))
        draw.circle(frame, (int(ex + pupil_dx), int(ey + pupil_dy)), pupil_r, (20, 20, 20))
    draw.circle(frame, (int(lms[2, 0]), int(lms[2, 1])), max(1, eye_r // 2), (60, 90, 160))
    draw.ellipse(frame, (int(lms[3, 0]), int(lms[3, 1])),
                 (int(side * 0.18), max(1, eye_r // 2)), (40, 40, 120))
    for ex, ey in lms[4:]:  # ears
        draw.circle(frame, (int(ex), int(ey)), max(1, eye_r // 2), (110, 140, 190))

    bbox = np.asarray([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], np.float32)
    return frame, {
        "bbox": bbox / np.asarray([w, h, w, h], np.float32),
        "landmarks": lms / np.asarray([w, h], np.float32),
        "head_rotvec": np.asarray([0.0, head_yaw, 0.0], np.float32),
    }


class SyntheticFaceSampler:
    """Random scenes spanning small to large faces and gaze directions."""

    def __init__(self, frame_hw=(480, 640), seed: int = 0):
        self.frame_hw = frame_hw
        self.rng = np.random.default_rng(seed)

    def sample(self, min_area: float = 0.005, max_area: float = 0.25
               ) -> Tuple[np.ndarray, Dict[str, np.ndarray], Tuple[float, float]]:
        h, w = self.frame_hw
        area = float(np.exp(self.rng.uniform(np.log(min_area), np.log(max_area))))
        side = np.sqrt(area * w * h)
        cx = self.rng.uniform(side / 2 + 2, w - side / 2 - 2)
        cy = self.rng.uniform(side / 2 + 2, h - side / 2 - 2)
        gaze = (float(self.rng.uniform(-0.8, 0.8)), float(self.rng.uniform(-0.8, 0.8)))
        head_yaw = float(self.rng.uniform(-1.0, 1.0))
        frame, gt = render_face_scene(area, gaze, (cx, cy), self.frame_hw, self.rng,
                                      head_yaw=head_yaw)
        return frame, gt, gaze


# -------------------------------------------------------------- trainers


def blazeface_loss(boxes: torch.Tensor, lms: torch.Tensor, scores: torch.Tensor,
                   gt_box: torch.Tensor, gt_lms: torch.Tensor,
                   pos_iou: float = 0.35, neg_iou: float = 0.3):
    """JAX's single-face loss, batched: boxes (b, n, 4), lms (b, n, 6, 2),
    scores (b, n), gt_box (b, 4), gt_lms (b, 6, 2) -> (per-image totals
    (b,), {score_loss, box_loss, lm_loss} each (b,)). Every anchor at IoU
    >= ``pos_iou`` and the first best-IoU anchor is positive and carries
    box and landmark targets."""
    n = boxes.shape[1]
    iou = pairwise_iou(boxes, gt_box[:, None])[..., 0]  # (b, n)
    best = torch.nn.functional.one_hot(torch.argmax(iou, dim=1), n).bool()
    pos = (iou >= pos_iou) | best
    neg = (iou < neg_iou) & ~pos
    n_pos = torch.clamp(pos.sum(1).to(scores.dtype), min=1.0)
    n_neg = torch.clamp(neg.sum(1).to(scores.dtype), min=1.0)
    p = torch.clamp(scores, 1e-6, 1 - 1e-6)
    score_loss = -((torch.log(p) * pos).sum(1) / n_pos + (torch.log(1 - p) * neg).sum(1) / n_neg)
    box_loss = (smooth_l1(boxes - gt_box[:, None]).sum(-1) * pos).sum(1) / n_pos
    lm_loss = (smooth_l1(lms - gt_lms[:, None]).sum((-1, -2)) * pos).sum(1) / n_pos
    return score_loss + 5.0 * box_loss + 2.0 * lm_loss, {
        "score_loss": score_loss, "box_loss": box_loss, "lm_loss": lm_loss}


class _FocusTrainer(NetTrainer):
    """A focus net: its NHWC input moved to the device and made NCHW."""

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device).permute(0, 3, 1, 2)


class BlazeFaceTrainer(_FocusTrainer):
    """batch: {"image": (b, 128, 128, 3) RGB in [0, 1], "bbox": (b, 4),
    "landmarks": (b, 6, 2)}, both in [0, 1] frame coordinates."""

    def __init__(self, config: FocusConfig = FocusConfig(), seed: int = 0, lr: float = 3e-4,
                 variables: Optional[Mapping] = None, device: str = "cuda"):
        super().__init__(BlazeFaceLite(dtype=getattr(torch, config.compute_dtype)), variables,
                         "face_det", seed, lr, device)

    def loss(self, batch, stats=None):
        boxes, lms, scores = self.net(self._input(batch["image"]), True, stats)
        losses, _ = blazeface_loss(boxes, lms, scores,
                                   torch.as_tensor(batch["bbox"]).to(self.device),
                                   torch.as_tensor(batch["landmarks"]).to(self.device))
        return losses.mean()


class LandmarkRefinerTrainer(_FocusTrainer):
    """Smooth-L1 on crop-normalized landmarks (knee 0.05). batch: {"crop":
    (b, 64, 64, 3) RGB in [0, 1], "landmarks": (b, 6, 2)}."""

    def __init__(self, config: FocusConfig = FocusConfig(), seed: int = 0, lr: float = 1e-3,
                 variables: Optional[Mapping] = None, device: str = "cuda"):
        super().__init__(LandmarkRefiner(dtype=getattr(torch, config.compute_dtype)), variables,
                         "lm_refiner", seed, lr, device)

    def loss(self, batch, stats=None):
        pred = self.net(self._input(batch["crop"]), True, stats)
        d = torch.abs(pred - torch.as_tensor(batch["landmarks"]).to(self.device))
        return torch.where(d < 0.05, 10.0 * d * d, d - 0.0025).mean()


class GazeTrainer(_FocusTrainer):
    """Squared error of (pitch, yaw) on normalized face crops. batch:
    {"crop": (b, S, S, 3) RGB in [0, 1], "pitchyaw": (b, 2)}, numpy or
    tensors already on the device."""

    def __init__(self, config: FocusConfig = FocusConfig(), seed: int = 0, lr: float = 3e-4,
                 variables: Optional[Mapping] = None, device: str = "cuda"):
        super().__init__(GazeNet(dtype=getattr(torch, config.compute_dtype)), variables,
                         "gaze_net", seed, lr, device)

    def loss(self, batch, stats=None):
        pred = self.net(self._input(batch["crop"]), True, stats)
        return ((pred - torch.as_tensor(batch["pitchyaw"]).to(self.device)) ** 2).sum(-1).mean()


# ----------------------------------------------------------------- crops


def make_refiner_crop(frame: np.ndarray, box_px: np.ndarray):
    """(64, 64, 3) RGB/255 float32 crop and (origin, side) for a box, as the
    live detector frames it: a square 1.4 times the box's longer side
    (at least 8 px), resampled bilinearly (cv2's ``warpAffine``)."""
    cx = (box_px[0] + box_px[2]) * 0.5
    cy = (box_px[1] + box_px[3]) * 0.5
    side = max(1.4 * max(box_px[2] - box_px[0], box_px[3] - box_px[1]), 8.0)
    x0, y0 = cx - side / 2.0, cy - side / 2.0
    m = np.asarray([[64.0 / side, 0.0, -x0 * 64.0 / side],
                    [0.0, 64.0 / side, -y0 * 64.0 / side]], np.float32)
    crop = warp_affine_linear_u8(frame, m, 64, 64)
    return (crop[..., ::-1] / 255.0).astype(np.float32), np.asarray([x0, y0], np.float32), side


def make_normalized_crop_fn(config: FocusConfig, intrinsics: Optional[CameraIntrinsics] = None,
                            with_rnorm: bool = False, device: str = "cuda"):
    """A batched ``(frames (B, H, W, 3) uint8, landmarks_px (B, 6, 2)
    float32) -> crops (B, S, S, 3)`` RGB/255 on ``device`` (and the
    normalizing rotations (B, 3, 3) with ``with_rnorm``): the live
    detector's head pose, normalization camera and warp, JAX's per-frame
    crop for each frame. The geometry is one ``focus_geometry`` call a
    batch (on the card, one launch of the hand kernel)."""
    device = torch.device(device)
    k_matrix = torch.from_numpy((intrinsics or CameraIntrinsics()).matrix()).to(device)
    size = config.gaze_image_size
    dist = config.normalized_camera_distance

    def crop_fn(frames, landmarks_px):
        frames = torch.as_tensor(frames).to(device)
        lms = torch.as_tensor(landmarks_px, dtype=torch.float32).to(device).contiguous()
        geo = focus_geometry(lms, k_matrix, assumed_depth=dist, norm_distance=dist,
                             out_size=size)
        crops = warp_image_bilinear(frames.to(torch.float32), geo.warp, size)
        rgb = crops.flip(-1) / 255.0  # BGR -> RGB
        return (rgb, geo.r_norm) if with_rnorm else rgb

    return crop_fn


def gaze_labels(gaze: np.ndarray, r_norm: torch.Tensor) -> torch.Tensor:
    """(B, 2) camera-frame pitch/yaw -> (B, 2) labels in the normalized
    camera: ``vector_to_pitchyaw(r_norm @ pitchyaw_to_vector(gaze))``."""
    v_cam = pitchyaw_to_vector(torch.as_tensor(np.asarray(gaze, np.float32)).to(r_norm.device))
    return vector_to_pitchyaw(mm(r_norm, v_cam[..., None])[..., 0])


# ------------------------------------------------------------- end-to-end


def train_focus_params(
    config: FocusConfig = FocusConfig(),
    n_steps_det: int = 300,
    n_steps_gaze: int = 200,
    n_steps_lm: int = 200,
    batch_size: int = 8,
    frame_hw: Tuple[int, int] = (480, 640),
    seed: int = 0,
    lr_det: float = 3e-4,
    lr_gaze: float = 3e-4,
    lr_lm: float = 1e-3,
    lm_jitter: float = 0.005,
    device: str = "cuda",
) -> Dict:
    """Train BlazeFaceLite, LandmarkRefiner and GazeNet on synthetic faces
    and return ``{"face_det", "lm_refiner", "gaze_net"}``, the tree
    ``FocusDetector(params=...)`` loads. The three phases draw from their
    own samplers (seeds ``seed``, ``seed + 2``, ``seed + 1``)."""
    sampler = SyntheticFaceSampler(frame_hw, seed=seed)
    det_trainer = BlazeFaceTrainer(config, seed=seed, lr=lr_det, device=device)
    gaze_trainer = GazeTrainer(config, seed=seed, lr=lr_gaze, device=device)
    lm_trainer = LandmarkRefinerTrainer(config, seed=seed, lr=lr_lm, device=device)
    crop_fn = make_normalized_crop_fn(config, with_rnorm=True, device=device)

    for _ in range(n_steps_det):
        det_trainer.train_step(face_detector_batch(sampler, batch_size))

    lm_sampler = SyntheticFaceSampler(frame_hw, seed=seed + 2)
    for _ in range(n_steps_lm):
        lm_trainer.train_step(refiner_batch(lm_sampler, batch_size))

    gaze_sampler = SyntheticFaceSampler(frame_hw, seed=seed + 1)
    for _ in range(n_steps_gaze):
        frames, lms, gazes = gaze_batch(gaze_sampler, batch_size, lm_jitter)
        crops, r_norm = crop_fn(frames, lms)
        gaze_trainer.train_step({"crop": crops, "pitchyaw": gaze_labels(gazes, r_norm)})

    return {"face_det": det_trainer.variables, "lm_refiner": lm_trainer.variables,
            "gaze_net": gaze_trainer.variables}


def face_detector_batch(sampler: SyntheticFaceSampler, batch_size: int) -> Dict:
    """One BlazeFace batch: the scenes resized to 128x128 (cv2's
    ``INTER_LINEAR`` on uint8) as RGB in [0, 1]."""
    imgs, bxs, lmss = [], [], []
    for _ in range(batch_size):
        frame, gt, _ = sampler.sample()
        imgs.append(resize_linear_u8(frame, 128, 128)[..., ::-1] / 255.0)
        bxs.append(gt["bbox"])
        lmss.append(gt["landmarks"])
    return {"image": np.asarray(imgs, np.float32), "bbox": np.stack(bxs),
            "landmarks": np.stack(lmss)}


def refiner_batch(sampler: SyntheticFaceSampler, batch_size: int) -> Dict:
    """One refiner batch: each scene's crop from its GT box jittered by 12%
    of its size (the live detector's box noise), and the landmarks in the
    crop's [0, 1] coordinates."""
    h, w = sampler.frame_hw
    crops, targets = [], []
    for _ in range(batch_size):
        frame, gt, _ = sampler.sample()
        box_px = gt["bbox"] * np.asarray([w, h, w, h], np.float32)
        bw, bh = box_px[2] - box_px[0], box_px[3] - box_px[1]
        jit = sampler.rng.normal(0, 0.12, 4) * np.asarray([bw, bh, bw, bh])
        crop, origin, side = make_refiner_crop(frame, box_px + jit)
        gt_px = gt["landmarks"] * np.asarray([w, h], np.float32)
        targets.append((gt_px - origin) / side)
        crops.append(crop)
    return {"crop": np.stack(crops), "landmarks": np.stack(targets, dtype=np.float32)}


def gaze_batch(sampler: SyntheticFaceSampler, batch_size: int, lm_jitter: float):
    """One gaze batch's draws, in JAX's order (scene, then its landmark
    jitter): (frames (B, H, W, 3) uint8, jittered pixel landmarks (B, 6, 2)
    float32, camera-frame gaze (B, 2)). Only close faces (area >= 0.04),
    the regime the gaze net serves."""
    h, w = sampler.frame_hw
    scale = np.asarray([w, h], np.float32)
    frames, lms, gazes = [], [], []
    for _ in range(batch_size):
        frame, gt, gaze = sampler.sample(min_area=0.04)
        jittered = gt["landmarks"] + sampler.rng.normal(0, lm_jitter, (6, 2))
        frames.append(frame)
        lms.append((jittered * scale).astype(np.float32))
        gazes.append(gaze)
    return np.stack(frames), np.stack(lms), np.asarray(gazes, np.float32)


# CI operating point of the trained focus fixture (``focus-ci``)
CI_FOCUS_CFG = dataclasses.replace(FocusConfig(), gaze_image_size=64, compute_dtype="float32")
CI_FOCUS_BUDGETS = dict(n_steps_det=150, n_steps_gaze=150, n_steps_lm=600,
                        batch_size=6, lr_det=1e-3, lr_gaze=5e-4)


def focus_config_key_repr(config: FocusConfig) -> str:
    """The repr of the JAX package's ``FocusConfig`` with ``config``'s
    values: the port's config has JAX's fields in JAX's order, so this is
    its own repr, and the cache key is the JAX package's string."""
    return repr(config)


_CI_FOCUS_KEY_V = ("1", lambda: (f"gazefocus:{focus_config_key_repr(CI_FOCUS_CFG)}:"
                                 f"{sorted(CI_FOCUS_BUDGETS.items())!r}"))


def ci_focus_params(device: str = "cuda"):
    """The CI-budget focus stack (``focus-ci``), from the bundle or the
    cache; trains on ``device`` on a miss."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    return cached_params(_CI_FOCUS_KEY_V[1](),
                         lambda: train_focus_params(CI_FOCUS_CFG, device=device,
                                                    **CI_FOCUS_BUDGETS),
                         version=_CI_FOCUS_KEY_V[0])
