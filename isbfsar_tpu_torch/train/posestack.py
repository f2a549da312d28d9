"""The synthetic humanoid and the pose-stack trainers (port of
``isbfsar_tpu/train/posestack.py``).

An articulated 32-joint humanoid with EXACT projective ground truth:
:func:`humanoid_pose` and its parametric motions, :func:`place_in_camera`,
:func:`render_humanoid_scene` (camera-space 3D joints, their 2D
projections and the pixel bbox of the rendered body),
:func:`random_humanoid_pose`, :class:`SyntheticHumanSampler` and
:func:`render_motion_clip`. Plain numpy: it draws with
``utils/draw.py``, cv2's primitives in numpy, pixel for pixel, so frames
render where cv2 is missing. Every function consumes its
``np.random.Generator`` in exactly the JAX package's order, so a seed gives
the same frames and ground truth in both packages.

The trainers, on ``device`` (the card by default; float32 with TF32 off,
as JAX computes): :class:`YoloTrainer` (the person loss
:func:`yolo_person_loss` on the decoded anchors), :class:`HeatmapTrainer`
(EfficientNetV2 and the MetrABS head through the live crop chain, batched
through the port's ``virtual_camera``, ``warp_matrix`` and ``warp_image``),
:func:`train_pose_params`, the detector calibration
:func:`finetune_detector`, :func:`evaluate_pose_stack` (the port
estimator's module path on fresh scenes), and the trained fixtures with
the JAX package's cache keys (``utils/cache.py::cached_params``). Both
trainers take JAX's optimizer (``train/optim.py``) and train their
BatchNorms with batch statistics. Frames are resized on the host with
``ops/image.py::resize_area_u8``, cv2's ``INTER_AREA`` on uint8 pixel for
pixel. A trainer's :attr:`variables` are Flax trees of CPU tensors, which
``HumanPoseEstimator(params=...)`` of either package loads.

3D unit convention (as in JAX): ``pred3d = (X_crop - centroid) / 2.5 +
0.5`` in the 2.5 m heatmap box, so the reconstruction gives metres.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isbfsar_tpu_torch.configs import CameraIntrinsics
from isbfsar_tpu_torch.models.effnetv2 import V2_L, V2_TINY, EfficientNetV2, MetrabsHead
from isbfsar_tpu_torch.models.layers import float32_device, init_random, update_running_stats
from isbfsar_tpu_torch.models.yolov4 import YOLOv4
from isbfsar_tpu_torch.ops.geometry import mm, project, virtual_camera, warp_matrix
from isbfsar_tpu_torch.ops.image import resize_area_u8
from isbfsar_tpu_torch.ops.softargmax import decode_heatmap2d, decode_heatmap3d, split_head_logits
from isbfsar_tpu_torch.ops.warp import warp_image
from isbfsar_tpu_torch.train.optim import ClipAdam
from isbfsar_tpu_torch.utils import draw
from isbfsar_tpu_torch.weights import _flatten, convert_variables, to_flax_variables

# 3D heatmap box size in metres (see the module docstring)
BOX_SIZE_M = 2.5

# ------------------------------------------------------------ humanoid model
#
# 32 joints in SMPL order (0-23) + 8 head/face joints — the raw-joint count
# of the MetrabsHead contract (288 = 32 x 9 channels). Body-local frame:
# x right, y DOWN (camera convention), z away from camera; origin at pelvis;
# the subject faces the camera (nose at negative z).

JOINT_NAMES = (
    "pelvis", "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2",
    "l_ankle", "r_ankle", "spine3", "l_foot", "r_foot", "neck", "l_collar",
    "r_collar", "head", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow",
    "l_wrist", "r_wrist", "l_hand", "r_hand",
    "nose", "l_eye", "r_eye", "l_ear", "r_ear", "head_top", "jaw", "chest",
)

_J = {n: i for i, n in enumerate(JOINT_NAMES)}

# Rendered limb segments (index pairs) with their capsule radii in meters.
HUMANOID_EDGES: Tuple[Tuple[int, int, float], ...] = (
    (_J["pelvis"], _J["spine1"], 0.07), (_J["spine1"], _J["spine2"], 0.07),
    (_J["spine2"], _J["spine3"], 0.07), (_J["spine3"], _J["neck"], 0.06),
    (_J["neck"], _J["head"], 0.04),
    (_J["pelvis"], _J["l_hip"], 0.06), (_J["pelvis"], _J["r_hip"], 0.06),
    (_J["l_hip"], _J["l_knee"], 0.055), (_J["r_hip"], _J["r_knee"], 0.055),
    (_J["l_knee"], _J["l_ankle"], 0.045), (_J["r_knee"], _J["r_ankle"], 0.045),
    (_J["l_ankle"], _J["l_foot"], 0.035), (_J["r_ankle"], _J["r_foot"], 0.035),
    (_J["neck"], _J["l_collar"], 0.04), (_J["neck"], _J["r_collar"], 0.04),
    (_J["l_collar"], _J["l_shoulder"], 0.045), (_J["r_collar"], _J["r_shoulder"], 0.045),
    (_J["l_shoulder"], _J["l_elbow"], 0.04), (_J["r_shoulder"], _J["r_elbow"], 0.04),
    (_J["l_elbow"], _J["l_wrist"], 0.035), (_J["r_elbow"], _J["r_wrist"], 0.035),
    (_J["l_wrist"], _J["l_hand"], 0.03), (_J["r_wrist"], _J["r_hand"], 0.03),
)

MOTIONS = ("idle", "wave", "squat", "walk")

# Action-class library for the offline AR workflow (tools/synth_workflow.py):
# extra parametric motions that are NOT in MOTIONS, so the detection/pose
# trainers' scene distribution — and the cached trained fixtures keyed on it
# — stay byte-stable, and the pose nets must GENERALIZE to these held-out
# motions exactly as they would to real unseen actions. Split mirrors the
# reference protocol (train TRX on one class set, FSOS-eval on a disjoint
# one — reference modules/ar/utils/test/compute_fsos.py:40-79).
ACTION_TRAIN_CLASSES = (
    "wave", "squat", "walk", "raise_both", "clap", "kick_r", "bow", "lean",
)
ACTION_TEST_CLASSES = (
    "march", "punch_l", "jumping_jack", "twist", "touch_head", "shrug",
    "sway",
)
# Extended train-side classes for production-scale runs
# (tools/synth_workflow.py --production trains on TRAIN + EXTRA = 16
# classes). More class diversity is the discriminator's training signal —
# the reference trains its open-set head against 100 NTU classes
# (modules/ar/utils/train.py); 8 synthetic classes under-feed it. Several
# extras are deliberate HARD negatives for the held-out set (turn vs twist,
# punch_r vs punch_l, drink vs touch_head): mirror/near-miss classes that
# force the embedding to encode laterality and joint-group identity rather
# than gross motion energy. CI keeps the 8-class default (suite cost).
# NOTE: these classes are NOT in the pose-training scene library
# (_POSE_SCENE_ACTIONS below stays frozen), so the pose nets meet them as
# genuinely unseen articulations — and the cached fixtures stay valid.
ACTION_EXTRA_CLASSES = (
    "jump", "kick_l", "wave_l", "reach_fwd", "turn", "lunge", "drink",
    "punch_r",
)

# joints that ride the torso for trunk motions (bow/twist/lean)
_UPPER = (
    "spine1", "spine2", "spine3", "chest", "neck", "l_collar", "r_collar",
    "head", "head_top", "nose", "jaw", "l_eye", "r_eye", "l_ear", "r_ear",
    "l_shoulder", "r_shoulder", "l_elbow", "r_elbow", "l_wrist", "r_wrist",
    "l_hand", "r_hand",
)


def _arm_chain(j: np.ndarray, side: str, ang: float, plane: str = "frontal") -> None:
    """Pose one arm as a straight chain at ``ang`` rad from straight-down.

    ``frontal`` rotates in the body x-y plane (lateral raise), ``sagittal``
    in y-z (forward raise). Overwrites elbow/wrist/hand from the shoulder.
    """
    sign = 1.0 if side == "l" else -1.0
    sh = j[_J[f"{side}_shoulder"]]
    if plane == "frontal":
        d = np.asarray([sign * np.sin(ang), np.cos(ang), 0.0], np.float32)
    else:
        d = np.asarray([0.0, np.cos(ang), -np.sin(ang)], np.float32)
    j[_J[f"{side}_elbow"]] = sh + 0.27 * d
    j[_J[f"{side}_wrist"]] = sh + 0.53 * d
    j[_J[f"{side}_hand"]] = sh + 0.62 * d


def humanoid_pose(t: float, motion: str = "idle", phase: float = 0.0) -> np.ndarray:
    """(32, 3) body-local joint positions at cycle position ``t`` in [0, 1).

    Deterministic parametric motion — the ground truth IS the parameter
    evaluation, no rendering approximation. Motions are chosen to produce
    visibly distinct relative-pose dynamics (the AR demo's class signal):
    ``wave`` moves one arm chain, ``squat`` moves the pelvis/knees
    vertically, ``walk`` counter-swings legs and arms in z.

    Beyond the four pose-training motions, the AR action library
    (ACTION_TRAIN_CLASSES / ACTION_EXTRA_CLASSES / ACTION_TEST_CLASSES)
    adds twenty more classes, each exercising a distinct joint group x axis
    combination so the root-relative 30-joint trajectory — the TRX input
    signal — separates them (tools/synth_workflow.py is the consumer).
    """
    assert motion in MOTIONS or motion in _ACTIONS, motion
    s = np.sin(2 * np.pi * t + phase)
    j = np.zeros((32, 3), np.float32)

    def put(name, x, y, z):
        j[_J[name]] = (x, y, z)

    put("pelvis", 0, 0, 0)
    put("l_hip", 0.09, 0.02, 0); put("r_hip", -0.09, 0.02, 0)
    put("spine1", 0, -0.12, 0); put("spine2", 0, -0.24, 0)
    put("spine3", 0, -0.34, 0); put("chest", 0, -0.38, -0.02)
    put("neck", 0, -0.46, 0)
    put("l_collar", 0.06, -0.42, 0); put("r_collar", -0.06, -0.42, 0)
    put("head", 0, -0.58, 0); put("head_top", 0, -0.72, 0)
    put("nose", 0, -0.64, -0.09); put("jaw", 0, -0.56, -0.06)
    put("l_eye", 0.04, -0.66, -0.07); put("r_eye", -0.04, -0.66, -0.07)
    put("l_ear", 0.08, -0.62, 0); put("r_ear", -0.08, -0.62, 0)
    put("l_shoulder", 0.20, -0.42, 0); put("r_shoulder", -0.20, -0.42, 0)
    # arms hanging by default
    put("l_elbow", 0.24, -0.15, 0); put("r_elbow", -0.24, -0.15, 0)
    put("l_wrist", 0.26, 0.09, 0); put("r_wrist", -0.26, 0.09, 0)
    put("l_hand", 0.27, 0.17, 0); put("r_hand", -0.27, 0.17, 0)
    # legs straight by default
    put("l_knee", 0.10, 0.42, 0); put("r_knee", -0.10, 0.42, 0)
    put("l_ankle", 0.10, 0.82, 0); put("r_ankle", -0.10, 0.82, 0)
    put("l_foot", 0.10, 0.88, -0.10); put("r_foot", -0.10, 0.88, -0.10)

    if motion == "wave":
        # right arm raised, forearm oscillating about the elbow
        sh = j[_J["r_shoulder"]]
        j[_J["r_elbow"]] = sh + (-0.26, -0.06, 0)
        ang = 0.9 + 0.5 * s  # rad from vertical
        fore = 0.26 * np.asarray([-np.sin(ang), -np.cos(ang), 0.0])
        j[_J["r_wrist"]] = j[_J["r_elbow"]] + fore
        j[_J["r_hand"]] = j[_J["r_elbow"]] + fore * 1.3
    elif motion == "squat":
        drop = 0.14 * (1 + s)  # 0 .. 0.28 m vertical drop
        upper = [i for i in range(32) if i not in
                 (_J["l_knee"], _J["r_knee"], _J["l_ankle"], _J["r_ankle"],
                  _J["l_foot"], _J["r_foot"])]
        j[upper, 1] += drop
        for knee in ("l_knee", "r_knee"):
            j[_J[knee], 1] += 0.4 * drop
            j[_J[knee], 2] -= 0.6 * drop  # knees come forward (toward camera)
    elif motion == "walk":
        swing = 0.22 * s
        for side, sign in (("l", 1.0), ("r", -1.0)):
            j[_J[f"{side}_knee"], 2] += 0.5 * sign * swing
            for p in ("ankle", "foot"):
                j[_J[f"{side}_{p}"], 2] += sign * swing
            # arms counter-swing
            for p in ("elbow",):
                j[_J[f"{side}_{p}"], 2] += -0.4 * sign * swing
            for p in ("wrist", "hand"):
                j[_J[f"{side}_{p}"], 2] += -0.8 * sign * swing
    elif motion == "idle":
        j[:, 0] += 0.01 * s  # breathing sway
    elif motion in _ACTIONS:
        _ACTIONS[motion](j, s, t, phase)

    return j


# ------------------------------------------------------- action-class motions
#
# Each mutates the default skeleton like the branches above. The primary
# oscillator ``s`` is sin(2*pi*t + phase); fast motions derive their own
# double-frequency oscillator from (t, phase).


def _act_raise_both(j, s, t, phase):
    # both full arms sweep down<->overhead in the frontal plane
    ang = 1.2 + 0.9 * s
    _arm_chain(j, "l", ang)
    _arm_chain(j, "r", ang)


def _act_clap(j, s, t, phase):
    # hands oscillate laterally toward the chest midline, forward of torso
    spread = 0.05 + 0.11 * (1 + s)
    for side, sign in (("l", 1.0), ("r", -1.0)):
        j[_J[f"{side}_elbow"]] = (sign * 0.24, -0.26, -0.10)
        j[_J[f"{side}_wrist"]] = (sign * spread, -0.31, -0.20)
        j[_J[f"{side}_hand"]] = (sign * spread * 0.5, -0.32, -0.23)


def _act_kick_r(j, s, t, phase):
    # right leg swings forward/up; left leg and arms stay planted
    lift = 0.5 * (1 + s)
    j[_J["r_knee"]] += (0, -0.22 * lift, -0.28 * lift)
    for p in ("r_ankle", "r_foot"):
        j[_J[p]] += (0, -0.38 * lift, -0.52 * lift)


def _act_bow(j, s, t, phase):
    # torso pitches forward about the pelvis x-axis
    th = 0.35 * (1 + s)
    u = [_J[n] for n in _UPPER]
    y = j[u, 1].copy()
    j[u, 2] += y * np.sin(th)  # y is negative above the pelvis -> z forward
    j[u, 1] = y * np.cos(th)


def _act_lean(j, s, t, phase):
    # lateral trunk bend: upper joints shear sideways with height
    u = [_J[n] for n in _UPPER]
    j[u, 0] += (-j[u, 1]) * 0.45 * s


def _act_march(j, s, t, phase):
    # knees alternately raise vertically (no arm swing — distinct from walk)
    for side, osc in (("l", s), ("r", -s)):
        lift = max(osc, 0.0)
        j[_J[f"{side}_knee"]] += (0, -0.45 * lift, -0.24 * lift)
        for p in ("ankle", "foot"):
            j[_J[f"{side}_{p}"]] += (0, -0.40 * lift, 0.06 * lift)


def _act_punch_l(j, s, t, phase):
    # left fist thrusts far forward in z with a shoulder turn; the right
    # stays in a static guard (distinct mean posture AND dynamics)
    ext = 0.5 * (1 + s)
    j[_J["l_shoulder"], 2] -= 0.10 * ext
    j[_J["r_shoulder"], 2] += 0.10 * ext
    j[_J["l_elbow"]] = (0.14, -0.32, -0.26 * ext)
    j[_J["l_wrist"]] = (0.06, -0.34, -0.18 - 0.45 * ext)
    j[_J["l_hand"]] = (0.04, -0.34, -0.24 - 0.50 * ext)
    j[_J["r_elbow"]] = (-0.22, -0.28, -0.08)
    j[_J["r_wrist"]] = (-0.12, -0.34, -0.16)
    j[_J["r_hand"]] = (-0.10, -0.35, -0.18)


def _act_jumping_jack(j, s, t, phase):
    # arms AND legs abduct laterally together
    ab = 0.5 * (1 + s)
    ang = 0.3 + 2.2 * ab
    _arm_chain(j, "l", ang)
    _arm_chain(j, "r", ang)
    for side, sign in (("l", 1.0), ("r", -1.0)):
        j[_J[f"{side}_knee"], 0] += sign * 0.15 * ab
        for p in ("ankle", "foot"):
            j[_J[f"{side}_{p}"], 0] += sign * 0.30 * ab


def _act_twist(j, s, t, phase):
    # torso yaw oscillation about the vertical axis
    th = 1.0 * s
    u = [_J[n] for n in _UPPER]
    x, z = j[u, 0].copy(), j[u, 2].copy()
    j[u, 0] = x * np.cos(th) - z * np.sin(th)
    j[u, 2] = x * np.sin(th) + z * np.cos(th)


def _act_touch_head(j, s, t, phase):
    # both hands rise from hanging to the ears, elbows flaring out
    r = 0.5 * (1 + s)
    for side, sign in (("l", 1.0), ("r", -1.0)):
        base_e = np.asarray(j[_J[f"{side}_elbow"]])
        base_w = np.asarray(j[_J[f"{side}_wrist"]])
        j[_J[f"{side}_elbow"]] = base_e * (1 - r) + r * np.asarray(
            [sign * 0.30, -0.46, -0.05])
        j[_J[f"{side}_wrist"]] = base_w * (1 - r) + r * np.asarray(
            [sign * 0.11, -0.60, -0.03])
        j[_J[f"{side}_hand"]] = j[_J[f"{side}_wrist"]] + (0, -0.05, 0)


def _act_shrug(j, s, t, phase):
    # shoulder girdle + bent-out arms bob vertically (amplitude sized above
    # the trained pose net's per-frame noise floor; the bent-elbow posture
    # separates the MEAN signature from idle/march arms)
    lift = 0.16 * (1 + s)
    for side, sign in (("l", 1.0), ("r", -1.0)):
        j[_J[f"{side}_elbow"]] = (sign * 0.34, -0.22, 0.0)
        j[_J[f"{side}_wrist"]] = (sign * 0.30, -0.05, -0.10)
        j[_J[f"{side}_hand"]] = (sign * 0.29, 0.02, -0.12)
    for n in ("l_collar", "r_collar", "l_shoulder", "r_shoulder",
              "l_elbow", "r_elbow", "l_wrist", "r_wrist", "l_hand", "r_hand"):
        j[_J[n], 1] -= lift


def _act_sway(j, s, t, phase):
    # whole upper body circles laterally while feet stay planted: x AND z
    # of the trunk move in quadrature (distinct from lean's pure x shear)
    c = np.cos(2 * np.pi * t + phase)
    u = [_J[n] for n in _UPPER]
    j[u, 0] += (-j[u, 1]) * 0.50 * s
    j[u, 2] += (-j[u, 1]) * 0.38 * c


def _act_jump(j, s, t, phase):
    # the WHOLE body (feet included) oscillates vertically — the only class
    # whose global y translates everything; arms counter-swing for signal
    h = 0.18 * max(s, 0.0)          # airborne half-cycle only
    j[:, 1] -= h
    ang = 0.25 + 0.5 * max(s, 0.0)  # arms flare out on the way up
    _arm_chain(j, "l", ang)
    _arm_chain(j, "r", ang)


def _act_kick_l(j, s, t, phase):
    # mirror of kick_r: LEFT leg swings forward/up (laterality signal)
    lift = 0.5 * (1 + s)
    j[_J["l_knee"]] += (0, -0.22 * lift, -0.28 * lift)
    for p in ("l_ankle", "l_foot"):
        j[_J[p]] += (0, -0.38 * lift, -0.52 * lift)


def _act_wave_l(j, s, t, phase):
    # mirror of the MOTIONS 'wave': left arm raised, forearm oscillating
    sh = j[_J["l_shoulder"]]
    j[_J["l_elbow"]] = sh + (0.26, -0.06, 0)
    ang = 0.9 + 0.5 * s
    fore = 0.26 * np.asarray([np.sin(ang), -np.cos(ang), 0.0])
    j[_J["l_wrist"]] = j[_J["l_elbow"]] + fore
    j[_J["l_hand"]] = j[_J["l_elbow"]] + fore * 1.3


def _act_reach_fwd(j, s, t, phase):
    # both arms sweep hanging<->horizontal in the SAGITTAL plane
    # (raise_both is the frontal-plane counterpart)
    ang = 0.8 + 0.7 * s
    _arm_chain(j, "l", ang, plane="sagittal")
    _arm_chain(j, "r", ang, plane="sagittal")


def _act_turn(j, s, t, phase):
    # WHOLE-body yaw about the vertical axis, hips and legs included —
    # the held-out 'twist' rotates the upper body only
    th = 0.9 * s
    x, z = j[:, 0].copy(), j[:, 2].copy()
    j[:, 0] = x * np.cos(th) - z * np.sin(th)
    j[:, 2] = x * np.sin(th) + z * np.cos(th)


def _act_lunge(j, s, t, phase):
    # right leg strides forward while the pelvis and torso drop and shift
    # forward; left leg trails — asymmetric lower-body y+z (squat is
    # symmetric pure-y, kicks lift a leg without the weight drop)
    d = 0.5 * (1 + s)
    j[_J["r_knee"]] += (0, 0.02 * d, -0.30 * d)
    for p in ("r_ankle", "r_foot"):
        j[_J[p]] += (0, 0.0, -0.38 * d)
    upper = [i for i in range(32) if i not in
             (_J["l_knee"], _J["r_knee"], _J["l_ankle"], _J["r_ankle"],
              _J["l_foot"], _J["r_foot"])]
    j[upper, 1] += 0.14 * d
    j[upper, 2] -= 0.12 * d


def _act_drink(j, s, t, phase):
    # ONE hand rises from hanging to the jaw (touch_head raises both to the
    # ears); elbow stays low and forward — single-sided arm flexion
    r = 0.5 * (1 + s)
    base_e = np.asarray(j[_J["r_elbow"]])
    base_w = np.asarray(j[_J["r_wrist"]])
    j[_J["r_elbow"]] = base_e * (1 - r) + r * np.asarray([-0.20, -0.24, -0.12])
    j[_J["r_wrist"]] = base_w * (1 - r) + r * np.asarray([-0.06, -0.50, -0.10])
    j[_J["r_hand"]] = j[_J["r_wrist"]] + (0.02, -0.05, -0.02)


def _act_punch_r(j, s, t, phase):
    # mirror of the held-out punch_l: right fist thrusts forward with a
    # shoulder turn, left in static guard
    ext = 0.5 * (1 + s)
    j[_J["r_shoulder"], 2] -= 0.10 * ext
    j[_J["l_shoulder"], 2] += 0.10 * ext
    j[_J["r_elbow"]] = (-0.14, -0.32, -0.26 * ext)
    j[_J["r_wrist"]] = (-0.06, -0.34, -0.18 - 0.45 * ext)
    j[_J["r_hand"]] = (-0.04, -0.34, -0.24 - 0.50 * ext)
    j[_J["l_elbow"]] = (0.22, -0.28, -0.08)
    j[_J["l_wrist"]] = (0.12, -0.34, -0.16)
    j[_J["l_hand"]] = (0.10, -0.35, -0.18)


_ACTIONS = {
    "raise_both": _act_raise_both,
    "clap": _act_clap,
    "kick_r": _act_kick_r,
    "bow": _act_bow,
    "lean": _act_lean,
    "march": _act_march,
    "punch_l": _act_punch_l,
    "jumping_jack": _act_jumping_jack,
    "twist": _act_twist,
    "touch_head": _act_touch_head,
    "shrug": _act_shrug,
    "sway": _act_sway,
    "jump": _act_jump,
    "kick_l": _act_kick_l,
    "wave_l": _act_wave_l,
    "reach_fwd": _act_reach_fwd,
    "turn": _act_turn,
    "lunge": _act_lunge,
    "drink": _act_drink,
    "punch_r": _act_punch_r,
}
assert set(ACTION_TRAIN_CLASSES + ACTION_EXTRA_CLASSES + ACTION_TEST_CLASSES
           ) - set(MOTIONS) == set(_ACTIONS)

# The pose-training scene library is FROZEN at the original 12-action set:
# the diverse-mode samplers (random_humanoid_pose / SyntheticHumanSampler)
# draw from MOTIONS + this tuple ONLY, so the cached trained fixtures and
# receipts — keyed on budgets, not the library — stay byte-stable, and any
# class added later (ACTION_EXTRA_CLASSES) is held out from pose training
# exactly like a real unseen action would be.
_POSE_SCENE_ACTIONS = (
    "raise_both", "clap", "kick_r", "bow", "lean", "march", "punch_l",
    "jumping_jack", "twist", "touch_head", "shrug", "sway",
)
assert set(_POSE_SCENE_ACTIONS) <= set(_ACTIONS)


# per-joint drawn radius (meters) for the exact bbox of the rendering
_JOINT_RADIUS = np.full(32, 0.05, np.float32)
for _a, _b, _r in HUMANOID_EDGES:
    _JOINT_RADIUS[_a] = max(_JOINT_RADIUS[_a], _r)
    _JOINT_RADIUS[_b] = max(_JOINT_RADIUS[_b], _r)
_HEAD_R = 0.11
for _n in ("head", "head_top", "nose", "jaw", "l_eye", "r_eye", "l_ear", "r_ear"):
    _JOINT_RADIUS[_J[_n]] = _HEAD_R

def place_in_camera(local: np.ndarray, center: Sequence[float], yaw: float = 0.0) -> np.ndarray:
    """Rotate the body about the vertical (y) axis by ``yaw`` and translate
    its pelvis to camera-space ``center`` (meters)."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot_y = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return local @ rot_y.T + np.asarray(center, np.float32)


def render_humanoid_scene(
    joints_cam: np.ndarray,
    intrinsics: CameraIntrinsics,
    frame_hw: Tuple[int, int] = (240, 320),
    rng: Optional[np.random.Generator] = None,
    n_distractors: int = 3,
    person: bool = True,
    humanlike_clutter: int = 0,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Render the humanoid and return EXACT ground truth.

    joints_cam: (32, 3) camera-space joints (meters). Returns
    (frame uint8 BGR, {"bbox": (4,) x1y1x2y2 pixels, "joints2d": (32, 2)
    pixels, "joints3d": (32, 3) camera-space}). The bbox is the projected
    silhouette extent: every joint's projection expanded by its drawn
    capsule radius (exact for this renderer).

    ``humanlike_clutter``: extra DISARTICULATED body-part-like shapes —
    limb-colored bent capsule strokes and a head-like disc with eye dots,
    drawn with the same primitives/color ranges/stroke widths the person
    is, but with no coherent articulation. These are the hard negatives
    the detector-calibration fine-tune trains on (finetune_detector): the
    round-4 gate sweep showed empty scenes score a median 0.885 person
    confidence because ordinary rectangles/circles are too easy — only
    clutter that locally mimics limbs forces the score head to learn
    global body structure. Default 0 keeps every pre-existing rng stream
    (and therefore every cached trained fixture) byte-identical.
    """
    rng = rng or np.random.default_rng(0)
    h, w = frame_hw
    k = intrinsics.matrix()
    f = float(k[0, 0])

    # cluttered background: noise + gradient + distractor shapes
    frame = rng.integers(20, 90, (h, w, 3)).astype(np.uint8)
    grad = np.linspace(0, rng.integers(20, 70), w, dtype=np.int32)
    frame = np.clip(frame.astype(np.int32) + grad[None, :, None], 0, 255).astype(np.uint8)
    for _ in range(n_distractors):
        color = tuple(int(v) for v in rng.integers(40, 220, 3))
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        if rng.random() < 0.5:
            draw.rectangle(frame, (x0, y0),
                           (x0 + int(rng.integers(8, w // 4)), y0 + int(rng.integers(8, h // 4))),
                           color)
        else:
            draw.circle(frame, (x0, y0), int(rng.integers(4, h // 6)), color)

    for _ in range(humanlike_clutter):
        # a fake depth picks limb-plausible stroke widths/lengths: the same
        # r*f/z law the person's edges use (HUMANOID_EDGES radii 0.04-0.09)
        z = float(rng.uniform(1.8, 3.6))
        if rng.random() < 0.75:  # bent two-segment "limb"
            color = tuple(int(v) for v in rng.integers(60, 255, 3))
            t = max(1, int(rng.uniform(0.04, 0.09) * f / z))
            p0 = np.asarray([rng.integers(0, w), rng.integers(0, h)], np.float32)
            ang = rng.uniform(0, 2 * np.pi)
            seg = rng.uniform(0.25, 0.45) * f / z  # upper/lower-limb lengths
            p1 = p0 + seg * np.asarray([np.cos(ang), np.sin(ang)])
            ang2 = ang + rng.uniform(-1.2, 1.2)
            p2 = p1 + seg * rng.uniform(0.7, 1.0) * np.asarray(
                [np.cos(ang2), np.sin(ang2)])
            for a, b in ((p0, p1), (p1, p2)):
                draw.line(frame, tuple(a.astype(int)), tuple(b.astype(int)),
                          color, 2 * t)
        else:  # head-like disc with eye dots
            skin = tuple(int(v) for v in rng.integers(120, 230, 3))
            c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            r = max(2, int(_HEAD_R * f / z))
            draw.circle(frame, c, r, skin)
            for dx in (-r // 3, r // 3):
                draw.circle(frame, (c[0] + dx, c[1] - r // 6),
                            max(1, r // 5), (30, 30, 30))

    proj = joints_cam @ k.T
    j2d = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)  # (32, 2) pixels

    if not person:
        return frame, {
            "bbox": np.zeros(4, np.float32),
            "joints2d": j2d,
            "joints3d": joints_cam.astype(np.float32),
        }

    # per-sample "clothing": top / bottom / skin colors
    top = tuple(int(v) for v in rng.integers(60, 255, 3))
    bottom = tuple(int(v) for v in rng.integers(60, 255, 3))
    skin = tuple(int(v) for v in rng.integers(120, 230, 3))

    z = joints_cam[:, 2]
    px_r = _JOINT_RADIUS * f / np.maximum(z, 0.2)  # drawn radius per joint, px

    def color_for(a, b):
        upper = {_J[n] for n in ("pelvis", "spine1", "spine2", "spine3", "neck",
                                 "chest", "l_collar", "r_collar", "l_shoulder",
                                 "r_shoulder", "l_elbow", "r_elbow")}
        lower = {_J[n] for n in ("l_hip", "r_hip", "l_knee", "r_knee",
                                 "l_ankle", "r_ankle", "l_foot", "r_foot")}
        if a in lower or b in lower:
            return bottom
        if a in upper and b in upper:
            return top
        return skin

    # torso quad first (shoulders + hips), then limbs far-to-near
    torso = np.asarray([j2d[_J["l_shoulder"]], j2d[_J["r_shoulder"]],
                        j2d[_J["r_hip"]], j2d[_J["l_hip"]]], np.int32)
    draw.fill_convex_poly(frame, torso, top)
    order = np.argsort([-0.5 * (z[a] + z[b]) for a, b, _ in HUMANOID_EDGES])
    for idx in order:
        a, b, r = HUMANOID_EDGES[idx]
        t = max(1, int(r * f / max(0.5 * (z[a] + z[b]), 0.2)))
        draw.line(frame, tuple(j2d[a].astype(int)), tuple(j2d[b].astype(int)),
                  color_for(a, b), 2 * t)
    head_px = int(_HEAD_R * f / max(z[_J["head"]], 0.2))
    draw.circle(frame, tuple(j2d[_J["head"]].astype(int)), head_px, skin)
    for eye in ("l_eye", "r_eye"):
        draw.circle(frame, tuple(j2d[_J[eye]].astype(int)),
                    max(1, head_px // 5), (30, 30, 30))

    lo = (j2d - px_r[:, None]).min(axis=0)
    hi = (j2d + px_r[:, None]).max(axis=0)
    bbox = np.asarray([lo[0], lo[1], hi[0], hi[1]], np.float32)
    return frame, {
        "bbox": bbox,
        "joints2d": j2d,
        "joints3d": joints_cam.astype(np.float32),
    }


def random_humanoid_pose(rng: np.random.Generator) -> np.ndarray:
    """A random articulated configuration spanning the WHOLE pose space.

    The four MOTIONS cover a thin slice of arm/torso/leg configurations; a
    pose net trained only on them collapses unseen limb placements toward
    that slice (measured: action classes with raised/forward arms extracted
    with ~0 amplitude). This generator is the synthetic analog of training
    metrabs on broad mocap diversity: random per-limb chain angles, torso
    pitch/yaw/lean, and leg raises, layered on a random library motion
    frame so the in-distribution poses stay covered too.
    """
    base = list(MOTIONS) + list(_POSE_SCENE_ACTIONS)
    j = humanoid_pose(float(rng.random()), base[rng.integers(len(base))],
                      phase=float(rng.uniform(0, 2 * np.pi)))
    for side in "lr":
        if rng.random() < 0.7:
            _arm_chain(j, side, float(rng.uniform(0.0, np.pi)),
                       "frontal" if rng.random() < 0.5 else "sagittal")
            if rng.random() < 0.5:  # random elbow bend
                el, wr = j[_J[f"{side}_elbow"]], j[_J[f"{side}_wrist"]]
                bend = rng.uniform(-0.18, 0.18, 3).astype(np.float32)
                j[_J[f"{side}_wrist"]] = el + (wr - el) * 0.7 + bend
                j[_J[f"{side}_hand"]] = j[_J[f"{side}_wrist"]] + (wr - el) * 0.3
    u = [_J[n] for n in _UPPER]
    if rng.random() < 0.5:  # pitch
        th = float(rng.uniform(-0.25, 0.7))
        y = j[u, 1].copy()
        j[u, 2] += y * np.sin(th)
        j[u, 1] = y * np.cos(th)
    if rng.random() < 0.5:  # yaw
        th = float(rng.uniform(-1.0, 1.0))
        x, z = j[u, 0].copy(), j[u, 2].copy()
        j[u, 0] = x * np.cos(th) - z * np.sin(th)
        j[u, 2] = x * np.sin(th) + z * np.cos(th)
    if rng.random() < 0.4:  # lateral lean
        j[u, 0] += (-j[u, 1]) * float(rng.uniform(-0.5, 0.5))
    for side in "lr":
        if rng.random() < 0.35:  # leg raise
            lift = float(rng.uniform(0.2, 1.0))
            j[_J[f"{side}_knee"]] += (0, -0.40 * lift, -0.22 * lift)
            for p in ("ankle", "foot"):
                j[_J[f"{side}_{p}"]] += (0, -0.36 * lift, 0.02 * lift)
    return j


class SyntheticHumanSampler:
    """Random scenes: motion x phase x placement x yaw x depth.

    ``pose_mode="motions"`` (default) draws from the four MOTIONS — the
    byte-stable distribution the round-3 fixtures/receipts were trained on.
    ``pose_mode="diverse"`` mixes 50% :func:`random_humanoid_pose` with 50%
    library motions (MOTIONS + the frozen ``_POSE_SCENE_ACTIONS`` set) —
    the distribution a general-purpose pose net needs (see
    random_humanoid_pose docstring).
    """

    def __init__(self, frame_hw: Tuple[int, int] = (240, 320),
                 intrinsics: Optional[CameraIntrinsics] = None, seed: int = 0,
                 z_range: Tuple[float, float] = (1.8, 3.6),
                 pose_mode: str = "motions"):
        assert pose_mode in ("motions", "diverse"), pose_mode
        self.frame_hw = frame_hw
        self.intrinsics = intrinsics or CameraIntrinsics()
        self.rng = np.random.default_rng(seed)
        self.z_range = z_range
        self.pose_mode = pose_mode

    def sample(self, motion: Optional[str] = None, person: bool = True,
               t: Optional[float] = None, center=None, yaw: Optional[float] = None,
               hard: bool = False):
        """Returns (frame, gt). The body is placed so its full vertical
        extent projects inside the frame. ``hard`` (person-free scenes
        only): add disarticulated body-part-like clutter — the hard
        negatives of the detector-calibration fine-tune
        (render_humanoid_scene ``humanlike_clutter``)."""
        rng = self.rng
        if motion is None and self.pose_mode == "diverse" and person:
            if rng.random() < 0.5:
                local = random_humanoid_pose(rng)
                motion = "random"
            else:
                lib = list(MOTIONS) + list(_POSE_SCENE_ACTIONS)
                motion = lib[rng.integers(len(lib))]
                local = humanoid_pose(
                    float(rng.random()) if t is None else t, motion,
                    phase=float(rng.uniform(0, 2 * np.pi)),
                )
        else:
            # "motions" mode consumes the rng EXACTLY as round 3 did — the
            # cached trained fixtures and receipts are keyed on this stream
            motion = motion or MOTIONS[rng.integers(len(MOTIONS))]
            t = float(rng.random()) if t is None else t
            local = humanoid_pose(t, motion,
                                  phase=float(rng.uniform(0, 2 * np.pi)))
        h, w = self.frame_hw
        k = self.intrinsics.matrix()
        f = float(k[0, 0])
        z = float(rng.uniform(*self.z_range))
        if center is None:
            if self.pose_mode == "diverse":
                # exact per-pose extent: raised arms / split legs exceed the
                # fixed-span assumption below, so bound from `local` itself
                # (x/z mix under yaw -> use the radial x-z extent)
                up = -float(local[:, 1].min()) + 0.17
                dn = float(local[:, 1].max()) + 0.10
                rad = float(np.hypot(local[:, 0], local[:, 2]).max()) + 0.12
                x_span = rad * f / z
                lo_y, hi_y = up * f / z, h - dn * f / z
            else:
                # keep the projected body inside the frame: the body spans
                # y in [-0.75, 0.95] around the pelvis, x in +-0.45
                y_span = 0.95 * f / z
                x_span = 0.50 * f / z
                lo_y, hi_y = 0.85 * y_span, h - 1.1 * y_span
            cx = rng.uniform(x_span, w - x_span) if w > 2 * x_span else w / 2
            cy = rng.uniform(lo_y, hi_y) if hi_y > lo_y else h / 2
            center = ((cx - k[0, 2]) / f * z, (cy - k[1, 2]) / f * z, z)
        yaw = float(rng.uniform(-0.7, 0.7)) if yaw is None else yaw
        joints = place_in_camera(local, center, yaw)
        frame, gt = render_humanoid_scene(
            joints, self.intrinsics, self.frame_hw, rng, person=person,
            humanlike_clutter=int(rng.integers(3, 7))
            if hard and not person else 0,
        )
        gt["motion"] = motion
        return frame, gt


def render_motion_clip(
    motion: str,
    n_frames: int = 16,
    frame_hw: Tuple[int, int] = (240, 320),
    intrinsics: Optional[CameraIntrinsics] = None,
    center=(0.0, 0.2, 2.5),
    yaw: float = 0.0,
    cycles: float = 1.5,
    seed: int = 0,
    phase: float = 0.0,
):
    """A moving-humanoid clip: ``n_frames`` of one motion cycle(s).

    Returns (frames [(H, W, 3) uint8 BGR], gts [dict]) — the AR demo's
    acquisition source (reference main.py:243-319 captures the same thing
    from a camera)."""
    intrinsics = intrinsics or CameraIntrinsics()
    rng = np.random.default_rng(seed)
    frames, gts = [], []
    for i in range(n_frames):
        t = cycles * i / n_frames
        joints = place_in_camera(humanoid_pose(t, motion, phase=phase), center, yaw)
        frame, gt = render_humanoid_scene(joints, intrinsics, frame_hw, rng)
        gt["motion"] = motion
        frames.append(frame)
        gts.append(gt)
    return frames, gts


# ------------------------------------------------------------- shared parts


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., n, 4) and (..., m, 4) x1y1x2y2 boxes -> (..., n, m)
    (JAX ``train/detection.py::pairwise_iou`` with leading batch axes)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-9)


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def _check_warmstart_shapes(given: Mapping, expected: Mapping, what: str) -> None:
    """Fail fast, naming the offending path, when a warm-start tree does not
    match the selected architecture (a CI-size fit handed to a production
    run)."""
    g, e = _flatten(given), _flatten(expected)
    if set(g) != set(e):
        missing = sorted(set(e) - set(g))[:3]
        extra = sorted(set(g) - set(e))[:3]
        raise ValueError(
            f"warm-start {what} tree does not match this architecture: "
            f"missing={['/'.join(k) for k in missing]} "
            f"extra={['/'.join(k) for k in extra]}")
    for k in g:
        if tuple(np.shape(g[k])) != tuple(e[k].shape):
            raise ValueError(
                f"warm-start {what} leaf {'/'.join(k)} has shape {tuple(np.shape(g[k]))}, "
                f"this architecture expects {tuple(e[k].shape)} — was the checkpoint "
                f"trained at a different size preset?")


def _param_dtype(dtype: torch.dtype) -> torch.dtype:
    """Parameters are float32 (Flax's ``param_dtype``) unless the net
    computes in float64, where a float64 tree was handed in."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class NetTrainer:
    """A net trained with batch statistics and JAX's optimizer: the step the
    trainers share. A subclass gives :meth:`loss`, which runs the net in
    training and appends its BatchNorms' statistics to ``stats``."""

    def __init__(self, net: torch.nn.Module, variables: Optional[Mapping], what: str, seed: int,
                 lr: float, device: str):
        """variables: Flax {"params", "batch_stats"} (numpy or tensor leaves)
        to start from, checked against the net's shapes; None fills the net
        from ``seed``. The optimizer always starts fresh."""
        self.device = float32_device(device)
        self.net = net
        if variables is None:
            init_random(net, torch.Generator().manual_seed(seed))
        else:
            _check_warmstart_shapes(variables, to_flax_variables(net.state_dict()), what)
            net.load_state_dict(convert_variables(variables), strict=True)
        self.net.to(self.device)
        self.optimizer = ClipAdam(self.net.parameters(), lr)

    @property
    def variables(self) -> Dict:
        """The net's Flax variables, CPU tensors."""
        return to_flax_variables(self.net.state_dict())

    def loss(self, batch: Mapping, stats: Optional[list] = None) -> torch.Tensor:
        raise NotImplementedError

    def train_step(self, batch: Mapping) -> float:
        """One step: the loss's gradients, one optimizer update, then the
        forward's batch statistics applied to the running averages (the
        update's gradients come from the old ones, as in JAX)."""
        stats = []
        self.optimizer.zero_grad()
        loss = self.loss(batch, stats)
        loss.backward()
        self.optimizer.step()
        update_running_stats(stats)
        return float(loss.detach())


# ------------------------------------------------------------- YOLO trainer


def yolo_person_loss(boxes: torch.Tensor, confs: torch.Tensor, gt_box: torch.Tensor,
                     has_person: torch.Tensor, pos_iou: float = 0.35, neg_iou: float = 0.3):
    """JAX's single-image loss, batched: boxes (b, n, 1, 4) or (b, n, 4)
    normalized x1y1x2y2, confs (b, n, 80), gt_box (b, 4), has_person (b,)
    bool -> (per-image totals (b,), {score_loss, box_loss, other_cls_loss}
    each (b,)).

    Every anchor at IoU >= ``pos_iou`` and the first best-IoU anchor (ties
    go to the lower index, as ``jnp.argmax``) is positive in an image with a
    person; classes 1..79 are pushed to 0 everywhere."""
    b = boxes.shape[0]
    boxes = boxes.reshape(b, -1, 4)
    n = boxes.shape[1]
    confs = confs.reshape(b, n, -1)
    person = confs[..., 0]
    iou = pairwise_iou(boxes, gt_box[:, None])[..., 0]  # (b, n)
    best = F.one_hot(torch.argmax(iou, dim=1), n).bool()
    has = has_person.bool()[:, None]
    pos = ((iou >= pos_iou) | best) & has
    neg = ((iou < neg_iou) & ~pos) | ~has
    n_pos = torch.clamp(pos.sum(1).to(boxes.dtype), min=1.0)
    n_neg = torch.clamp(neg.sum(1).to(boxes.dtype), min=1.0)
    p = torch.clamp(person, 1e-6, 1 - 1e-6)
    score_loss = -((torch.log(p) * pos).sum(1) / n_pos + (torch.log(1 - p) * neg).sum(1) / n_neg)
    other = torch.clamp(confs[..., 1:], 1e-6, 1.0)
    other_loss = -torch.log(1 - other + 1e-6).mean(dim=(1, 2))
    box_loss = (smooth_l1(boxes - gt_box[:, None]).sum(-1) * pos).sum(1) / n_pos
    total = score_loss + 5.0 * box_loss + 0.5 * other_loss
    return total, {"score_loss": score_loss, "box_loss": box_loss, "other_cls_loss": other_loss}


class YoloTrainer(NetTrainer):
    """Person-detection trainer for the YOLOv4 contract.

    batch: {"image": (b, S, S, 3) RGB float in [0, 1] (INTER_AREA-resized
    full frames), "bbox": (b, 4) normalized x1y1x2y2, "has_person": (b,)
    bool}, numpy or tensors.
    """

    def __init__(self, width: float = 1.0, input_size: int = 256, seed: int = 0,
                 lr: float = 3e-4, dtype: torch.dtype = torch.float32,
                 variables: Optional[Mapping] = None, remat: bool = False,
                 device: str = "cuda"):
        """variables: Flax {"params", "batch_stats"} to warm-start from;
        remat: recompute each CSP stage of the backbone in the backward pass
        (the same step, less memory)."""
        self.input_size = input_size
        super().__init__(YOLOv4(width=width, dtype=dtype, remat=remat).to(_param_dtype(dtype)),
                         variables, "yolo", seed, lr, device)

    def loss(self, batch: Mapping, stats: Optional[list] = None) -> torch.Tensor:
        image = torch.as_tensor(batch["image"]).to(self.device).permute(0, 3, 1, 2)
        boxes, confs = self.net(image, True, stats)
        losses, _ = yolo_person_loss(boxes, confs, torch.as_tensor(batch["bbox"]).to(self.device),
                                     torch.as_tensor(batch["has_person"]).to(self.device))
        return losses.mean()


# ---------------------------------------------------------- heatmap trainer


class HeatmapTrainer(NetTrainer):
    """EfficientNetV2 + MetrabsHead through the live crop chain, batched:
    the virtual camera of each (jittered) person box, the homography warp
    to the crop, backbone, head and the soft-argmax decodes, supervised
    against exact projections (pred2d against the joints projected through
    the virtual camera in crop pixels, pred3d against ``(X_crop -
    centroid) / BOX_SIZE_M + 0.5``).

    batch: {"frame": (b, H, W, 3) uint8, "box_px": (b, 4) pixel x1y1x2y2,
    "joints3d": (b, 32, 3) camera space}.
    """

    def __init__(self, intrinsics: CameraIntrinsics, crop_size: int = 256,
                 stages: Sequence = V2_TINY, seed: int = 0, lr: float = 1e-3,
                 dtype: torch.dtype = torch.float32, w3d: float = 1.0,
                 variables: Optional[Mapping] = None, huber_beta: float = 0.05,
                 remat: bool = False, device: str = "cuda"):
        """variables: {"bbone": full Flax vars, "head": {"params"}} (a previous
        trainer's :attr:`variables`) to warm-start from; remat: recompute
        each MBConv in the backward pass. Two nets, one optimizer over both:
        the step is :meth:`NetTrainer.train_step`."""
        self.device = float32_device(device)
        self.crop_size = crop_size
        self.w3d, self.huber_beta = w3d, huber_beta
        self.param_dtype = _param_dtype(dtype)
        self.bbone = EfficientNetV2(stages=stages, dtype=dtype, remat=remat).to(self.param_dtype)
        self.head = MetrabsHead().to(self.param_dtype)
        if variables is not None:
            _check_warmstart_shapes(variables, self.variables, "pose")
            self.bbone.load_state_dict(convert_variables(variables["bbone"]), strict=True)
            self.head.load_state_dict(convert_variables(variables["head"]), strict=True)
        else:
            gen = torch.Generator().manual_seed(seed)
            init_random(self.bbone, gen)
            init_random(self.head, gen)
        self.bbone.to(self.device)
        self.head.to(self.device)
        self.k_matrix = torch.from_numpy(intrinsics.matrix()).to(self.device)
        self.optimizer = ClipAdam([*self.bbone.parameters(), *self.head.parameters()], lr)

    @property
    def variables(self) -> Dict:
        """{"bbone": full vars, "head": {"params"}}: the estimator's slots."""
        return {"bbone": to_flax_variables(self.bbone.state_dict()),
                "head": to_flax_variables(self.head.state_dict())}

    @torch.no_grad()
    def crop_and_targets(self, frames: torch.Tensor, box_px: torch.Tensor,
                         joints3d: torch.Tensor):
        """(b, H, W, 3) frames, (b, 4) boxes, (b, 32, 3) joints on the device
        -> (int32 crops (b, c, c, 3), gt2d (b, 32, 2), gt3d (b, 32, 3))."""
        c = self.crop_size
        new_k, rot = virtual_camera(box_px[:, 0], box_px[:, 2], box_px[:, 1], box_px[:, 3],
                                    self.k_matrix, c)
        crops = warp_image(frames.to(torch.int32), warp_matrix(self.k_matrix, new_k, rot), c)
        # original camera -> crop camera: X_crop = X @ rot^T
        x_crop = mm(joints3d, rot.transpose(1, 2))
        focal = torch.stack([new_k[:, 0, 0], new_k[:, 1, 1]], dim=-1)[:, None]
        center = torch.stack([new_k[:, 0, 2], new_k[:, 1, 2]], dim=-1)[:, None]
        gt2d = project(x_crop) * focal + center
        gt3d = (x_crop - x_crop.mean(dim=1, keepdim=True)) / BOX_SIZE_M + 0.5
        return crops, gt2d, gt3d

    def loss(self, batch: Mapping, stats: Optional[list] = None) -> torch.Tensor:
        c = self.crop_size
        crops, gt2d, gt3d = self.crop_and_targets(
            torch.as_tensor(batch["frame"]).to(self.device),
            torch.as_tensor(batch["box_px"]).to(self.device),
            torch.as_tensor(batch["joints3d"]).to(self.device))
        x = (crops.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
        feats = self.bbone(x, True, stats)
        logits = self.head(feats.to(self.param_dtype))
        l2d, l3d = split_head_logits(logits)
        pred3d = decode_heatmap3d(l3d)
        pred2d = decode_heatmap2d(l2d, scale=float(c - 1))
        loss2d = smooth_l1((pred2d - gt2d) / c, self.huber_beta).mean()
        loss3d = smooth_l1(pred3d - gt3d, self.huber_beta).mean()
        return loss2d + self.w3d * loss3d


# -------------------------------------------------------------- end-to-end


def detector_batch(sampler: SyntheticHumanSampler, batch_size: int, input_size: int,
                   norm: np.ndarray, empty_frac: float, hard_frac: Optional[float] = None):
    """One detector batch drawn as JAX draws it: per scene, person or not
    (and, with ``hard_frac``, a hard empty scene or not), the scene, its
    INTER_AREA resize to the detector's input (cv2's uint8 pixels) as RGB
    in [0, 1]."""
    imgs, boxes, flags = [], [], []
    for _ in range(batch_size):
        person = sampler.rng.random() >= empty_frac
        hard = hard_frac is not None and (not person) and sampler.rng.random() < hard_frac
        frame, gt = sampler.sample(person=person, hard=hard)
        small = resize_area_u8(frame, input_size, input_size)
        imgs.append(small[..., ::-1] / 255.0)
        boxes.append(gt["bbox"] / norm)
        flags.append(person)
    return {"image": np.asarray(imgs, np.float32), "bbox": np.stack(boxes),
            "has_person": np.asarray(flags)}


def pose_batch(sampler: SyntheticHumanSampler, batch_size: int, box_jitter: float):
    """One heatmap batch drawn as JAX draws it: the scene, then its box's
    jitter (normal, scaled by the box's width and height)."""
    frames, boxes, joints = [], [], []
    for _ in range(batch_size):
        frame, gt = sampler.sample()
        b = gt["bbox"]
        bw, bh = b[2] - b[0], b[3] - b[1]
        jit = sampler.rng.normal(0, box_jitter, 4) * np.asarray([bw, bh, bw, bh])
        frames.append(frame)
        boxes.append((b + jit).astype(np.float32))
        joints.append(gt["joints3d"])
    return {"frame": np.asarray(frames, np.uint8), "box_px": np.stack(boxes),
            "joints3d": np.stack(joints)}


def train_pose_params(
    frame_hw: Tuple[int, int] = (240, 320),
    intrinsics: Optional[CameraIntrinsics] = None,
    n_steps_det: int = 300,
    n_steps_pose: int = 300,
    batch_size: int = 8,
    yolo_width: float = 0.25,
    yolo_input_size: int = 128,
    crop_size: int = 128,
    stages: Sequence = V2_TINY,
    seed: int = 0,
    lr_det: float = 1e-3,
    lr_pose: float = 1e-3,
    box_jitter: float = 0.08,
    empty_frac: float = 0.12,
    log_every: int = 0,
    init_params: Optional[Dict] = None,
    pose_mode: str = "motions",
    pose_huber_beta: float = 0.05,
    remat: bool = False,
    device: str = "cuda",
) -> Dict:
    """Train YOLOv4 + EfficientNetV2 + MetrabsHead on synthetic humanoid
    scenes and return the Flax tree ``HumanPoseEstimator(params=...)``
    loads, ``{"yolo", "bbone", "head"}``.

    The defaults are the CI budget; production is the same call with
    ``yolo_width=1.0, yolo_input_size=256, crop_size=256, stages=V2_L``.
    ``init_params`` warm-starts from a previous call's weights (the
    optimizer restarts); a tree with only ``"yolo"`` warm-starts the
    detector and trains the pose branch from scratch (the pose branch
    needs both ``"bbone"`` and ``"head"`` or neither). The detector and the
    pose phase draw from two samplers (seeds ``seed`` and ``seed + 1``), so
    one phase's budget never moves the other's data."""
    intrinsics = intrinsics or CameraIntrinsics()
    h, w = frame_hw
    norm = np.asarray([w, h, w, h], np.float32)

    det_sampler = SyntheticHumanSampler(frame_hw, intrinsics, seed=seed, pose_mode=pose_mode)
    det = YoloTrainer(width=yolo_width, input_size=yolo_input_size, seed=seed, lr=lr_det,
                      remat=remat, variables=init_params.get("yolo") if init_params else None,
                      device=device)
    for step in range(n_steps_det):
        loss = det.train_step(detector_batch(det_sampler, batch_size, yolo_input_size, norm,
                                             empty_frac))
        if log_every and step % log_every == 0:
            print(f"[posestack:det] step {step} loss {loss:.4f}", flush=True)

    pose_sampler = SyntheticHumanSampler(frame_hw, intrinsics, seed=seed + 1,
                                         pose_mode=pose_mode)
    pose_warm = {k for k in ("bbone", "head") if init_params and k in init_params}
    if len(pose_warm) == 1:
        raise ValueError(
            f"init_params has {sorted(pose_warm)} but the pose branch warm-start needs BOTH "
            f"'bbone' and 'head' (or neither, to train the branch from scratch)")
    pose = HeatmapTrainer(
        intrinsics, crop_size=crop_size, stages=stages, seed=seed, lr=lr_pose,
        variables={k: init_params[k] for k in ("bbone", "head")} if pose_warm else None,
        huber_beta=pose_huber_beta, remat=remat, device=device)
    for step in range(n_steps_pose):
        loss = pose.train_step(pose_batch(pose_sampler, batch_size, box_jitter))
        if log_every and step % log_every == 0:
            print(f"[posestack:pose] step {step} loss {loss:.4f}", flush=True)

    return {"yolo": det.variables, **pose.variables}


# CI operating point shared by the trained CI fixtures and the offline
# workflow (one cache entry serves both)
CI_FRAME_HW = (240, 320)
CI_INTRINSICS = CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0,
                                 width=320, height=240)
CI_BUDGETS = dict(n_steps_det=700, n_steps_pose=700, batch_size=8, empty_frac=0.2)

# Cache-key material (version, key builder) of each fixture: the JAX
# package's strings exactly, so the digests name the bundle's files
# (weights.verify holds them to MANIFEST.json)
_CI_KEY_V = ("1", lambda: (f"posestack:{CI_INTRINSICS!r}:{CI_FRAME_HW!r}:"
                           f"{sorted(CI_BUDGETS.items())!r}"))


def ci_pose_params(device: str = "cuda"):
    """The CI-budget trained pose stack (``pose-ci-motions``), from the
    bundle or the cache; trains on ``device`` on a miss."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    return cached_params(
        _CI_KEY_V[1](),
        lambda: train_pose_params(CI_FRAME_HW, CI_INTRINSICS, device=device, **CI_BUDGETS),
        version=_CI_KEY_V[0])


_DIVERSE_KEY_V = ("1", lambda: (f"posestack-diverse:{CI_INTRINSICS!r}:"
                                f"{CI_FRAME_HW!r}:{sorted(CI_BUDGETS.items())!r}"))


def diverse_pose_params(device: str = "cuda"):
    """The CI-budget pose stack on the diverse pose distribution
    (``pose-ci-diverse``)."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    return cached_params(
        _DIVERSE_KEY_V[1](),
        lambda: train_pose_params(CI_FRAME_HW, CI_INTRINSICS, pose_mode="diverse",
                                  device=device, **CI_BUDGETS),
        version=_DIVERSE_KEY_V[0])


# Production operating point: full-width YOLOv4 at 256 with EfficientNetV2-L
# at a 256 crop on 480x640 frames, the motions distribution
PROD_FRAME_HW = (480, 640)
PROD_BUDGETS = dict(n_steps_det=300, n_steps_pose=600, batch_size=8,
                    crop_size=256, seed=3, pose_huber_beta=0.02,
                    pose_mode="motions")

_PROD_KEY_V = ("1", lambda: (
    f"posestack-prod256:{CameraIntrinsics()!r}:{PROD_FRAME_HW!r}:"
    f"{sorted(PROD_BUDGETS.items())!r}:yolo_w1.0:yolo_in256:stages=V2_L"))


def _storage_cast_trunks(params: Mapping, dt: torch.dtype = torch.bfloat16) -> Dict:
    """Store the YOLO and backbone trunks in ``dt`` (bf16), as the bundle
    does: every floating leaf under "yolo" or "bbone" except the BatchNorm
    statistics and the YOLO box outputs (``head*_out``); the MetrABS head
    stays float32. Leaves become CPU tensors."""
    def cast(path, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        trunk = (path[:1] in (("yolo",), ("bbone",)) and "batch_stats" not in path
                 and not any(k.startswith("head") and k.endswith("_out") for k in path))
        return t.to(dt) if trunk and t.is_floating_point() else t

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping) else cast(path + (k,), v)
                for k, v in tree.items()}

    return walk(params, ())


def prod_pose_params(device: str = "cuda"):
    """The production pose stack (``pose-prod-256``, bf16 trunks), from the
    bundle or the cache. A miss trains it on ``device``: about 40 minutes
    of a TPU in JAX, and the 351 MB bundle file never reaches the card's
    copy of the repo, so do not call this on the card."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    def build():
        params = train_pose_params(PROD_FRAME_HW, CameraIntrinsics(), yolo_width=1.0,
                                   yolo_input_size=256, stages=V2_L, log_every=50,
                                   device=device, **PROD_BUDGETS)
        return _storage_cast_trunks(params)

    return cached_params(_PROD_KEY_V[1](), build, version=_PROD_KEY_V[0])


# ------------------------------------ detector confidence calibration


def _float32_tree(tree: Mapping) -> Dict:
    """Floating leaves as float32 tensors (bf16-stored trunks cast up to
    float32 master weights); other leaves as tensors."""
    def leaf(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t.float() if t.is_floating_point() else t

    return {k: _float32_tree(v) if isinstance(v, Mapping) else leaf(v) for k, v in tree.items()}


def finetune_detector(
    params: Dict,
    frame_hw: Tuple[int, int],
    intrinsics: Optional[CameraIntrinsics] = None,
    *,
    n_steps: int = 200,
    batch_size: int = 8,
    empty_frac: float = 0.5,
    hard_frac: float = 0.7,
    lr: float = 1e-4,
    seed: int = 7,
    yolo_width: float = 1.0,
    yolo_input_size: int = 256,
    pose_mode: str = "motions",
    log_every: int = 0,
    device: str = "cuda",
) -> Dict:
    """Detector-only confidence calibration on hard empty scenes: warm-start
    the YOLO branch of ``params`` (bf16 trunks cast up to float32 master
    weights) and fine-tune it at a low rate on a stream that is
    ``empty_frac`` person-free, ``hard_frac`` of those with disarticulated
    body-part clutter. Returns the YOLO variables; the pose branch is
    untouched."""
    intrinsics = intrinsics or CameraIntrinsics()
    h, w = frame_hw
    norm = np.asarray([w, h, w, h], np.float32)
    det = YoloTrainer(width=yolo_width, input_size=yolo_input_size, seed=seed, lr=lr,
                      variables=_float32_tree(params["yolo"]), device=device)
    sampler = SyntheticHumanSampler(frame_hw, intrinsics, seed=seed + 100, pose_mode=pose_mode)
    for step in range(n_steps):
        loss = det.train_step(detector_batch(sampler, batch_size, yolo_input_size, norm,
                                             empty_frac, hard_frac))
        if log_every and step % log_every == 0:
            print(f"[posestack:calib] step {step} loss {loss:.4f}", flush=True)
    return det.variables


# the production fit's calibration budgets
PROD_CALIB_BUDGETS = dict(n_steps=200, batch_size=8, empty_frac=0.5,
                          hard_frac=0.7, lr=1e-4, seed=7)


def prod_calib_key(budgets: Dict) -> str:
    """Cache key of a production calibration delta at ``budgets``; it embeds
    the base fit's key, so a retrained base invalidates the delta."""
    return (f"posestack-prod256-calib:{sorted(budgets.items())!r}:"
            f"base=v{_PROD_KEY_V[0]}:{_PROD_KEY_V[1]()}")


_PROD_CALIB_KEY_V = ("1", lambda: prod_calib_key(PROD_CALIB_BUDGETS))


def prod_detector_calib_delta(device: str = "cuda") -> Dict:
    """The calibrated YOLO branch of the production fit (``{"yolo": ...}``,
    bf16 trunks; ``pose-prod-256-calib``), from the bundle or the cache. A
    miss needs :func:`prod_pose_params` first."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    def build():
        yolo = finetune_detector(prod_pose_params(device), PROD_FRAME_HW, CameraIntrinsics(),
                                 yolo_width=1.0, yolo_input_size=256, pose_mode="motions",
                                 log_every=25, device=device, **PROD_CALIB_BUDGETS)
        return _storage_cast_trunks({"yolo": yolo})

    return cached_params(_PROD_CALIB_KEY_V[1](), build, version=_PROD_CALIB_KEY_V[0])


def prod_pose_params_calib(device: str = "cuda") -> Dict:
    """The production pose stack with the calibrated detector merged over it."""
    return {**prod_pose_params(device), **prod_detector_calib_delta(device)}


# the same calibration at the CI operating point
CI_CALIB_BUDGETS = dict(n_steps=120, batch_size=8, empty_frac=0.5,
                        hard_frac=0.7, lr=1e-4, seed=7)

_CI_CALIB_KEY_V = ("1", lambda: (
    f"posestack-ci-calib:{sorted(CI_CALIB_BUDGETS.items())!r}:"
    f"base=v{_CI_KEY_V[0]}:{_CI_KEY_V[1]()}"))


def ci_detector_calib_delta(device: str = "cuda") -> Dict:
    """The calibrated YOLO branch of the CI fit (``pose-ci-calib``, float32)."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    def build():
        yolo = finetune_detector(ci_pose_params(device), CI_FRAME_HW, CI_INTRINSICS,
                                 yolo_width=0.25, yolo_input_size=128, pose_mode="motions",
                                 device=device, **CI_CALIB_BUDGETS)
        return {"yolo": yolo}

    return cached_params(_CI_CALIB_KEY_V[1](), build, version=_CI_CALIB_KEY_V[0])


def ci_pose_params_calib(device: str = "cuda") -> Dict:
    """The CI pose stack with the calibrated detector."""
    return {**ci_pose_params(device), **ci_detector_calib_delta(device)}


# Extraction-grade budgets: a pose-only refit at a 256 crop (an 8x8 decode)
# on the diverse fit's detector
CI_EXTRACT_BUDGETS = dict(n_steps_det=0, n_steps_pose=6000, batch_size=8,
                          crop_size=256, seed=12, pose_huber_beta=0.02)

_DIVERSE256_KEY_V = ("1", lambda: (
    f"posestack-diverse256:{CI_INTRINSICS!r}:{CI_FRAME_HW!r}:"
    f"{sorted(CI_EXTRACT_BUDGETS.items())!r}:"
    f"base=v{_DIVERSE_KEY_V[0]}:{_DIVERSE_KEY_V[1]()}"))


def diverse_pose_params_256(device: str = "cuda"):
    """The extraction-grade diverse fit (``pose-diverse-256``), from the
    bundle or the cache."""
    from isbfsar_tpu_torch.utils.cache import cached_params

    def build():
        base = diverse_pose_params(device)
        return train_pose_params(CI_FRAME_HW, CI_INTRINSICS, pose_mode="diverse",
                                 init_params={"yolo": base["yolo"]}, device=device,
                                 **CI_EXTRACT_BUDGETS)

    return cached_params(_DIVERSE256_KEY_V[1](), build, version=_DIVERSE256_KEY_V[0])


def estimate_row(estimator, frame: np.ndarray) -> np.ndarray:
    """One frame through the estimator's module path (``estimate_async``):
    the packed float32 row (bbox x1, x2, y1, y2, conf, found, the pose,
    visible)."""
    _, copy = estimator.estimate_async(frame)
    return copy.numpy()


def evaluate_pose_stack(
    estimator,
    frame_hw: Tuple[int, int],
    intrinsics: CameraIntrinsics,
    n_scenes: int = 15,
    n_empty: int = 10,
    seed: int = 1000,
    n_hard_empty: int = 0,
) -> Dict[str, float]:
    """Fresh-scene receipt of a trained estimator at its configured gate:
    ``n_scenes`` person scenes and ``n_empty`` person-free ones (and
    ``n_hard_empty`` with body-part clutter) from a new sampler seed,
    through the port estimator's module path. Returns JAX's keys:
    ``found_rate``, ``iou_mean``/``iou_min``, ``rel_err_m`` (root-relative
    joint error), ``abs_err_m``, ``dist_err_m``, ``empty_fp_rate``,
    ``empty_conf_median``/``empty_conf_max``, ``person_conf_min`` and,
    with hard scenes, ``hard_empty_fp_rate``/``hard_empty_conf_max``."""
    from isbfsar_tpu_torch.utils.skeleton import get_skeleton, load_expand_joints

    jm = load_expand_joints("")[:, list(get_skeleton("smpl+head_30").indices)]

    def _iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.maximum(rb - lt, 0)
        inter = wh[0] * wh[1]
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
        return float(inter / (ua + 1e-9))

    s = SyntheticHumanSampler(frame_hw, intrinsics, seed=seed)
    found_n = 0
    ious, rel_errs, abs_errs, dist_errs, person_confs = [], [], [], [], []
    for _ in range(n_scenes):
        frame, gt = s.sample()
        row = estimate_row(estimator, frame)
        person_confs.append(float(row[4]))
        if not (row[5] > 0 and row[-1] > 0):
            continue
        found_n += 1
        x1, x2, y1, y2 = row[:4]
        ious.append(_iou(np.asarray([x1, y1, x2, y2], float), gt["bbox"]))
        gt30 = np.einsum("jc,jn->nc", gt["joints3d"], jm)
        pose_m = row[6:-1].reshape(-1, 3) * BOX_SIZE_M
        rel_errs.append(float(np.linalg.norm(
            (pose_m - pose_m[0]) - (gt30 - gt30[0]), axis=-1).mean()))
        abs_errs.append(float(np.linalg.norm(pose_m - gt30, axis=-1).mean()))
        dist_errs.append(abs(float(np.linalg.norm(pose_m[0]) - np.linalg.norm(gt30[0]))))

    def count_fps(n, hard):
        fp, confs = 0, []
        for _ in range(n):
            frame, _ = s.sample(person=False, hard=hard)
            row = estimate_row(estimator, frame)
            fp += int(row[5] > 0)
            confs.append(float(row[4]))
        return fp, confs

    fp, empty_confs = count_fps(n_empty, hard=False)
    hard_fp, hard_confs = count_fps(n_hard_empty, hard=True)

    def m(x):
        return float(np.mean(x)) if x else float("nan")

    out = {
        "n_scenes": n_scenes,
        "found_rate": found_n / max(n_scenes, 1),
        "iou_mean": m(ious),
        "iou_min": float(np.min(ious)) if ious else float("nan"),
        "rel_err_m": m(rel_errs),
        "abs_err_m": m(abs_errs),
        "dist_err_m": m(dist_errs),
        "empty_fp_rate": fp / max(n_empty, 1),
        "empty_conf_median": float(np.median(empty_confs)) if empty_confs else float("nan"),
        "empty_conf_max": float(np.max(empty_confs)) if empty_confs else float("nan"),
        "person_conf_min": float(np.min(person_confs)) if person_confs else float("nan"),
    }
    if n_hard_empty:
        out["hard_empty_fp_rate"] = hard_fp / n_hard_empty
        out["hard_empty_conf_max"] = float(np.max(hard_confs))
    return out
