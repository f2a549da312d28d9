"""The synthetic humanoid (port of the renderer half of
``isbfsar_tpu/train/posestack.py``; the pose-stack trainers are not ported).

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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from isbfsar_tpu_torch.configs import CameraIntrinsics
from isbfsar_tpu_torch.utils import draw

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


# ------------------------------------------------------------- YOLO trainer


# CI operating point of the trained CI pose stacks and the offline workflow
CI_FRAME_HW = (240, 320)
CI_INTRINSICS = CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0,
                                 width=320, height=240)
