"""The port's synthetic humanoid (``train/posestack.py``, drawn by
``utils/draw.py``) against the JAX package's (drawn by cv2): frames pixel
for pixel and the ground-truth dicts exactly, which holds only when the
port consumes each ``np.random.Generator`` in the JAX order. Also the
``HumanoidSource`` stream and its ``make_source`` entry."""

import numpy as np
import pytest

from isbfsar_tpu import configs as jc
from isbfsar_tpu.runtime.source import HumanoidSource as JaxHumanoidSource
from isbfsar_tpu.train import posestack as jp
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.runtime.source import HumanoidSource, make_source
from isbfsar_tpu_torch.train import posestack as tp


def _assert_same(ours, ref):
    (frame, gt), (ref_frame, ref_gt) = ours, ref
    assert frame.dtype == ref_frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, ref_frame)
    assert gt.keys() == ref_gt.keys()
    for key, v in ref_gt.items():
        if isinstance(v, np.ndarray):
            assert gt[key].dtype == v.dtype
            np.testing.assert_array_equal(gt[key], v, err_msg=key)
        else:
            assert gt[key] == v, key


def test_tables_match_jax():
    assert tp.JOINT_NAMES == jp.JOINT_NAMES and tp.HUMANOID_EDGES == jp.HUMANOID_EDGES
    assert tp.MOTIONS == jp.MOTIONS and tp._POSE_SCENE_ACTIONS == jp._POSE_SCENE_ACTIONS
    for name in ("ACTION_TRAIN_CLASSES", "ACTION_TEST_CLASSES", "ACTION_EXTRA_CLASSES"):
        assert getattr(tp, name) == getattr(jp, name)
    np.testing.assert_array_equal(tp._JOINT_RADIUS, jp._JOINT_RADIUS)
    assert tp.CI_FRAME_HW == jp.CI_FRAME_HW and repr(tp.CI_INTRINSICS) == repr(jp.CI_INTRINSICS)


@pytest.mark.parametrize("pose_mode", ["motions", "diverse"])
def test_sampler_scenes_equal_jax(pose_mode):
    """Scenes with a person, empty ones and hard empty ones (limb clutter),
    drawn from one generator in turn."""
    ours = tp.SyntheticHumanSampler(tp.CI_FRAME_HW, tp.CI_INTRINSICS, seed=3, pose_mode=pose_mode)
    ref = jp.SyntheticHumanSampler(jp.CI_FRAME_HW, jp.CI_INTRINSICS, seed=3, pose_mode=pose_mode)
    for i in range(24):
        kw = dict(person=i % 4 != 0, hard=i % 8 == 0)
        _assert_same(ours.sample(**kw), ref.sample(**kw))


@pytest.mark.parametrize("hw", [(240, 320), (480, 640)])
def test_every_motion_clip_equals_jax(hw):
    intr = (tp.CI_INTRINSICS, jp.CI_INTRINSICS) if hw == (240, 320) else (
        tc.CameraIntrinsics(), jc.CameraIntrinsics())
    for motion in jp.MOTIONS + tuple(jp._ACTIONS):
        ours = tp.render_motion_clip(motion, n_frames=2, frame_hw=hw, intrinsics=intr[0], seed=5,
                                     cycles=1.3, yaw=0.3, phase=0.7)
        ref = jp.render_motion_clip(motion, n_frames=2, frame_hw=hw, intrinsics=intr[1], seed=5,
                                    cycles=1.3, yaw=0.3, phase=0.7)
        for a, b, c, d in zip(*ours, *ref):
            _assert_same((a, b), (c, d))


def test_humanoid_source_equals_jax():
    ours = make_source("humanoid", width=320, height=240, frames_per_motion=20)
    assert isinstance(ours, HumanoidSource)
    ref = JaxHumanoidSource(width=320, height=240, frames_per_motion=20)
    assert repr(ours.intrinsics()) == repr(ref.intrinsics())
    for _ in range(70):  # into the third motion
        (ok, frame), (ref_ok, ref_frame) = ours.read(), ref.read()
        assert ok and ref_ok
        np.testing.assert_array_equal(frame, ref_frame)
    ours.stop()
