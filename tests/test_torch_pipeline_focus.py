"""The port's FusedPipeline with focus on against the JAX FusedPipeline.

The trained CI stacks (``pose-ci-motions`` and ``focus-ci`` at
``CI_FOCUS_CFG``), 240x320 I420 frames (a rendered motion clip and the
committed face frames, interleaved), float32 on the CPU. Every packed
field is compared, the nine ``f_*`` fields included, booleans exactly;
``decode``'s focus verdict and face box too.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.focus.detector import FocusDetector as JaxFocus
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.ops.image import bgr_to_i420
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.train.gazefocus import CI_FOCUS_CFG as JAX_CI_FOCUS_CFG
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.focus.detector import FocusDetector
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.pipeline import FOCUS_FIELDS, FusedPipeline
from isbfsar_tpu_torch.profile_slice import CI_FOCUS_CFG, focus_frames, build_ci

# the suite runs in several processes at once: more torch threads than
# cores each would only wait for one another
torch.set_num_threads(2)

BOOLEANS = ("pose_ok", "ar_ready", "f_found")
# The pose fields as tests/test_torch_pipeline.py holds them. The focus
# fields: the CPU reads f_score 1.2e-7, f_bbox 3.1e-5 px, f_landmarks
# 1.4e-4 px, f_head_position 1.8e-6 m, f_head_rotvec and f_norm_head_rot2d
# 5.9e-6, f_gaze and f_norm_gaze 6.5e-6 (tests/torch_parity_report.py);
# the limits are a few times that.
TOL = {"pose": 1e-4, "pose_abs": 3e-4, "distance": 3e-4, "conf": 1e-5, "bbox": 0.0,
       "probs": 2e-5, "is_true": 2e-6, "f_score": 1e-6, "f_bbox": 2e-4, "f_landmarks": 5e-4,
       "f_head_position": 1e-5, "f_head_rotvec": 3e-5, "f_norm_head_rot2d": 3e-5,
       "f_gaze": 3e-5, "f_norm_gaze": 3e-5}


def _assert_close(ours, ref, tol):
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert list(a) == list(b)
        for key in b:
            if key in BOOLEANS:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"frame {i} {key}")
            else:
                np.testing.assert_allclose(a[key], b[key], atol=tol[key], rtol=0,
                                           err_msg=f"frame {i} {key}")


@pytest.fixture(scope="module")
def focus_ci():
    """The JAX and port pipelines with focus on the same weights, the
    frames, and the JAX pipeline's step and stream_batched outputs."""
    pose_params, focus_params = pretrained.load("pose-ci-motions"), pretrained.load("focus-ci")
    h, w = CI_FRAME_HW
    jhpe_cfg = jc.HPEConfig(compute_dtype="float32", yolo_input_size=128, crop_size=128)
    jhpe = JaxEstimator(jhpe_cfg, CI_INTRINSICS, params=pose_params, backbone_stages=JAX_V2_TINY,
                        frame_shape=CI_FRAME_HW, yolo_width=0.25)
    jar = JaxRecognizer(jc.ARConfig.for_input("skeleton"), seed=0)
    jfocus = JaxFocus(JAX_CI_FOCUS_CFG, CI_INTRINSICS, params=focus_params, frame_shape=CI_FRAME_HW)
    jpipe = JaxPipeline(jc.PipelineConfig(main=jc.MainConfig(cam_width=w, cam_height=h),
                                          intrinsics=CI_INTRINSICS, hpe=jhpe_cfg,
                                          focus=JAX_CI_FOCUS_CFG, param_dtype="float32"),
                        hpe=jhpe, ar=jar, focus=jfocus, with_focus=True, input_format="i420")

    # the port's CI stack on the same weights: build_ci, with the JAX recognizer's
    ours = build_ci("cpu", params=jax.tree.map(np.asarray, pose_params),
                    focus_params=jax.tree.map(np.asarray, focus_params))
    ar = ActionRecognizer(ours.config.ar, params=jax.tree.map(np.asarray, jar.params), device="cpu")
    pipe = FusedPipeline(ours.config, hpe=ours.hpe, ar=ar, focus=ours.focus, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        item = {"flag": f"a{i}", "data": {"poses": rng.normal(size=(16, 90)).astype(np.float32)},
                "requires_focus": i == 1}
        jar.train(item)
        ar.train(item)

    clip, _ = render_motion_clip("wave", n_frames=8, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=1.0)
    faces = focus_frames(240)["i420"]
    frames = [bgr_to_i420(f) for f in clip]
    frames = [f for pair in zip(frames, faces) for f in pair] + frames[len(faces):]
    jpipe.start()
    ref = [jpipe.step(f) for f in frames]
    ref_decoded = [jpipe.decode(o) for o in ref]
    jpipe.start()
    ref_batched = list(jpipe.stream_batched(frames, 8))  # a batch of 8 and a tail of 5
    return pipe, frames, ref, ref_decoded, ref_batched


def test_layout_has_the_jax_focus_fields(focus_ci):
    pipe = focus_ci[0]
    names = list(pipe.layout.specs)
    assert names[-9:] == list(FOCUS_FIELDS) and names[-9:][0] == "f_found"
    assert inspect.signature(FusedPipeline).parameters["with_focus"].default is True
    assert pipe.config.focus == CI_FOCUS_CFG


def test_step_with_focus_matches_jax(focus_ci):
    pipe, frames, ref, _, _ = focus_ci
    pipe.start()
    ours = [pipe.step(f) for f in frames]
    _assert_close(ours, ref, TOL)
    assert all(o["f_found"] for o in ours) and sum(o["pose_ok"] > 0 for o in ours) >= 8


def test_stream_batched_with_focus_matches_jax(focus_ci):
    pipe, frames, _, _, ref_batched = focus_ci
    pipe.start()
    _assert_close(list(pipe.stream_batched(frames, 8)), ref_batched, TOL)


def test_focus_batched_equals_sequential(focus_ci):
    """Same code and recurrence; only the convolutions' batch size differs
    (the CPU reads 3.1e-5 px in f_landmarks and 2.9e-6 in f_head_rotvec)."""
    pipe, frames, _, _, _ = focus_ci
    pipe.start()
    seq = [pipe.step(f) for f in frames]
    pipe.start()
    batched = list(pipe.stream_batched(frames, 8))
    _assert_close(batched, seq, {k: max(v, 1e-5) for k, v in TOL.items()})


def test_focus_static_buffer_step_equals_plain_step(focus_ci):
    """The step the CUDA graphs replay, run eagerly on the CPU over its
    static buffers, against the plain step with focus on: bit-equal."""
    pipe, frames, _, _, _ = focus_ci
    static = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, focus=pipe.focus, device="cpu",
                           cuda_graphs=True)
    outs = []
    for p in (pipe, static):
        p.start()
        run = [p.step(f) for f in frames[:5]]
        run += [p.layout.unpack(row) for row in p.dispatch_batch(np.stack(frames[5:9])).numpy()]
        outs.append(run)
    assert sorted(static._graphs) == [1, 4]
    _assert_close(outs[1], outs[0], {k: 0.0 for k in TOL})


def test_decode_focus_matches_jax(focus_ci):
    """decode's focus verdict and face box, frame by frame through the
    close/far rule and the patience vote, equal to the JAX pipeline's."""
    pipe, frames, ref, ref_decoded, _ = focus_ci
    pipe.focus.focuses = []
    pipe.start()
    verdicts = set()
    for f, want in zip(frames, ref_decoded):
        got = pipe.decode(pipe.step(f))
        assert ("focus" in got) == ("focus" in want)
        assert got["focus"] == want["focus"]
        np.testing.assert_allclose(got["face_bbox"], want["face_bbox"], atol=TOL["f_bbox"])
        verdicts.add(got["focus"])
    assert verdicts == {True, False}
    assert isinstance(pipe.focus, FocusDetector) and len(pipe.focus.focuses) == 3


def test_focus_nets_keep_float32_weights():
    """param_dtype casts the pose trunks only; the focus nets keep float32
    weights (the JAX pipeline never casts them) and compute in the focus
    config's type. Random weights, the default config's types."""
    hpe = HumanPoseEstimator(tc.HPEConfig(yolo_input_size=128, crop_size=128), tc.CameraIntrinsics(),
                             backbone_stages=V2_TINY, yolo_width=0.25, device="cpu")
    pipe = FusedPipeline(hpe=hpe, device="cpu")
    nets = pipe._params()
    assert pipe.config.param_dtype == "bfloat16" and pipe.config.focus.compute_dtype == "bfloat16"
    assert nets["focus"] is pipe.focus.nets
    for net in nets["focus"].values():
        assert all(p.dtype == torch.float32 for p in net.parameters())
    assert nets["focus"]["gaze_net"].ResNet_0.dtype == torch.bfloat16
    assert nets["hpe"]["bbone"].stem_conv.weight.dtype == torch.bfloat16
