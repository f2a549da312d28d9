"""The whole slice of the PyTorch port against the JAX FusedPipeline.

I420 frame -> pose -> TRX match, skeleton mode, focus off (passed
explicitly; tests/test_torch_pipeline_focus.py runs focus), on the CPU in
float32. The same weights (JAX-initialized or the trained ``pose-ci-motions``
bundle, carried across with the weight bridge) and the same frames go
through both pipelines; their packed vectors are compared field by field,
booleans exactly, the way tests/test_pallas_input.py compares two input
stages.
"""

import numpy as np
import jax
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.ops.image import bgr_to_i420
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.runtime.source import SyntheticSource
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.pipeline import FusedPipeline

BOOLEANS = ("pose_ok", "ar_ready")
# float32 in both frameworks. The homography, and so the crop, is bit-equal
# to XLA's (ops/geometry.py); what is left is the convolutions' summation
# order: tests/torch_parity_report.py reads 1.4e-5 m in pose, 5.4e-5 m in
# pose_abs, 3.6e-5 m in distance, 3.2e-6 in probs and 2.4e-7 in is_true on
# the trained stack. The limits are a few times that, inside the
# reference's 1 mm keypoint budget.
TOL = {"pose": 1e-4, "pose_abs": 3e-4, "distance": 3e-4, "conf": 1e-5, "bbox": 0.0,
       "probs": 2e-5, "is_true": 2e-6}


def _support(jar, ar):
    rng = np.random.default_rng(0)
    for i in range(2):
        item = {"flag": f"a{i}", "data": {"poses": rng.normal(size=(16, 90)).astype(np.float32)},
                "requires_focus": False}
        jar.train(item)
        ar.train(item)


def _build(hw, jax_intr, hpe_kw, params, stages_yolo):
    """JAX and port pipelines on the same weights."""
    jstages, tstages, width = stages_yolo
    h, w = hw
    intr = tc.CameraIntrinsics(fx=jax_intr.fx, fy=jax_intr.fy, ppx=jax_intr.ppx, ppy=jax_intr.ppy,
                               width=jax_intr.width, height=jax_intr.height)
    jhpe_cfg = jc.HPEConfig(compute_dtype="float32", **hpe_kw)
    thpe_cfg = tc.HPEConfig(compute_dtype="float32", **hpe_kw)
    jhpe = JaxEstimator(jhpe_cfg, jax_intr, params=params, backbone_stages=jstages,
                        frame_shape=hw, yolo_width=width)
    thpe = HumanPoseEstimator(thpe_cfg, intr, params=jax.tree.map(np.asarray, jhpe.params),
                              backbone_stages=tstages, frame_shape=hw, yolo_width=width, device="cpu")
    jar = JaxRecognizer(jc.ARConfig.for_input("skeleton"), seed=0)
    ar = ActionRecognizer(tc.ARConfig.for_input("skeleton"),
                          params=jax.tree.map(np.asarray, jar.params), device="cpu")
    _support(jar, ar)
    jpipe = JaxPipeline(jc.PipelineConfig(main=jc.MainConfig(cam_width=w, cam_height=h),
                                          intrinsics=jax_intr, hpe=jhpe_cfg, param_dtype="float32"),
                        hpe=jhpe, ar=jar, with_focus=False, input_format="i420")
    pipe = FusedPipeline(tc.PipelineConfig(main=tc.MainConfig(cam_width=w, cam_height=h),
                                           intrinsics=intr, hpe=thpe_cfg, param_dtype="float32"),
                         hpe=thpe, ar=ar, with_focus=False, device="cpu")
    return jpipe, pipe


def _assert_close(ours, ref, tol):
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys()
        for key in b:
            if key in BOOLEANS:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"frame {i} {key}")
            else:
                np.testing.assert_allclose(a[key], b[key], atol=tol[key], rtol=0,
                                           err_msg=f"frame {i} {key}")


@pytest.fixture(scope="module")
def trained_ci():
    """The trained CI operating point on rendered humanoids (detections fire
    at the 0.3 gate, so every stage of the slice sees real data)."""
    jpipe, pipe = _build(CI_FRAME_HW, CI_INTRINSICS, dict(yolo_input_size=128, crop_size=128),
                         pretrained.load("pose-ci-motions"), (JAX_V2_TINY, V2_TINY, 0.25))
    clip, _ = render_motion_clip("wave", n_frames=20, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    frames = [bgr_to_i420(f) for f in clip]
    jpipe.start()
    ref = [jpipe.step(f) for f in frames]
    jpipe.start()
    ref_batched = list(jpipe.stream_batched(frames, 8))
    return pipe, frames, ref, ref_batched


def test_step_matches_jax_on_trained_ci_stack(trained_ci):
    pipe, frames, ref, _ = trained_ci
    pipe.start()
    ours = [pipe.step(f) for f in frames]
    _assert_close(ours, ref, TOL)
    assert all(o["pose_ok"] for o in ours) and ours[-1]["ar_ready"] == 1


def test_stream_batched_matches_jax_on_trained_ci_stack(trained_ci):
    pipe, frames, _, ref_batched = trained_ci
    pipe.start()
    ours = list(pipe.stream_batched(frames, 8))  # two batches of 8 and a tail of 4
    _assert_close(ours, ref_batched, TOL)


def test_batched_equals_sequential(trained_ci):
    pipe, frames, _, _ = trained_ci
    pipe.start()
    seq = [pipe.step(f) for f in frames]
    pipe.start()
    batched = list(pipe.stream_batched(frames, 8))
    # same code and the same recurrence; only the batch size of the convs differs
    _assert_close(batched, seq, {k: 1e-5 for k in TOL})


def test_static_buffer_step_equals_plain_step(trained_ci):
    """The step the CUDA graphs replay, run eagerly on the CPU over its
    static buffers (``cuda_graphs=True``), against the plain step: 18
    frames at batch sizes 1 and 4, across a ``start()`` after a support
    edit, bit-equal. The buffers are written in place, never replaced."""
    pipe, frames, _, _ = trained_ci
    static = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, with_focus=False, device="cpu",
                           cuda_graphs=True)
    assert not pipe.cuda_graphs and static.cuda_graphs

    def run(p):
        p.start()
        buffers = [id(t) for t in (p._state.window, p._state.n_valid, p._support_kv[0],
                                   p._support_mask)]
        outs = [p.step(f) for f in frames[:12]]
        outs += [p.layout.unpack(row) for row in p.dispatch_batch(np.stack(frames[12:16])).numpy()]
        p.ar.train({"flag": "a2", "data": {"poses": np.full((16, 90), 0.1, np.float32)}})
        p.start()
        outs += [p.step(f) for f in frames[16:18]]
        assert p.ar.remove("a2")
        same = buffers == [id(t) for t in (p._state.window, p._state.n_valid, p._support_kv[0],
                                           p._support_mask)]
        return outs, same

    plain, replaced = run(pipe)
    ours, kept = run(static)
    assert kept and not replaced
    assert sorted(static._graphs) == [1, 4] and all(g.graph is None for g in static._graphs.values())
    assert ours[15]["ar_ready"] == 1 and ours[15]["probs"][2] == 0
    assert ours[-1]["ar_ready"] == 0 and ours[-1]["probs"][2] > 0
    _assert_close(ours, plain, {k: 0.0 for k in TOL})


def test_random_ci_sizes_match_jax():
    """CI sizes of tests/test_pallas_input.py: 120x160 frames, S=128, crop
    256, JAX-initialized random weights at gate 0.0. Random weights collapse
    the 32 joints onto one point, which leaves the least-squares reference
    point ill-conditioned: the absolute position (pose_abs, distance) is
    held to 5 cm / 15 cm, the root-relative pose and all else tightly."""
    jpipe, pipe = _build((120, 160), jc.CameraIntrinsics(width=160, height=120),
                         dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.0), None,
                         (JAX_V2_TINY, V2_TINY, 0.25))
    src = SyntheticSource(160, 120)
    frames = [bgr_to_i420(src.read()[1]) for _ in range(18)]
    jpipe.start()
    pipe.start()
    ref = [jpipe.step(f) for f in frames]
    ours = [pipe.step(f) for f in frames]
    _assert_close(ours, ref, {**TOL, "pose": 1e-4, "pose_abs": 5e-2, "distance": 1.5e-1})


def test_decode_and_support_edits(trained_ci):
    pipe, frames, _, _ = trained_ci
    pipe.start()
    outs = [pipe.step(f) for f in frames[:16]]
    elements = pipe.decode(outs[-1])
    assert set(elements["actions"]) == {"a0", "a1"}
    assert elements["bbox"] == tuple(int(v) for v in outs[-1]["bbox"])
    assert elements["pose"].shape == (30, 3) and elements["edges"].shape == (29, 2)
    np.testing.assert_allclose(sum(elements["actions"].values()), 1.0, rtol=1e-5)

    assert pipe.ar.remove("a0") and not pipe.ar.remove("a0")
    pipe.start()
    outs = [pipe.step(f) for f in frames[:16]]
    assert set(pipe.decode(outs[-1])["actions"]) == {"a1"}
    assert outs[-1]["probs"][0] == 0.0
    pipe.ar.train({"flag": "a0", "data": {"poses": np.zeros((16, 90), np.float32)}})
    assert pipe.ar.class_order[:2] == ["a0", "a1"] and pipe.ar.n_classes == 2
    early = pipe.decode(outs[0])
    assert early["actions"] == {} and early["is_true"] == 0


def test_trunk_cast_matches_jax_policy():
    """param_dtype="bfloat16": the same leaves as JAX's _cast_trunk_params
    are rounded to bf16 (YOLO and EfficientNetV2 weights, not the YOLO
    head*_out layers, the BatchNorm statistics or the MetrABS head)."""
    from isbfsar_tpu.pipeline import _cast_trunk_params as jax_cast
    from isbfsar_tpu_torch import weights
    from isbfsar_tpu_torch.pipeline import _cast_trunk_params

    params = pretrained.load("pose-ci-motions")
    ref = jax.tree.map(np.asarray, jax_cast({"hpe": params, "ar": {}}, jax.numpy.bfloat16)["hpe"])
    ours = HumanPoseEstimator(tc.HPEConfig(yolo_input_size=128, crop_size=128), tc.CameraIntrinsics(),
                              params=params, backbone_stages=V2_TINY, yolo_width=0.25, device="cpu")
    cast = _cast_trunk_params(ours.nets, torch.bfloat16)
    n_bf16 = 0
    for name in ("yolo", "bbone", "head"):
        want = weights.convert_variables(ref[name])
        got = cast[name].state_dict()
        assert want.keys() == got.keys()
        for key, w in want.items():
            g = got[key]
            np.testing.assert_array_equal(g.float().numpy(), w.float().numpy(), err_msg=key)
            is_bn_affine = key.rsplit(".", 1)[-1] in ("scale", "bias") and "bn" in key.rsplit(".", 2)[-2]
            expect = torch.float32 if is_bn_affine else w.dtype
            assert g.dtype == expect, (name, key, g.dtype, w.dtype)
            n_bf16 += w.dtype == torch.bfloat16
    assert n_bf16 > 100
    assert ours.nets["yolo"].head1_out.conv.weight.dtype == torch.float32  # originals untouched
    assert cast["yolo"].head1_out.conv.weight.dtype == torch.float32
    assert cast["yolo"].backbone.stage1.down.conv.weight.dtype == torch.bfloat16
    assert cast["bbone"].stem_bn.mean.dtype == torch.float32
