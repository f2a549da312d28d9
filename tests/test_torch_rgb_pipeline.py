"""FusedPipeline in rgb and hybrid mode against the JAX FusedPipeline.

The trained CI operating point (``pose-ci-motions``: 240x320, YOLO width
0.25 at 128, V2_TINY at a 128 crop, float32, the 0.3 gate) on a rendered
motion clip as I420 frames, so that the person boxes are real: tall and
narrow, where a swapped box order would crop other pixels.
rgb is ``PipelineConfig.for_input("rgb")``'s detector-only step
(``just_box``, as JAX's tests/test_pipeline.py::TestFusedRgbJustBox);
hybrid runs the whole pose stack and the ResNet-50. The recognizer is the
JAX init with a 64 crop and seq_len 8, carried across by the weight
bridge, with two support actions of random crops (and poses). Focus is
off (tests/test_torch_pipeline_focus.py runs it; it does not read the
input type).

Per frame and batched (B=4), against JAX's packed vectors and its final
feature ring; the booleans and the box exactly. The step the CUDA graphs
replay, run eagerly on the CPU over its static buffers, against the plain
step, bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.ops.image import bgr_to_i420
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.pipeline import FusedPipeline

torch.set_num_threads(2)

RGB, SEQ, N_FRAMES = 64, 8, 12
EXACT = ("pose_ok", "ar_ready", "bbox")
# This CPU reads, against JAX: conf 0 (the detector is bit-equal here; the
# skeleton tests hold it to 1e-5); rgb probs 3.6e-7, is_true 4.2e-7; hybrid
# pose 2.3e-5 m, pose_abs 3.3e-5 m, distance 4.8e-5 m, probs 1.5e-5, is_true
# 6.9e-7; the feature ring 7.9e-6 (of 1.04). The pose stack's convolutions
# sum in other orders than XLA's, and the skeleton feature carries that
# into hybrid's scores.
TOL = {"conf": 1e-5, "pose": 1e-4, "pose_abs": 3e-4, "distance": 3e-4, "probs": 5e-5,
       "is_true": 2e-6, "window": 3e-5}


def _support(jar, ar, input_type):
    rng = np.random.default_rng(0)
    for i in range(2):
        data = {"imgs": rng.uniform(-2, 2, (SEQ, RGB, RGB, 3)).astype(np.float32)}
        if input_type == "hybrid":
            data["poses"] = rng.normal(size=(SEQ, 90)).astype(np.float32)
        item = {"flag": f"a{i}", "data": data, "requires_focus": False}
        jar.train(item)
        ar.train(item)


@pytest.fixture(scope="module", params=["rgb", "hybrid"])
def stacks(request):
    """Both packages' pipelines in one mode on the same weights, the frames,
    and JAX's outputs: per frame with its final ring, then batched."""
    input_type = request.param
    h, w = CI_FRAME_HW
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    params = pretrained.load("pose-ci-motions")
    hpe_kw = dict(compute_dtype="float32", yolo_input_size=128, crop_size=128,
                  just_box=input_type == "rgb")
    jhpe = JaxEstimator(jc.HPEConfig(**hpe_kw), CI_INTRINSICS, params=params,
                        backbone_stages=JAX_V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25)
    intr = tc.CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0, width=w, height=h)
    thpe = HumanPoseEstimator(tc.HPEConfig(**hpe_kw), intr, params=np_tree(params),
                              backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25,
                              device="cpu")
    jar = JaxRecognizer(dataclasses.replace(jc.ARConfig.for_input(input_type), rgb_size=RGB),
                        seed=0)
    ar = ActionRecognizer(dataclasses.replace(tc.ARConfig.for_input(input_type), rgb_size=RGB),
                          params=np_tree(jar.params), device="cpu")
    _support(jar, ar, input_type)
    jpipe = JaxPipeline(jc.PipelineConfig(
        main=dataclasses.replace(jc.MainConfig.for_input(input_type), cam_width=w, cam_height=h),
        intrinsics=CI_INTRINSICS, hpe=jc.HPEConfig(**hpe_kw), ar=jar.config,
        param_dtype="float32"), hpe=jhpe, ar=jar, with_focus=False, input_format="i420")
    pipe = FusedPipeline(tc.PipelineConfig(
        main=dataclasses.replace(tc.MainConfig.for_input(input_type), cam_width=w, cam_height=h),
        intrinsics=intr, hpe=tc.HPEConfig(**hpe_kw), ar=ar.config, param_dtype="float32"),
        hpe=thpe, ar=ar, with_focus=False, device="cpu")
    clip, _ = render_motion_clip("wave", n_frames=N_FRAMES, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    frames = [bgr_to_i420(f) for f in clip]
    jpipe.start()
    ref = [jpipe.step(f) for f in frames]
    ref_window = np.asarray(jpipe._state.window)
    jpipe.start()
    ref_batched = list(jpipe.stream_batched(frames, 4))
    return pipe, frames, ref, ref_window, ref_batched


def _assert_close(ours, ref, where):
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys()
        for key in b:
            if key in EXACT:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{where} {i} {key}")
            else:
                np.testing.assert_allclose(a[key], b[key], atol=TOL[key], rtol=0,
                                           err_msg=f"{where} {i} {key}")


def test_step_matches_jax(stacks):
    pipe, frames, ref, ref_window, _ = stacks
    pipe.start()
    ours = [pipe.step(f) for f in frames]
    _assert_close(ours, ref, "step")
    np.testing.assert_allclose(pipe._state.window.numpy(), ref_window, atol=TOL["window"], rtol=0)
    assert all(o["pose_ok"] for o in ours) and ours[-1]["ar_ready"] == 1
    boxes = np.array([o["bbox"] for o in ours])  # (x1, x2, y1, y2)
    assert (boxes[:, 3] - boxes[:, 2] > 1.5 * (boxes[:, 1] - boxes[:, 0])).all()  # tall
    if pipe.input_type == "rgb":  # the detector alone: no pose and no smoothing
        assert all(not o["pose"].any() and o["distance"] == 0 for o in ours)
        assert pipe._state.smooth == ()
    else:
        assert all(o["pose"].any() for o in ours)


def test_stream_batched_matches_jax(stacks):
    pipe, frames, _, _, ref_batched = stacks
    pipe.start()
    _assert_close(list(pipe.stream_batched(frames, 4)), ref_batched, "batched")


def test_static_buffer_step_equals_plain_step(stacks):
    """The step the CUDA graphs replay, run eagerly on the CPU over its
    static buffers (``cuda_graphs=True``), against the plain step: single
    frames and a batch of 4, across a ``start()`` after a support edit,
    bit-equal; the buffers (an empty smoothing state in rgb) are written
    in place, never replaced."""
    pipe, frames, _, _, _ = stacks
    static = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, with_focus=False, device="cpu",
                           cuda_graphs=True)
    extra = {"imgs": np.full((SEQ, RGB, RGB, 3), 0.5, np.float32)}
    if pipe.input_type == "hybrid":
        extra["poses"] = np.full((SEQ, 90), 0.1, np.float32)

    def run(p):
        p.start()
        buffers = [id(t) for t in (p._state.window, p._state.n_valid, p._support_kv[0])]
        outs = [p.step(f) for f in frames[:8]]
        outs += [p.layout.unpack(row) for row in p.dispatch_batch(np.stack(frames[8:12])).numpy()]
        p.ar.train({"flag": "a2", "data": extra})
        p.start()
        outs += [p.step(f) for f in frames[:2]]
        assert p.ar.remove("a2")
        same = buffers == [id(t) for t in (p._state.window, p._state.n_valid, p._support_kv[0])]
        return outs, same

    plain, replaced = run(pipe)
    ours, kept = run(static)
    assert kept and not replaced
    assert sorted(static._graphs) == [1, 4]
    assert ours[11]["ar_ready"] == 1 and ours[11]["probs"][2] == 0 and ours[-1]["probs"][2] > 0
    for i, (a, b) in enumerate(zip(ours, plain, strict=True)):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"output {i} {key}")


def test_decode_publishes_no_pose_in_rgb(stacks):
    pipe, frames, _, _, _ = stacks
    pipe.start()
    outs = [pipe.step(f) for f in frames[:SEQ]]
    elements = pipe.decode(outs[-1])
    assert set(elements["actions"]) == {"a0", "a1"}
    x1, x2, y1, y2 = elements["bbox"]
    assert x2 > x1 and y2 > y1 and elements["bbox"] == tuple(int(v) for v in outs[-1]["bbox"])
    published = {"pose", "distance", "edges"} & set(elements)
    assert published == (set() if pipe.input_type == "rgb" else {"pose", "distance", "edges"})
    assert pipe.decode(outs[0])["actions"] == {}
