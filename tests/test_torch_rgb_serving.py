"""The orchestrator's module path in rgb and hybrid mode against the JAX one.

The trained CI operating point (``pose-ci-motions`` at 240x320, float32,
the 0.3 gate; ``focus-ci`` at the CI focus config), rgb with the detector
alone (``just_box``) and hybrid with the whole pose stack; the recognizer
at a 64 crop and seq_len 8, seeded in the port and carried to Flax by the
weight bridge. Both orchestrators learn an action with the ``add``
acquisition on a fake clock over the rendered clip, then serve the clip
and the committed face frames. The JAX module path crops the person on the
host with ``cv2.resize``, the port with its numpy twin
(``ops/image.py::resize_linear_u8``): the crops, the acquired support
clips and the boxes are bit-equal; the poses, scores and face boxes are
held to tests/test_torch_runtime.py's module-path limits.
"""

import dataclasses

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
from isbfsar_tpu.runtime.orchestrator import Orchestrator as JaxOrchestrator
from isbfsar_tpu.train.gazefocus import CI_FOCUS_CFG as JAX_CI_FOCUS_CFG
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.focus.detector import FocusDetector
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.ops.image import i420_to_bgr
from isbfsar_tpu_torch.profile_slice import CI_FOCUS_CFG, focus_frames
from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator

torch.set_num_threads(2)

RGB, SEQ = 64, 8
# tests/test_torch_runtime.py's module-path limits; this CPU reads pose
# 8.3e-7 m, distance 1.9e-6 m, actions 6.0e-8 (scores near 0.5), is_true
# 1.2e-7 and face_bbox 3.1e-5 px.
TOL = {"pose": 1e-5, "distance": 3e-4, "is_true": 2e-6, "actions": 2e-5, "face_bbox": 2e-4}


class FakeClock:
    """Deterministic clock: each call advances 0.25 s."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


class FrameQueue:
    """In-queue stub cycling a fixed frame list."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def get(self):
        self.i += 1
        return {"rgb": self.frames[(self.i - 1) % len(self.frames)], "msg": ""}


class Collector:
    def __init__(self):
        self.items = []

    def put(self, x):
        self.items.append(x)


@pytest.fixture(scope="module")
def shared():
    """The focus detectors (the module path always runs focus), the pose
    weights, the clip and the face frames, shared by both modes."""
    h, w = CI_FRAME_HW
    focus_params = pretrained.load("focus-ci")
    intr = tc.CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0, width=w, height=h)
    clip, _ = render_motion_clip("wave", n_frames=12, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    faces = [torch.round(i420_to_bgr(torch.from_numpy(f), h)).to(torch.uint8).numpy()
             for f in focus_frames(240)["i420"]]
    return {
        "jfocus": JaxFocus(JAX_CI_FOCUS_CFG, CI_INTRINSICS, params=focus_params,
                           frame_shape=CI_FRAME_HW),
        "tfocus": FocusDetector(CI_FOCUS_CFG, intr, params=jax.tree.map(np.asarray, focus_params),
                                frame_shape=CI_FRAME_HW, device="cpu"),
        "pose": pretrained.load("pose-ci-motions"), "intr": intr, "clip": list(clip),
        "served": [f for pair in zip(clip[:5], faces) for f in pair] + list(clip[5:]),
    }


@pytest.fixture(scope="module", params=["rgb", "hybrid"])
def pair(request, shared):
    """The JAX and the port orchestrator in one mode on the same weights,
    queues and clocks."""
    input_type = request.param
    h, w = CI_FRAME_HW
    hpe_kw = dict(compute_dtype="float32", yolo_input_size=128, crop_size=128,
                  just_box=input_type == "rgb")
    main = dict(cam_width=w, cam_height=h, window_size=SEQ)
    jcfg = jc.PipelineConfig(
        main=dataclasses.replace(jc.MainConfig.for_input(input_type), **main),
        intrinsics=CI_INTRINSICS, hpe=jc.HPEConfig(**hpe_kw),
        ar=dataclasses.replace(jc.ARConfig.for_input(input_type), seq_len=SEQ, rgb_size=RGB),
        focus=JAX_CI_FOCUS_CFG, param_dtype="float32")
    tcfg = tc.PipelineConfig(
        main=dataclasses.replace(tc.MainConfig.for_input(input_type), **main),
        intrinsics=shared["intr"], hpe=tc.HPEConfig(**hpe_kw),
        ar=dataclasses.replace(tc.ARConfig.for_input(input_type), seq_len=SEQ, rgb_size=RGB),
        focus=CI_FOCUS_CFG, param_dtype="float32")
    model = init_random(TRXOS(tcfg.ar), torch.Generator().manual_seed(3))
    variables = jax.tree.map(lambda t: t.numpy(), weights.to_flax_variables(model.state_dict()))
    jax_mods = {
        "hpe": JaxEstimator(jcfg.hpe, CI_INTRINSICS, params=shared["pose"],
                            backbone_stages=JAX_V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25),
        "focus": shared["jfocus"], "ar": JaxRecognizer(jcfg.ar, params=variables)}
    port_mods = {
        "hpe": HumanPoseEstimator(tcfg.hpe, shared["intr"],
                                  params=jax.tree.map(np.asarray, shared["pose"]),
                                  backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW,
                                  yolo_width=0.25, device="cpu"),
        "focus": shared["tfocus"],
        "ar": ActionRecognizer(tcfg.ar, params=variables, device="cpu"), "device": "cpu"}
    for d in (shared["jfocus"], shared["tfocus"]):
        d.focuses = []
    return [cls(cfg, in_queue=FrameQueue(shared["clip"]), out_queue=Collector(),
                clock=FakeClock(), **mods)
            for cls, cfg, mods in ((JaxOrchestrator, jcfg, jax_mods),
                                   (Orchestrator, tcfg, port_mods))]


def _same_elements(ours, ref, where):
    assert ours.keys() == ref.keys(), (where, sorted(ours), sorted(ref))
    for key in ref:
        if key in ("img", "edges", "fps"):
            continue
        if key == "actions":
            assert ours[key].keys() == ref[key].keys(), where
            for name in ref[key]:
                np.testing.assert_allclose(ours[key][name], ref[key][name], atol=TOL["actions"],
                                           rtol=0, err_msg=f"{where} {name}")
        elif key in TOL:
            np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                       np.asarray(ref[key], np.float64), atol=TOL[key], rtol=0,
                                       err_msg=f"{where} {key}")
        elif key == "img_preprocessed":
            assert ours[key].dtype == np.float32 and ours[key].shape == (RGB, RGB, 3)
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=f"{where} {key}")
        else:
            assert ours[key] == ref[key], (where, key, ours[key], ref[key])


def test_module_path_add_and_serve_match_jax(pair, shared):
    """The ``add`` acquisition (countdown, then seq_len frames with a crop,
    and in hybrid a pose), then the clip and the face frames served: every
    published elements dict, the support set and the log line as JAX's."""
    jorch, orch = pair
    logs = [o.learn_command(["act", "-focus"]) for o in pair]
    assert logs[0] == logs[1] == "Action act learned successfully!"
    for m in orch.ar.modalities:
        want = jorch.ar.support_data[m]
        if m == "rgb":
            np.testing.assert_array_equal(orch.ar.support_data[m], want)
        else:
            np.testing.assert_allclose(orch.ar.support_data[m], want, atol=TOL["pose"], rtol=0)
    # a second class, the acquired clip played backwards, so that the
    # scores are a softmax over two comparable matches
    keys = {"rgb": "imgs", "sk": "poses"}
    backwards = {keys[m]: jorch.ar.support_data[m][0, ::-1].copy() for m in orch.ar.modalities}
    for o in pair:
        o.ar.train({"flag": "backwards", "data": backwards})
    for img in shared["served"]:
        for o in pair:
            o.get_frame(img=img)
    ref, ours = jorch._out_queue.items, orch._out_queue.items
    assert len(ours) == len(ref) > len(shared["served"])
    for i, (a, b) in enumerate(zip(ours, ref)):
        _same_elements(a, b, f"elements {i}")
    served = ours[-len(shared["served"]):]
    assert any(set(e["actions"]) == {"act", "backwards"} for e in served) and any("focus" in e for e in served)
    assert all(("pose" in e) == (orch.input_type == "hybrid") for e in served if "bbox" in e)
    assert orch.ar.requires_focus == {"act": True, "backwards": False}
