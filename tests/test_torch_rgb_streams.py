"""Multi-stream serving in rgb mode against the JAX MultiStreamPipeline, and
the serve CLI's rgb and hybrid builds.

``MultiStreamPipeline`` with two streams of the detector-only rgb step
(120x160 BGR frames, random JAX-initialized pose weights at gate 0.0,
V2_TINY, a 64 crop, focus off, float32 on the CPU): every stream's packed
fields against the JAX one's (a mesh of two CPU devices), per tick and
micro-batched, with the limits of tests/test_torch_serving.py; the streams
carry no smoothing state. Then ``serve.build`` for ``--input-type rgb
--device cpu`` at full width (640x480, YOLOv4 at 256, the ResNet-50 at 224)
on the module path, and its refusal of ``--fused`` outside skeleton mode,
as the JAX CLI asserts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.runtime.source import SyntheticSource
from isbfsar_tpu.serving import MultiStreamPipeline as JaxMultiStream
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.pipeline import FusedPipeline
from isbfsar_tpu_torch.runtime import serve
from isbfsar_tpu_torch.serving import MultiStreamPipeline

torch.set_num_threads(2)

FRAME_SHAPE = (120, 160)
S, RGB, SEQ = 2, 64, 8
# tests/test_torch_serving.py's limits against JAX; this CPU reads probs
# 2.9e-6 and is_true 3.9e-7 here, and the detector's fields bit-equal.
TOL_JAX = {"probs": 2e-5, "is_true": 2e-6, "conf": 1e-5}
EXACT = ("pose", "pose_ok", "ar_ready", "bbox")


@pytest.fixture(scope="module")
def pipes():
    """The JAX and the port rgb pipelines on the same weights, two support
    actions each."""
    hpe_kw = dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.0, compute_dtype="float32",
                  just_box=True)
    main = dict(cam_width=FRAME_SHAPE[1], cam_height=FRAME_SHAPE[0])
    jintr = jc.CameraIntrinsics(width=FRAME_SHAPE[1], height=FRAME_SHAPE[0])
    jhpe = JaxEstimator(jc.HPEConfig(**hpe_kw), jintr, backbone_stages=JAX_V2_TINY,
                        frame_shape=FRAME_SHAPE, yolo_width=0.25)
    tar_cfg = dataclasses.replace(tc.ARConfig.for_input("rgb"), rgb_size=RGB)
    model = init_random(TRXOS(tar_cfg), torch.Generator().manual_seed(6))
    variables = jax.tree.map(lambda t: t.numpy(), weights.to_flax_variables(model.state_dict()))
    jar = JaxRecognizer(dataclasses.replace(jc.ARConfig.for_input("rgb"), rgb_size=RGB),
                        params=variables)
    jpipe = JaxPipeline(jc.PipelineConfig(
        main=dataclasses.replace(jc.MainConfig.for_input("rgb"), **main), intrinsics=jintr,
        hpe=jc.HPEConfig(**hpe_kw), ar=jar.config, param_dtype="float32"),
        hpe=jhpe, ar=jar, with_focus=False)

    intr = tc.CameraIntrinsics(width=FRAME_SHAPE[1], height=FRAME_SHAPE[0])
    hpe = HumanPoseEstimator(tc.HPEConfig(**hpe_kw), intr,
                             params=jax.tree.map(np.asarray, jhpe.params),
                             backbone_stages=V2_TINY, frame_shape=FRAME_SHAPE, yolo_width=0.25,
                             device="cpu")
    ar = ActionRecognizer(tar_cfg, params=variables, device="cpu")
    pipe = FusedPipeline(tc.PipelineConfig(
        main=dataclasses.replace(tc.MainConfig.for_input("rgb"), **main), intrinsics=intr,
        hpe=tc.HPEConfig(**hpe_kw), ar=tar_cfg, param_dtype="float32"),
        hpe=hpe, ar=ar, with_focus=False, input_format="bgr", device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        item = {"flag": f"a{i}", "data": {"imgs": rng.uniform(-2, 2, (SEQ, RGB, RGB, 3)).astype(
            np.float32)}, "requires_focus": False}
        jar.train(item)
        ar.train(item)
    return jpipe, pipe


def _ticks(n):
    sources = [SyntheticSource(FRAME_SHAPE[1], FRAME_SHAPE[0]) for _ in range(S)]
    for i, src in enumerate(sources):  # the streams see different phases
        for _ in range(5 * i):
            src.read()
    return [np.stack([src.read()[1] for src in sources]) for _ in range(n)]


def _close(got, want, where):
    for key in want:
        if key in EXACT:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where} {key}")
        elif key in TOL_JAX:
            np.testing.assert_allclose(got[key], want[key], atol=TOL_JAX[key], rtol=0,
                                       err_msg=f"{where} {key}")


def test_multistream_rgb_matches_jax(pipes):
    jpipe, pipe = pipes
    jm = JaxMultiStream(n_streams=S, mesh=make_mesh(S), pipe=jpipe)
    m = MultiStreamPipeline(n_streams=S, pipe=pipe)
    ticks = _ticks(SEQ + 2)
    for x in (jm, m):
        x.start()
    assert m._state.smooth == () and m._state.window.shape == (S, SEQ, 256)
    for i, t in enumerate(ticks):
        ref, got = jm.step(t), m.step(t)
        for s in range(S):
            _close(got[s], ref[s], f"tick {i} stream {s}")
    assert all(o["ar_ready"] == 1 and o["pose_ok"] == 1 for o in got)
    assert not np.array_equal(got[0]["bbox"], got[1]["bbox"])  # the streams see other frames
    for x in (jm, m):
        x.start()
    ref = list(jm.stream_batched(iter(ticks), batch_size=4))
    got = list(m.stream_batched(iter(ticks), batch_size=4))  # two blocks of 4 and two tail ticks
    for i, (g_tick, r_tick) in enumerate(zip(got, ref, strict=True)):
        for s in range(S):
            _close(g_tick[s], r_tick[s], f"batched tick {i} stream {s}")
    assert "pose" not in m.decode(got[-1][0]) and "bbox" in m.decode(got[-1][0])


def test_serve_builds_rgb_and_refuses_fused_outside_skeleton():
    """The rgb build at full width on the CPU: the detector alone, the
    ResNet-50 recognizer at 224 over 8 frames, the module path; then
    ``--fused`` with hybrid is refused."""
    args = serve.parse_args(["--input-type", "rgb", "--device", "cpu", "--weights", "random"])
    orch = serve.build(args)
    assert orch.fused is None and orch.hpe.just_box and orch.ar.modalities == ["rgb"]
    assert orch.config.ar.seq_len == orch.window_size == 8 and orch.config.ar.rgb_size == 224
    assert orch.ar.support_data["rgb"].shape == (5, 8, 224, 224, 3)
    elements = orch.get_frame(img=np.zeros((480, 640, 3), np.uint8))
    assert elements["actions"] == {} and "pose" not in elements
    with pytest.raises(ValueError, match="--fused requires skeleton mode"):
        serve.build(serve.parse_args(["--input-type", "hybrid", "--fused", "--device", "cpu",
                                      "--weights", "random"]))
