"""The Hopenet head-pose path of the port (``models/gaze.py::HopeNet``,
``focus/head_pose.py::HeadPoseDetector``) against the JAX package's on the
CPU, from JAX's init.

Read on an x86 CPU: HopeNet in float32 at a 64 crop (random BatchNorm
statistics) 2.3e-5 degrees, held at 1e-4; the detector in float32 (the
``focus-ci`` face detector, HopeNet from JAX's init) box 4.6e-5 px, score 0
and angles 1.9e-5 degrees, held at 2e-4 px, 1e-6 and 1e-4; the crop
bit-equal to the one JAX's jitted program computes from the same box. bf16
is held stage by stage (``tests/torch_focus_alt_parity.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.focus import head_pose as jhp
from isbfsar_tpu.models import gaze as jg
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.focus import head_pose as thp
from isbfsar_tpu_torch.focus.detector import resize_linear
from isbfsar_tpu_torch.models.gaze import BlazeFaceLite, HopeNet
from isbfsar_tpu_torch.ops.image import square_box_crop_gather
from isbfsar_tpu_torch.weights import convert_head_pose, convert_variables
from tests import torch_focus_alt_parity as A

torch.set_num_threads(2)

TOL_ANGLES, TOL_BOX_PX, TOL_SCORE = 1e-4, 2e-4, 1e-6
CROP = 64
F32 = jc.FocusConfig(compute_dtype="float32")


def test_hopenet_matches_jax():
    jnet = jg.HopeNet(dtype=jnp.float32)
    x = np.random.default_rng(0).uniform(0, 1, (2, CROP, CROP, 3)).astype(np.float32)
    variables = A.perturbed(jax.jit(jnet.init)(jax.random.key(3), x), 2)
    want = np.asarray(jax.jit(jnet.apply)(variables, x))
    net = HopeNet(torch.float32)
    net.load_state_dict(convert_variables(variables), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 3) and np.abs(got - want).max() <= TOL_ANGLES
    assert (np.abs(got) <= 99.0).all()  # the 66-bin decode's range


@pytest.fixture(scope="module")
def pose_runs():
    """JAX's detector from the trained ``focus-ci`` face detector (random
    weights leave no face's best anchor clear of bf16's noise) and HopeNet
    from JAX's init, in float32 with its crops read from inside the program,
    the same without the spy, and in bf16; the port from the same params."""
    init = jax.tree.map(np.asarray, jhp.HeadPoseDetector(crop_size=CROP).params)
    face = jax.tree.map(lambda t: t.numpy(), weights.load_bundle("focus-ci")["face_det"])
    params = {"face_det": face, "hopenet": init["hopenet"]}
    j16 = jhp.HeadPoseDetector(crop_size=CROP, params=params)
    frames = A.frames()
    run = lambda det: [[np.asarray(a) for a in det._forward(det.params, jnp.asarray(f))]  # noqa
                       for f in frames]
    with A.jax_crops() as seen:
        out32 = run(jhp.HeadPoseDetector(F32, params=params, crop_size=CROP))
    port = {dt: thp.HeadPoseDetector(tc.FocusConfig(compute_dtype=dt), params=params,
                                     crop_size=CROP, device="cpu")
            for dt in ("float32", "bfloat16")}
    return {"frames": frames, "params": params, "jax32": out32, "crops": list(seen),
            "plain32": run(jhp.HeadPoseDetector(F32, params=params, crop_size=CROP)),
            "jax16": run(j16),
            "port": {dt: [p._forward_impl(torch.from_numpy(f)) for f in frames]
                     for dt, p in port.items()}}


def test_spy_leaves_jax_outputs_unchanged(pose_runs):
    for a, b in zip(pose_runs["jax32"], pose_runs["plain32"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_crop_in_jax_program_equals_port_crop_from_same_box(pose_runs):
    for f, (box, _, _), (crop, cbox) in zip(pose_runs["frames"], pose_runs["jax32"],
                                            pose_runs["crops"]):
        assert np.array_equal(cbox, box)
        got = square_box_crop_gather(torch.from_numpy(f), torch.from_numpy(cbox.copy()), CROP)
        assert np.array_equal(got.numpy(), crop)


def test_head_pose_detector_float32_matches_jax(pose_runs):
    for (box, score, angles), out, (crop, _) in zip(pose_runs["jax32"],
                                                    pose_runs["port"]["float32"],
                                                    pose_runs["crops"]):
        assert np.abs(out["box"].numpy() - box).max() <= TOL_BOX_PX
        assert abs(float(out["score"]) - float(score)) <= TOL_SCORE
        assert np.abs(out["angles"].numpy() - angles).max() <= TOL_ANGLES
        assert np.array_equal(out["crop"].numpy(), crop)


@pytest.fixture(scope="module")
def bf16_stages(pose_runs):
    """The face detector on the 128x128 input, and HopeNet on JAX's float32
    crops and random ones (``crop_batch``), in bf16 and float32."""
    params = pose_runs["params"]
    nets = {dt: (jg.BlazeFaceLite(dtype=dt), jg.HopeNet(dtype=dt))
            for dt in (jnp.float32, jnp.bfloat16)}
    sds = convert_head_pose(params)
    face, hope = BlazeFaceLite(torch.bfloat16), HopeNet(torch.bfloat16)
    face.load_state_dict(sds["face_det"], strict=True)
    hope.load_state_dict(sds["hopenet"], strict=True)
    out = {k: [] for k in ("j32", "j16", "p16")}
    for f in pose_runs["frames"]:
        x = (jax.image.resize(jnp.asarray(f, jnp.float32), (128, 128, 3), "linear")[..., ::-1]
             / 255.0)[None]
        for key, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
            boxes, _, scores = nets[dt][0].apply(params["face_det"], x)
            out[key].append([np.asarray(boxes), np.asarray(scores)])
        tx = resize_linear(torch.from_numpy(f)[None], 128, 128).flip(-1) / 255.0
        with torch.no_grad():
            out["p16"].append([a.numpy() for a in face(tx.permute(0, 3, 1, 2))[::2]])
    c = A.crop_batch([crop for crop, _ in pose_runs["crops"]])
    for key, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
        out[key + "_crops"] = [np.asarray(nets[dt][1].apply(params["hopenet"], c))]
    with torch.no_grad():
        out["p16_crops"] = [hope(torch.from_numpy(c).permute(0, 3, 1, 2)).numpy()]
    return out


@pytest.mark.parametrize("stage", ["boxes", "scores", "angles"])
def test_bf16_stages_within_jax_bf16_error(bf16_stages, stage):
    if stage == "angles":
        A.check_bf16(*(bf16_stages[k + "_crops"] for k in ("p16", "j16", "j32")), stage)
        return
    i = ("boxes", "scores").index(stage)
    A.check_bf16(*([o[i] for o in bf16_stages[k]] for k in ("p16", "j16", "j32")), stage)


def test_bf16_decisions_match_jax_float32(pose_runs, bf16_stages):
    """End to end in bf16 against JAX's float32: the best face's score
    within 1.5 times JAX's bf16 score error (over every anchor) and on
    float32's side of the 0.5 gate wherever it lies farther from it; the
    box within 1.5 times JAX's own end-to-end bf16 box error. The best
    anchor leads its neighbours by 3e-5 to 1e-4 while bf16 moves the scores
    by 3e-2, so bf16 may pick a neighbour in either package (JAX's bf16 does
    on one face frame)."""
    own_score = A.max_err(*([o[1] for o in bf16_stages[k]] for k in ("j16", "j32")))
    port16 = pose_runs["port"]["bfloat16"]
    for p, (_, score, _) in zip(port16, pose_runs["jax32"]):
        assert abs(float(p["score"]) - float(score)) <= A.BF16_RATIO * own_score
        if abs(float(score) - 0.5) > A.BF16_RATIO * own_score:
            assert (float(p["score"]) < 0.5) == (float(score) < 0.5)
    A.check_bf16([p["box"].numpy() for p in port16], [j[0] for j in pose_runs["jax16"]],
                 [j[0] for j in pose_runs["jax32"]], "box")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estimate_matches_jax(pose_runs, dtype):
    """``estimate``: None under a 0.5 score, else bbox and angles."""
    params = pose_runs["params"]
    jdet = jhp.HeadPoseDetector(jc.FocusConfig(compute_dtype=dtype), params=params,
                                crop_size=CROP)
    tdet = thp.HeadPoseDetector(tc.FocusConfig(compute_dtype=dtype), params=params,
                                crop_size=CROP, device="cpu")
    for f in pose_runs["frames"]:
        want, got = jdet.estimate(f), tdet.estimate(f)
        assert (got is None) == (want is None)
        if want is not None:
            assert set(got) == set(want) == {"bbox", "yaw", "pitch", "roll"}
            if dtype == "float32":
                assert max(abs(got[k] - want[k]) for k in ("yaw", "pitch", "roll")) <= TOL_ANGLES


def test_head_pose_detector_contract():
    det = thp.HeadPoseDetector(crop_size=64, device="cpu")
    frame = np.random.default_rng(0).integers(0, 255, (120, 160, 3)).astype(np.uint8)
    res = det.estimate(frame)
    if res is not None:  # random weights may not clear the face gate
        assert set(res) == {"bbox", "yaw", "pitch", "roll"}
        assert -99.0 <= res["yaw"] <= 99.0  # 66-bin decode range
        assert -99.0 <= res["pitch"] <= 99.0


def test_focus_config_mode_is_a_field_only():
    cfg = dataclasses.replace(tc.FocusConfig(), mode="mutual")
    assert repr(cfg) == repr(dataclasses.replace(jc.FocusConfig(), mode="mutual"))
    assert thp.HeadPoseDetector(cfg, crop_size=32, device="cpu").config.mode == "mutual"
