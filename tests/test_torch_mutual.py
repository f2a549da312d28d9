"""The mutual-gaze focus path of the port (``focus/mutual.py``, the head
crop of ``ops/image.py`` and the linear resize of ``focus/detector.py``)
against the JAX package's on the CPU, from JAX's init.

Read on an x86 CPU (``tests/torch_focus_alt_parity.py`` says how the bf16
runs are held): the linear resize 6.1e-5, 4.6e-5 and 1.5e-5 (of 255) at
480x640 -> 256, 480x640 -> 128 and 120x160 -> 128, held at 2e-4; the crop
bit-equal to the one JAX's jitted program computes from the same box, and
to JAX's eager function on boxes across the frame and past its edges; in
float32 the box 3.1e-5 px, the score 3.6e-7 and ``watching`` 6e-8, held at
2e-4 px, 1e-6 and 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.focus import mutual as jm
from isbfsar_tpu.models import detection as jdm
from isbfsar_tpu.models import resnet as jr
from isbfsar_tpu.ops.image import square_box_crop_gather as jax_crop
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.focus import mutual as tm
from isbfsar_tpu_torch.focus.detector import resize_linear
from isbfsar_tpu_torch.models.resnet import BasicBlock
from isbfsar_tpu_torch.ops.image import square_box_crop_gather
from tests import torch_focus_alt_parity as A

torch.set_num_threads(2)

TOL_RESIZE = 2e-4
TOL_BOX_PX, TOL_SCORE, TOL_WATCHING = 2e-4, 1e-6, 1e-6
CROP = 64


@pytest.mark.parametrize("hw,size", [((480, 640), 256), ((480, 640), 128), ((120, 160), 128)])
def test_resize_linear_matches_jax(hw, size):
    frame = np.random.default_rng(size + hw[0]).integers(0, 256, hw + (3,), np.uint8)
    want = jax.jit(lambda f: jax.image.resize(f.astype(jnp.float32), (size, size, 3),
                                              "linear"))(frame)
    got = resize_linear(torch.from_numpy(frame)[None], size, size)[0].numpy()
    assert np.abs(got - np.asarray(want)).max() <= TOL_RESIZE


def _boxes(rng, h: int, w: int, n: int) -> np.ndarray:
    """Boxes inside the frame, past its edges, tiny (half side under 1
    px) and degenerate (x2 < x1)."""
    xy = rng.uniform(-0.2, 1.0, (n, 2)) * [w, h]
    wh = rng.uniform(0.0, 0.6, (n, 2)) * [w, h]
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[0] = [10.3, 20.7, 10.9, 21.1]
    boxes[1] = [50.0, 40.0, 30.0, 35.0]
    boxes[2] = [-40.0, -30.0, w + 25.5, h + 12.25]
    return boxes.astype(np.float32)


@pytest.mark.parametrize("size", [32, 64, 224])
def test_square_box_crop_matches_jax_eager(size):
    rng = np.random.default_rng(size)
    frame = rng.integers(0, 256, (120, 160, 3), np.uint8)
    for box in _boxes(rng, 120, 160, 24):
        want = np.asarray(jax_crop(jnp.asarray(frame), tuple(jnp.asarray(box)), size))
        got = square_box_crop_gather(torch.from_numpy(frame), torch.from_numpy(box), size)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want), box


@pytest.fixture(scope="module")
def mutual_runs():
    """JAX's detector (seed 0) in float32 (its nets swapped before the first
    trace) with its crops read from inside the program, the same without the
    spy, and in bf16; the port from the same params in float32 and bf16."""
    cfg = jc.MutualGazeConfig(crop_size=CROP, score_thr=0.0)
    j16 = jm.MutualGazeDetector(cfg)
    params = jax.tree.map(np.asarray, j16.params)

    def jax32():
        det = jm.MutualGazeDetector(cfg, params=params)
        det.detector_net = jdm.HeadDetectorNet(dtype=jnp.float32)
        det.backbone = jr.resnet18(dtype=jnp.float32)
        return det

    frames = A.frames()
    run = lambda det: [[np.asarray(a) for a in det._forward(det.params, jnp.asarray(f))]  # noqa
                       for f in frames]
    with A.jax_crops() as seen:
        spied = jax32()
        out32 = run(spied)
    tcfg = tc.MutualGazeConfig(crop_size=CROP, score_thr=0.0)
    port = {dt: tm.MutualGazeDetector(tcfg, params=params, device="cpu", dtype=getattr(torch, dt))
            for dt in ("float32", "bfloat16")}
    return {"frames": frames, "params": params, "jax32": out32, "crops": list(seen),
            "plain32": run(jax32()), "jax16": run(j16), "spied": spied,
            "port": {dt: [p._forward_impl(torch.from_numpy(f)) for f in frames]
                     for dt, p in port.items()}}


def test_spy_leaves_jax_outputs_unchanged(mutual_runs):
    for a, b in zip(mutual_runs["jax32"], mutual_runs["plain32"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len(mutual_runs["crops"]) == len(mutual_runs["frames"])


def test_crop_in_jax_program_equals_port_crop_from_same_box(mutual_runs):
    for f, (box, _, _), (crop, cbox) in zip(mutual_runs["frames"], mutual_runs["jax32"],
                                            mutual_runs["crops"]):
        assert np.array_equal(cbox, box)
        got = square_box_crop_gather(torch.from_numpy(f), torch.from_numpy(cbox.copy()), CROP)
        assert np.array_equal(got.numpy(), crop)


def test_mutual_gaze_detector_float32_matches_jax(mutual_runs):
    for (box, score, watching), out, (crop, _) in zip(
            mutual_runs["jax32"], mutual_runs["port"]["float32"], mutual_runs["crops"]):
        assert np.abs(out["box"].numpy() - box).max() <= TOL_BOX_PX
        assert abs(float(out["score"]) - float(score)) <= TOL_SCORE
        assert abs(float(out["watching"]) - float(watching)) <= TOL_WATCHING
        # the box agrees to 1e-4 px: no sample point crosses a pixel here
        assert np.array_equal(out["crop"].numpy(), crop)


@pytest.fixture(scope="module")
def bf16_stages(mutual_runs):
    """Each stage in bf16 and float32 on the same input: the detector net on
    the frame resized to 256 (every anchor's box and score), and the backbone
    and classifier on JAX's float32 crops and random ones (``crop_batch``)."""
    params = mutual_runs["params"]
    nets = {dt: (jdm.HeadDetectorNet(dtype=dt), jr.resnet18(dtype=dt), jdm.BinaryGazeClassifier())
            for dt in (jnp.float32, jnp.bfloat16)}
    port = tm.MutualGazeDetector(tc.MutualGazeConfig(crop_size=CROP), params=params,
                                 device="cpu").nets
    out = {k: [] for k in ("j32", "j16", "p16")}
    for f in mutual_runs["frames"]:
        x = (jax.image.resize(jnp.asarray(f, jnp.float32), (256, 256, 3), "linear")[..., ::-1]
             / 255.0)[None]
        for key, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
            out[key].append([np.asarray(a) for a in nets[dt][0].apply(params["detector"], x)])
        tx = resize_linear(torch.from_numpy(f)[None], 256, 256).flip(-1) / 255.0
        with torch.no_grad():
            out["p16"].append([a.numpy() for a in port["detector"](tx.permute(0, 3, 1, 2))])
    c = A.crop_batch([crop for crop, _ in mutual_runs["crops"]])
    for key, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
        _, bb, cls = nets[dt]
        out[key + "_crops"] = [np.asarray(cls.apply(params["classifier"],
                                                    bb.apply(params["backbone"], c)))]
    with torch.no_grad():
        out["p16_crops"] = [port["classifier"](port["backbone"](
            torch.from_numpy(c).permute(0, 3, 1, 2))).numpy()]
    return out


@pytest.mark.parametrize("stage", ["boxes", "scores", "watching"])
def test_bf16_stages_within_jax_bf16_error(bf16_stages, stage):
    if stage == "watching":
        A.check_bf16(*(bf16_stages[k + "_crops"] for k in ("p16", "j16", "j32")), stage)
        return
    i = ("boxes", "scores").index(stage)
    A.check_bf16(*([o[i] for o in bf16_stages[k]] for k in ("p16", "j16", "j32")), stage)


def test_bf16_decisions_match_jax_float32(mutual_runs, bf16_stages):
    """End to end in bf16: the best score within 1.5 times JAX's bf16 score
    error; the best anchor's box at JAX's float32 one wherever float32's lead
    over the runner-up exceeds twice that error; ``watching`` on JAX's
    float32 side of 0.5 wherever it lies farther from it than 1.5 times
    JAX's own end-to-end bf16 error."""
    own_score = A.max_err(*([o[1] for o in bf16_stages[k]] for k in ("j16", "j32")))
    own_box = A.max_err(*([o[0] for o in bf16_stages[k]] for k in ("j16", "j32")))
    own_watch = A.max_err(*([j[2] for j in mutual_runs[k]] for k in ("jax16", "jax32")))
    decided = 0
    for f, p, net32, (box, score, watching) in zip(
            mutual_runs["frames"], mutual_runs["port"]["bfloat16"], bf16_stages["j32"],
            mutual_runs["jax32"]):
        assert abs(float(p["score"]) - float(score)) <= A.BF16_RATIO * own_score
        if A.top2_margin(net32[1]) > 2 * own_score:
            decided += 1
            scale = np.asarray(f.shape[1::-1] * 2, np.float32)  # (w, h, w, h)
            assert np.abs(p["box"].numpy() - box).max() <= A.BF16_RATIO * own_box * scale.max()
        if abs(float(watching) - 0.5) > A.BF16_RATIO * own_watch:
            assert (float(p["watching"]) > 0.5) == (float(watching) > 0.5)
    assert decided >= 1


def test_estimate_matches_jax_at_the_gate(mutual_runs):
    """``estimate``: None under score_thr, else (watching, box), as JAX's."""
    params = mutual_runs["params"]
    for thr in (0.0, 0.8, 0.99):
        jdet = jm.MutualGazeDetector(jc.MutualGazeConfig(crop_size=CROP, score_thr=thr),
                                     params=params)
        jdet.detector_net = jdm.HeadDetectorNet(dtype=jnp.float32)
        jdet.backbone = jr.resnet18(dtype=jnp.float32)
        tdet = tm.MutualGazeDetector(tc.MutualGazeConfig(crop_size=CROP, score_thr=thr),
                                     params=params, device="cpu", dtype=torch.float32)
        for f, (_, score, watching) in zip(mutual_runs["frames"], mutual_runs["jax32"]):
            want, got = jdet.estimate(f), tdet.estimate(f)
            assert (got is None) == (want is None)
            if want is not None:
                assert got[0] == want[0] and np.abs(got[1] - want[1]).max() <= TOL_BOX_PX


@pytest.mark.parametrize("size", [128, 100])
def test_head_detector_matches_jax(size):
    cfg = jc.MutualGazeConfig()
    jdet = jm.HeadDetector(cfg, input_size=size)
    params = jax.tree.map(np.asarray, jdet.params)
    jdet.net = jdm.HeadDetectorNet(dtype=jnp.float32)
    tdet = tm.HeadDetector(tc.MutualGazeConfig(), params=params, input_size=size, device="cpu",
                           dtype=torch.float32)
    for f in A.frames():
        box, score = (np.asarray(a) for a in jdet._forward(jdet.params, jnp.asarray(f)))
        out = tdet._forward_impl(torch.from_numpy(f))
        assert np.abs(out["box"].numpy() - box).max() <= TOL_BOX_PX
        assert abs(float(out["score"]) - float(score)) <= TOL_SCORE
        assert (tdet.estimate(f) is None) == (jdet.estimate(f) is None)


# ----------------------------------------------- JAX's contract tests, ported


def test_head_detector_contract():
    det = tm.HeadDetector(tc.MutualGazeConfig(), input_size=128, device="cpu")
    frame = np.random.default_rng(0).integers(0, 255, (120, 160, 3)).astype(np.uint8)
    res = det.estimate(frame)
    if res is not None:
        box, score = res
        assert box.shape == (4,)
        assert 0.0 <= score <= 1.0


def test_mutual_gaze_contract():
    cfg = dataclasses.replace(tc.MutualGazeConfig(), score_thr=0.0, crop_size=64)
    det = tm.MutualGazeDetector(cfg, device="cpu")
    frame = np.random.default_rng(0).integers(0, 255, (120, 160, 3)).astype(np.uint8)
    res = det.estimate(frame)
    assert res is not None  # thresh 0 always yields the top head
    watching, box = res
    assert isinstance(watching, bool)
    assert box.shape == (4,)


@pytest.mark.parametrize("backbone,width", [("resnet18", 512), ("mobilenet", 512),
                                            ("resnet50", 2048)])
def test_backbone_choice(backbone, width):
    """"mobilenet" maps to ResNet-18, as in JAX; the classifier takes its width."""
    det = tm.MutualGazeDetector(tc.MutualGazeConfig(backbone=backbone, crop_size=32),
                                device="cpu")
    assert det.nets["classifier"].fc1.in_features == width
    is_basic = isinstance(det.nets["backbone"].layer1_0, BasicBlock)
    assert is_basic == (backbone != "resnet50")


def test_config_defaults_match_jax():
    assert repr(tc.MutualGazeConfig()) == repr(jc.MutualGazeConfig())
    assert repr(tc.FocusConfig()) == repr(jc.FocusConfig())
    assert tc.FocusConfig().mode == "gaze" and tc.FocusConfig().checkpoint_dir is None


@pytest.mark.slow
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_mutual_gaze_detector_full_width_float32_matches_jax(backbone):
    """MutualGazeConfig()'s sizes (detector at 256, a 224 crop) on 480x640
    frames, float32 in both packages."""
    from isbfsar_tpu_torch.profile_slice import focus_frames, smoke_frames
    from isbfsar_tpu_torch.ops.image import i420_to_bgr

    yuv = smoke_frames()[:1] + focus_frames(480)["i420"][:1]
    frames = [np.clip(np.rint(i420_to_bgr(torch.from_numpy(y.copy()), 480).numpy()), 0, 255
                      ).astype(np.uint8) for y in yuv]
    cfg = jc.MutualGazeConfig(backbone=backbone, score_thr=0.0)
    jdet = jm.MutualGazeDetector(cfg)
    params = jax.tree.map(np.asarray, jdet.params)
    jdet.detector_net = jdm.HeadDetectorNet(dtype=jnp.float32)
    jdet.backbone = (jr.resnet50 if backbone == "resnet50" else jr.resnet18)(dtype=jnp.float32)
    tdet = tm.MutualGazeDetector(tc.MutualGazeConfig(backbone=backbone, score_thr=0.0),
                                 params=params, device="cpu", dtype=torch.float32)
    for f in frames:
        box, score, watching = (np.asarray(a) for a in jdet._forward(jdet.params, jnp.asarray(f)))
        out = tdet._forward_impl(torch.from_numpy(f))
        assert np.abs(out["box"].numpy() - box).max() <= TOL_BOX_PX * 4  # 640 px, not 160
        assert abs(float(out["score"]) - float(score)) <= TOL_SCORE
        assert abs(float(out["watching"]) - float(watching)) <= TOL_WATCHING
