"""Nets and the pose estimator of the PyTorch port against JAX, on the CPU.

Parameters are initialized in JAX (or taken from the trained
``pose-ci-motions`` bundle) and carried across with the weight bridge;
both sides compute in float32 at CI sizes (V2_TINY, YOLO width 0.25).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isbfsar_tpu import pretrained
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.configs import ARConfig as JaxARConfig
from isbfsar_tpu.configs import HPEConfig as JaxHPEConfig
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models import effnetv2 as jeff
from isbfsar_tpu.models import trx as jtrx
from isbfsar_tpu.models import yolov4 as jyolo
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models import effnetv2 as teff
from isbfsar_tpu_torch.models import trx as ttrx
from isbfsar_tpu_torch.models import yolov4 as tyolo

T = torch.from_numpy
NP = lambda tree: jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ci_params():
    return pretrained.load("pose-ci-motions")


def test_yolo_matches_jax():
    rng = np.random.default_rng(0)
    net = jyolo.YOLOv4(dtype=jnp.float32, width=0.25)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    variables = net.init(jax.random.key(0), jnp.zeros((1, 128, 128, 3)))
    # randomize the BatchNorm statistics so that they are exercised
    variables = jax.tree.map(np.array, variables)
    stats = variables["batch_stats"]
    for path, leaf in weights._flatten(stats).items():
        leaf[...] = rng.uniform(0.5, 1.5, leaf.shape) if path[-1] == "var" else rng.normal(0, 0.1, leaf.shape)
    jb, jc = net.apply(variables, x)
    ours = tyolo.YOLOv4(width=0.25, dtype=torch.float32)
    ours.load_state_dict(weights.convert_variables(variables), strict=True)
    with torch.no_grad():
        tb, tcf = ours(T(x).permute(0, 3, 1, 2))
    assert tb.shape == (2, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2), 1, 4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcf.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-4)


def test_effnet_and_head_match_jax_on_ci_weights(ci_params):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jf = jeff.EfficientNetV2(stages=jeff.V2_TINY, dtype=jnp.float32).apply(ci_params["bbone"], x)
    jl = jeff.MetrabsHead().apply(ci_params["head"], jf)
    sd = weights.convert_pose_stack(ci_params)
    bbone = teff.EfficientNetV2(teff.V2_TINY, dtype=torch.float32)
    head = teff.MetrabsHead()
    bbone.load_state_dict(sd["bbone"], strict=True)
    head.load_state_dict(sd["head"], strict=True)
    with torch.no_grad():
        tf = bbone(T(x).permute(0, 3, 1, 2))
        tl = head(tf)
    np.testing.assert_allclose(tf.permute(0, 2, 3, 1).numpy(), np.asarray(jf), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5, rtol=1e-5)


def test_same_padding_matches_xla_for_odd_and_even_sizes():
    rng = np.random.default_rng(2)
    for size in (15, 16):
        x = rng.normal(size=(1, size, size, 4)).astype(np.float32)
        conv = jeff.nn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False)
        v = conv.init(jax.random.key(0), x)
        ref = np.asarray(conv.apply(v, x))
        ours = teff.Conv(4, 6, 3, 2, bias=False)
        ours.load_state_dict({"weight": T(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())})
        with torch.no_grad():
            out = ours(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("head", ["DISC", "EXP"])
def test_trx_support_kv_embed_and_match_match_jax(head):
    rng = np.random.default_rng(3)
    jcfg = JaxARConfig.for_input("skeleton", model=head)
    jar = JaxRecognizer(jcfg, seed=0)
    params = NP(jar.params)
    model = ttrx.TRXOS(tc.ARConfig.for_input("skeleton", model=head))
    model.load_state_dict(weights.convert_variables(params), strict=True)
    jm = jtrx.TRXOS(jcfg)

    sk = rng.normal(size=(5, 16, 90)).astype(np.float32)
    query = rng.normal(size=(3, 16, 256)).astype(np.float32)
    mask = np.array([[True, True, False, True, False]] * 3)
    jfeat = jm.apply(params, sk, method=lambda m, x: m.sk_extractor(x))
    jkv = jm.apply(params, support_features=jfeat[None], method="support_kv")
    jout = jm.apply(params, query, mask, jnp.broadcast_to(jkv["s_k"], (3,) + jkv["s_k"].shape[1:]),
                    jnp.broadcast_to(jkv["s_v"], (3,) + jkv["s_v"].shape[1:]), method="match_features")
    with torch.no_grad():
        feat = model.embed_frame(T(sk))
        s_k, s_v = model.support_kv(feat[None])
        out = model.match_features(T(query), T(mask), s_k.expand(3, -1, -1, -1), s_v.expand(3, -1, -1, -1))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s_k[0].numpy(), np.asarray(jkv["s_k"][0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s_v[0].numpy(), np.asarray(jkv["s_v"][0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(out["is_true"].numpy(), np.asarray(jout["is_true"]), atol=1e-5, rtol=1e-4)
    assert (out["logits"].numpy()[:, [2, 4]] == ttrx.NEG_INF).all()


@pytest.fixture(scope="module")
def ci_estimators(ci_params):
    jcfg = JaxHPEConfig(yolo_input_size=128, crop_size=128, compute_dtype="float32")
    tcfg = tc.HPEConfig(yolo_input_size=128, crop_size=128, compute_dtype="float32")
    ci = CI_INTRINSICS
    intr = tc.CameraIntrinsics(fx=ci.fx, fy=ci.fy, ppx=ci.ppx, ppy=ci.ppy, width=ci.width, height=ci.height)
    jax_est = JaxEstimator(jcfg, ci, params=ci_params, backbone_stages=jeff.V2_TINY,
                           frame_shape=CI_FRAME_HW, yolo_width=0.25)
    ours = HumanPoseEstimator(tcfg, intr, params=ci_params, backbone_stages=teff.V2_TINY,
                              frame_shape=CI_FRAME_HW, yolo_width=0.25, device="cpu")
    return jax_est, ours


def test_estimator_matches_jax_on_rendered_frames(ci_estimators):
    """The trained CI stack on rendered humanoids: detections fire at 0.3,
    boxes and flags agree exactly, poses to 1.5 cm (the truncation crop
    gather turns last-ulp differences of the float32 homography into
    whole-pixel flips, which move a pose by millimetres; the CI nets' own
    error is ~10 cm)."""
    jax_est, ours = ci_estimators
    frames, _ = render_motion_clip("wave", n_frames=6, frame_hw=CI_FRAME_HW, intrinsics=CI_INTRINSICS)
    batch = torch.from_numpy(np.stack(frames).astype(np.float32))
    with torch.no_grad():
        pose, bbox, conf, found, visible = ours._estimate_impl(ours.nets, batch)
    for i, frame in enumerate(frames):
        jp, jb, jc, jf, jv = jax_est._estimate_jit(jax_est.params, jnp.asarray(frame))
        np.testing.assert_array_equal(bbox[i].numpy(), np.asarray(jb))
        assert bool(found[i]) == bool(jf) and bool(visible[i]) == bool(jv)
        np.testing.assert_allclose(float(conf[i]), float(jc), atol=1e-5)
        np.testing.assert_allclose(pose[i].numpy(), np.asarray(jp), atol=1.5e-2)
    assert found.all()


def test_ci_bundle_loads_into_port_modules_without_missing_keys(ci_params):
    sd = weights.convert_pose_stack(ci_params)
    nets = {"yolo": tyolo.YOLOv4(width=0.25), "bbone": teff.EfficientNetV2(teff.V2_TINY),
            "head": teff.MetrabsHead()}
    for name, net in nets.items():
        result = net.load_state_dict(sd[name], strict=False)
        assert result.missing_keys == [] and result.unexpected_keys == [], name
