"""The focus branch of the PyTorch port against the JAX package, on the CPU.

The bilinear warp, the three focus nets on the ``focus-ci`` weights
(carried across by ``weights.convert_focus``), the face geometry and the
whole ``FocusDetector`` forward get the same inputs, made with numpy from
seeds or rendered by the JAX package's face renderer, and are compared
with their JAX counterparts at the tolerances stated beside each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from isbfsar_tpu import pretrained
from isbfsar_tpu.configs import CameraIntrinsics as JaxIntrinsics
from isbfsar_tpu.focus import geometry as jg
from isbfsar_tpu.focus.detector import FocusDetector as JaxFocus
from isbfsar_tpu.models import gaze as jgaze
from isbfsar_tpu.ops.image import i420_to_bgr
from isbfsar_tpu.ops.warp import warp_image_bilinear as jax_warp_bilinear
from isbfsar_tpu.train.gazefocus import CI_FOCUS_CFG as JAX_CI_FOCUS_CFG, render_face_scene
from isbfsar_tpu.train.posestack import CI_INTRINSICS as JAX_CI_INTRINSICS
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.focus import geometry as tg
from isbfsar_tpu_torch.focus.detector import FocusDetector, top_k_stable
from isbfsar_tpu_torch.kernel_bench import face_landmarks
from isbfsar_tpu_torch.models.gaze import BlazeFaceLite, GazeNet, LandmarkRefiner
from isbfsar_tpu_torch.ops import head_pose
from isbfsar_tpu_torch.ops.warp import warp_image_bilinear
from isbfsar_tpu_torch.profile_slice import CI_FOCUS_CFG, CI_INTRINSICS, focus_frames

K = JaxIntrinsics().matrix()
# the suite runs in several processes at once: more torch threads than
# cores each would only wait for one another
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def focus_params():
    return pretrained.load("focus-ci")


# ------------------------------------------------------------------ warp

def _transforms(where: str, b: int, h: int, w: int, rng) -> np.ndarray:
    """Output->source homographies whose 16x16 samples land inside the
    frame, across its border, or wholly outside (beyond the 1-px support)."""
    out = []
    for _ in range(b):
        s = rng.uniform(0.3, 1.7)
        if where == "interior":
            x0, y0 = rng.uniform(1, w - 16 * s - 2), rng.uniform(1, h - 16 * s - 2)
        elif where == "border":
            x0, y0 = rng.uniform(-8 * s, w - 8 * s), rng.choice([-8 * s, h - 8 * s])
        else:
            x0, y0 = rng.choice([-40.0 - 16 * s, w + 2.0]), rng.uniform(-40, h + 40)
        m = np.array([[s, rng.uniform(-0.1, 0.1), x0], [rng.uniform(-0.1, 0.1), s, y0],
                      [rng.uniform(-1e-3, 1e-3), rng.uniform(-1e-3, 1e-3), 1.0]])
        out.append(m)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("where", ["interior", "border", "outside"])
def test_warp_bilinear_matches_jax(where, packed):
    """Elementwise float32 in both frameworks: equal to 1e-4 of 255 (one
    ulp at that size is 1.5e-5); the packed and four-corner forms of the
    port are bit-equal to each other."""
    rng = np.random.default_rng(0)
    b, h, w = 4, 30, 40
    img = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    mats = _transforms(where, b, h, w, rng)
    ours = warp_image_bilinear(torch.from_numpy(img), torch.from_numpy(mats), 16, packed=packed)
    other = warp_image_bilinear(torch.from_numpy(img), torch.from_numpy(mats), 16, packed=not packed)
    ref = np.stack([np.asarray(jax_warp_bilinear(jnp.asarray(img[i]), jnp.asarray(mats[i:i + 1]),
                                                 16, packed=packed))[0] for i in range(b)])
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ours.numpy(), other.numpy())
    if where == "outside":
        assert not ours.any()
    elif where == "interior":
        assert (ours > 0).all()


# ------------------------------------------------------------------ nets

NETS = {  # name: (Flax module, port module, input size)
    "face_det": (jgaze.BlazeFaceLite, BlazeFaceLite, 128),
    "lm_refiner": (jgaze.LandmarkRefiner, LandmarkRefiner, 64),
    "gaze_net": (jgaze.GazeNet, GazeNet, 64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(NETS))
def test_focus_nets_match_flax(focus_params, name, dtype):
    """The trained focus nets on the same image. float32: oneDNN and XLA
    sum the convolutions in other orders, which moves the outputs by up to
    about 1e-5 (boxes and landmarks in [0, 1], pitch/yaw in radians); held
    at 1e-4, the scores at 1e-5. bfloat16: the two frameworks round the
    activations at different places, so the port's bf16 output is held
    within twice the error bf16 itself makes in JAX (JAX's bf16 against
    its float32 on the same input, per output; the CPU reads the port
    at up to 1.2 times that)."""
    jmod, tmod, size = NETS[name]
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)

    def as_tuple(v):
        return v if isinstance(v, tuple) else (v,)

    ref = as_tuple(jmod(dtype=jnp.dtype(dtype)).apply(focus_params[name], jnp.asarray(x)))
    ref32 = as_tuple(jmod(dtype=jnp.float32).apply(focus_params[name], jnp.asarray(x)))
    net = tmod(getattr(torch, dtype))
    net.load_state_dict(weights.convert_focus(focus_params)[name], strict=True)
    ours = as_tuple(net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)))
    for i, (a, r, r32) in enumerate(zip(ours, ref, ref32, strict=True)):
        r, r32 = np.asarray(r, np.float32), np.asarray(r32, np.float32)
        assert a.shape == r.shape and a.dtype == torch.float32
        if dtype == "float32":
            atol = 1e-5 if (name == "face_det" and i == 2) else 1e-4
        else:
            atol = 2 * float(np.abs(r - r32).max())
        np.testing.assert_allclose(a.detach().numpy(), r, atol=atol, rtol=0, err_msg=f"output {i}")


def test_anchor_tables_match_flax():
    from isbfsar_tpu_torch.models.gaze import blaze_anchor_sizes, blaze_anchors

    np.testing.assert_array_equal(blaze_anchors(128).numpy(), np.asarray(jgaze.blaze_anchors(128)))
    np.testing.assert_array_equal(blaze_anchor_sizes(128).numpy(),
                                  np.asarray(jgaze.blaze_anchor_sizes(128)))


def test_top_k_ties_pick_jax_anchors():
    """Scores with equal values straddling the 8th place: the port picks
    the anchors ``jax.lax.top_k`` picks (ties to the lower index), so the
    score-weighted anchor-ensemble box is the same box."""
    rng = np.random.default_rng(2)
    scores = rng.uniform(0.0, 0.5, (3, 896)).astype(np.float32)
    scores[0, [3, 100, 200, 400, 500, 600, 700, 800, 850, 890]] = 0.9  # ten tied at the top
    scores[1, [5, 9]] = 0.95
    scores[1, [40, 41, 300, 301, 302, 303, 880, 881]] = 0.7  # 3rd to 10th tied
    scores[2, :] = 0.25  # all tied
    boxes = rng.uniform(0, 1, (3, 896, 4)).astype(np.float32)
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(scores), 8)
    s, i = top_k_stable(torch.from_numpy(scores), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    wgt = np.asarray(ref_s) / np.asarray(ref_s).sum(-1, keepdims=True)
    ref_box = (boxes[np.arange(3)[:, None], np.asarray(ref_i)] * wgt[..., None]).sum(1)
    ours = torch.gather(torch.from_numpy(boxes), 1, i[..., None].expand(-1, -1, 4))
    ours = (ours * (s / s.sum(-1, keepdim=True))[..., None]).sum(1)
    np.testing.assert_allclose(ours.numpy(), ref_box, atol=1e-6, rtol=0)


# -------------------------------------------------------------- geometry

def _rendered_landmarks():
    """Landmarks of the JAX package's face renderer at head yaw 0, 0.3,
    0.7 and 1.0 rad, and of the canonical face pitched by +-0.4 rad."""
    lms = []
    for yaw in (0.0, 0.3, 0.7, 1.0):
        _, gt = render_face_scene(0.05, head_yaw=yaw, rng=np.random.default_rng(0))
        lms.append(gt["landmarks"] * np.array([640, 480], np.float32))
    for pitch in (0.4, -0.4):
        r = Rotation.from_rotvec([pitch, 0.0, 0.0]).as_matrix()
        proj = (jg.CANONICAL_FACE_3D @ r.T + [0.0, 0.0, 0.6]) @ K.T
        lms.append(proj[:, :2] / proj[:, 2:])
    return np.asarray(lms, np.float32)


def _jax_head_pose(lms):
    f = jax.vmap(lambda l: jg.head_pose_from_landmarks(l, jnp.asarray(K), 0.6))
    rot, center = f(jnp.asarray(lms))
    return np.array(rot), np.array(center)


@pytest.mark.parametrize("kind", ["rendered", "random_faces", "uniform"])
def test_head_pose_plain_matches_jax(kind):
    """The plain solve against JAX's: float32 in both, LAPACK's SVD in
    both; the CPU reads up to 1.8e-6 in the rotation and 1.1e-6 m in the
    center (tests/torch_parity_report.py); held at 1e-5 and 1e-5 m."""
    rng = np.random.default_rng(3)
    if kind == "rendered":
        lms = _rendered_landmarks()
    elif kind == "random_faces":
        lms = face_landmarks(32, rng)
    else:
        lms = rng.uniform([0, 0], [640, 480], (32, 6, 2)).astype(np.float32)
    ref_rot, ref_center = _jax_head_pose(lms)
    rot, center = tg.head_pose_from_landmarks(torch.from_numpy(lms), torch.from_numpy(K), 0.6)
    np.testing.assert_allclose(rot.numpy(), ref_rot, atol=1e-5, rtol=0)
    np.testing.assert_allclose(center.numpy(), ref_center, atol=1e-5, rtol=0)
    if kind == "rendered":  # the solve recovers the rendered poses
        rv = tg.rotmat_to_rotvec(rot).numpy()
        np.testing.assert_allclose(rv[:4, 1], [0.0, 0.3, 0.7, 1.0], atol=0.07)
        np.testing.assert_allclose(rv[4:, 0], [0.4, -0.4], atol=0.07)


def test_head_pose_degenerate_landmarks_are_finite():
    """Six landmarks at one pixel (the principal point among them, where
    the reference's solve reaches NaN): the identity rotation and a finite
    center along the ray, 1e6 times the assumed depth away, and finite
    geometry after it; the kernel wrapper's CPU path is this plain version."""
    pts = np.array([[320.0, 240.0], [100.3, 50.7], [K[0, 2], K[1, 2]], [0.0, 0.0]], np.float32)
    lms = np.repeat(pts[:, None], 6, axis=1)
    out = head_pose.focus_geometry(torch.from_numpy(lms), torch.from_numpy(K))
    rot, center = out.rot, out.center
    assert all(torch.isfinite(t).all() for t in out)
    want = head_pose.focus_geometry_reference(torch.from_numpy(lms), torch.from_numpy(K))
    for a, b in zip(out, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(rot.numpy(), np.broadcast_to(np.eye(3, dtype=np.float32), rot.shape))
    rays = np.concatenate([pts, np.ones((4, 1), np.float32)], 1) @ np.linalg.inv(K).T
    want = rays * 0.6e6 + jg.CANONICAL_FACE_3D.mean(0)
    np.testing.assert_allclose(center.numpy(), want, rtol=1e-6, atol=1e-3)
    _, jax_center = _jax_head_pose(lms[2:3])
    assert not np.isfinite(jax_center).all()  # the reference's NaN, which the port avoids


def test_umeyama_and_kabsch_match_jax():
    """float32, LAPACK's SVD in both; held at 1e-5."""
    rng = np.random.default_rng(4)
    src = rng.normal(size=(8, 6, 3)).astype(np.float32)
    rots = Rotation.from_rotvec(rng.normal(size=(8, 3))).as_matrix().astype(np.float32)
    dst = (1.7 * src @ rots.transpose(0, 2, 1) + rng.normal(size=(8, 1, 3))
           + 0.01 * rng.normal(size=(8, 6, 3))).astype(np.float32)
    ref = [jg.umeyama(jnp.asarray(s), jnp.asarray(d)) for s, d in zip(src, dst)]
    rot, scale, t = tg.umeyama(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_allclose(rot.numpy(), np.stack([np.asarray(r[0]) for r in ref]), atol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.stack([np.asarray(r[1]) for r in ref]), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.stack([np.asarray(r[2]) for r in ref]), atol=1e-5)
    np.testing.assert_allclose(tg.kabsch(torch.from_numpy(src), torch.from_numpy(dst)).numpy(),
                               np.stack([np.asarray(jg.kabsch(jnp.asarray(s), jnp.asarray(d)))
                                         for s, d in zip(src, dst)]), atol=1e-5)


def test_rotmat_to_rotvec_matches_jax():
    """Random rotations, the identity, and angles within 1e-3 and 1e-5 rad
    of pi (the branch the antisymmetric formula cannot serve). The CPU
    reads 1.2e-7 on these and up to 4.8e-7 on the solved head poses of
    tests/torch_parity_report.py; held at 1e-6."""
    rng = np.random.default_rng(5)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rv = np.concatenate([rng.normal(size=(16, 3)) * 0.8, np.zeros((1, 3)),
                         axes[:3] * (np.pi - 1e-3), axes[3:] * (np.pi - 1e-5)])
    mats = Rotation.from_rotvec(rv).as_matrix().astype(np.float32)
    ref = np.asarray(jax.vmap(jg.rotmat_to_rotvec)(jnp.asarray(mats)))
    ours = tg.rotmat_to_rotvec(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.abs(ours[-6:]), np.abs(rv[-6:]), atol=5e-3)


def test_normalization_camera_matches_jax():
    """Face centers from the rendered and random landmarks. The warp
    differs by the 3x3 inverse (cofactors here, LU in JAX): the CPU reads
    6.1e-5 of entries up to 410 (1.5e-7 of the largest), held at 3e-7 of
    it; the normalizing rotation and the denormalized gaze at 1e-6."""
    rng = np.random.default_rng(6)
    _, centers = _jax_head_pose(np.concatenate([_rendered_landmarks(), face_landmarks(8, rng)]))
    gaze = rng.normal(size=(len(centers), 3)).astype(np.float32)
    for size in (224, 64):
        jw, jr = jax.vmap(lambda c: jg.normalization_camera(c, jnp.asarray(K), 0.6, size))(
            jnp.asarray(centers))
        w, r = tg.normalization_camera(torch.from_numpy(centers), torch.from_numpy(K), 0.6, size)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=3e-7,
                                   atol=3e-7 * float(np.abs(np.asarray(jw)).max()))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6, rtol=0)
        jg_ = np.asarray(jax.vmap(jg.denormalize_gaze)(jnp.asarray(gaze), jr))
        np.testing.assert_allclose(tg.denormalize_gaze(torch.from_numpy(gaze), r).numpy(), jg_,
                                   atol=1e-6, rtol=0)


# -------------------------------------------------------------- detector

# FocusDetector._forward_impl at CI_FOCUS_CFG on the committed face frames.
# The CPU reads (float32; tests/torch_parity_report.py): bbox 2.3e-5 px of
# 191, landmarks 7.6e-5 px,
# head_position 8.3e-7 m, head_rotvec 1.8e-6, normalized_head_rot2d
# 1.9e-6, the gaze vectors 5.5e-6, score 0, the normalized image 1.5e-2
# of 255 (its samples move with the warp); the limits are a few times that.
TOL_FORWARD = {"score": 1e-6, "bbox": 2e-4, "landmarks": 5e-4, "head_position": 1e-5,
               "head_rotvec": 2e-5, "normalized_head_rot2d": 2e-5, "gaze_vector": 5e-5,
               "normalized_gaze_vector": 5e-5, "normalized_image": 0.1}


@pytest.fixture(scope="module")
def detectors(focus_params):
    hw = (240, 320)
    jd = JaxFocus(JAX_CI_FOCUS_CFG, JAX_CI_INTRINSICS, params=focus_params, frame_shape=hw)
    td = FocusDetector(CI_FOCUS_CFG, CI_INTRINSICS, params=jax.tree.map(np.asarray, focus_params),
                       frame_shape=hw, device="cpu")
    frames = np.stack([np.asarray(i420_to_bgr(jnp.asarray(f), 240))
                       for f in focus_frames(240)["i420"]])
    return jd, td, frames


def test_ci_focus_config_matches_jax():
    ref = dataclasses.asdict(JAX_CI_FOCUS_CFG)
    ours = dataclasses.asdict(CI_FOCUS_CFG)
    assert ours == {k: ref[k] for k in ours}
    assert dataclasses.asdict(tc.FocusConfig()) == {k: dataclasses.asdict(
        type(JAX_CI_FOCUS_CFG)())[k] for k in ours}
    assert CI_INTRINSICS.matrix().tolist() == JAX_CI_INTRINSICS.matrix().tolist()


def test_forward_matches_jax_on_face_frames(detectors):
    """Close and far faces, frontal, turned and looking away, as float BGR
    decoded from I420 (unrounded, as the pipeline hands them over)."""
    jd, td, frames = detectors
    ref = jax.vmap(jd._forward_impl, in_axes=(None, 0))(jd.params, jnp.asarray(frames))
    ours = td._forward_impl(td.nets, torch.from_numpy(frames))
    assert ref.keys() == ours.keys()
    np.testing.assert_array_equal(ours["found"].numpy(), np.asarray(ref["found"]))
    assert ours["found"].all()
    for key, tol in TOL_FORWARD.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=tol, rtol=0,
                                   err_msg=key)


def test_close_far_and_patience_vote_match_jax(detectors):
    """estimate_collect over a sequence of the face frames: the verdict,
    the close/far branch and the majority vote are the same every frame."""
    jd, td, frames = detectors
    jd.focuses, td.focuses = [], []
    seen = []
    for i in [0, 1, 2, 3, 4, 0, 4, 4, 3, 2, 2, 0]:
        ref = jd.estimate_collect(jd._forward(jd.params, jnp.asarray(frames[i])))
        ours = td.estimate_collect({k: v[0] for k, v in
                                    td._forward_impl(td.nets, torch.from_numpy(frames[i:i + 1])).items()})
        assert (ref is None) == (ours is None)
        assert ours[0] == ref[0] and td.is_close == jd.is_close and td.is_focus == jd.is_focus
        np.testing.assert_allclose(ours[1].bbox, ref[1].bbox, atol=2e-4)
        seen.append((td.is_close, ours[0], td.is_focus))
    assert {c for c, _, _ in seen} == {True, False}  # both branches ran
    assert {f for _, f, _ in seen} == {True, False} and {v for _, _, v in seen} == {True, False}


def test_estimate_collect_reads_all_fields_in_one_copy(detectors):
    """estimate_collect packs the fields into one device -> host copy; the
    Face and the verdicts equal the field-by-field reads it replaced, bit
    for bit, on the face frames (uint8, as estimate_async takes them), the
    image only when asked for."""
    _, td, frames = detectors
    frames = np.round(frames).astype(np.uint8)
    twin = FocusDetector(td.config, params=None, frame_shape=td.frame_shape, device="cpu")
    twin.nets, twin.k_matrix = td.nets, td.k_matrix
    td.focuses, twin.focuses = [], []
    for frame in list(frames) + list(frames[::-1]):
        ours = td.estimate_collect(td.estimate_async(frame))
        fields = {k: v[0] for k, v in twin._forward_impl(
            twin.nets, torch.from_numpy(frame)[None]).items()}
        host = {k: v.numpy() for k, v in fields.items() if k != "normalized_image"}
        ref = twin.estimate_collect(host)  # host arrays: no copy at all
        assert (ours is None) == (ref is None) and ours is not None
        assert ours[0] == ref[0] and td.is_focus == twin.is_focus and td.is_close == twin.is_close
        for key, value in vars(ref[1]).items():
            got = getattr(ours[1], key)
            if value is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, value, err_msg=key)
                assert np.asarray(got).dtype == np.asarray(value).dtype, key
    token = td.estimate_async(frames[0])
    assert set(token) == {"fields", "normalized_image"}
    image = td.estimate_collect(token, return_image=True)[1].normalized_image
    assert image.shape == (td.config.gaze_image_size,) * 2 + (3,)


def test_detector_built_alone_runs_float32():
    """A FocusDetector built without a pipeline turns TF32 off itself:
    PyTorch's default runs float32 cuDNN convolutions in TF32."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    FocusDetector(CI_FOCUS_CFG, CI_INTRINSICS, frame_shape=(240, 320), device="cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
