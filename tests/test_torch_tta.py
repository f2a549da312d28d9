"""The estimator's test-time augmentation and 122-joint output in the
PyTorch port against the JAX package, on the CPU in float32.

The augmentations' rotations are bit-equal to XLA's (``ops/geometry.py::
rotation_z`` calls the C library's ``sinf``/``cosf``, which XLA's CPU code
matches), and so are the B*A homographies. The crops are bit-equal to
JAX's ``warp_image`` on those homographies. Inside the JAX estimator's
program XLA computes the crop's source coordinates with fused
multiply-adds in some programs (num_aug=5 here) and without in others
(num_aug=4, num_aug=0), which moves a coordinate by one float32 place and,
where that crosses an integer, one truncated source pixel: on the four
rendered wave frames, 1 pixel of 2 of the 20 crops at num_aug=5, and those
frames' poses part by up to 3.8e-5 m. The tests hold every other frame to
1e-5 m and such a frame to 1e-4 m, with at most ``MAX_FLIPS`` pixels a crop.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.ops import geometry as jg
from isbfsar_tpu.ops.image import bgr_to_i420
from isbfsar_tpu.ops.warp import warp_image as jax_warp_image
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.train.posestack import CI_INTRINSICS as JAX_CI_INTRINSICS
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.ops import geometry as tg
from isbfsar_tpu_torch.pipeline import FusedPipeline
from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip

CI_KW = dict(yolo_input_size=128, crop_size=128, compute_dtype="float32")
TOL_POSE, TOL_POSE_FLIPPED = 1e-5, 1e-4
MAX_FLIPS = 2  # crop pixels a crop may differ from JAX's program by (module docstring)
# the fused pipelines, as tests/test_torch_pipeline.py holds them
TOL = {"pose": 1e-4, "pose_abs": 3e-4, "distance": 3e-4, "conf": 1e-5, "bbox": 0.0,
       "probs": 2e-5, "is_true": 2e-6}
BOOLEANS = ("pose_ok", "ar_ready")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ci_params():
    return pretrained.load("pose-ci-motions")


@pytest.fixture(scope="module")
def wave():
    """Four port-rendered wave frames at the CI size (the renderer is held
    to the JAX one in tests/test_torch_render.py)."""
    frames, _ = render_motion_clip("wave", n_frames=4, frame_hw=CI_FRAME_HW,
                                   intrinsics=CI_INTRINSICS)
    return frames


def _pair(params, **kw):
    jax_est = JaxEstimator(jc.HPEConfig(**CI_KW, **kw), JAX_CI_INTRINSICS, params=params,
                           backbone_stages=JAX_V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25)
    ours = HumanPoseEstimator(tc.HPEConfig(**CI_KW, **kw), CI_INTRINSICS, params=params,
                              backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25,
                              device="cpu")
    return jax_est, ours


def _jax_crops(jax_est, frame):
    """JAX's TTA homographies for one frame (estimator.py's TTA branch), and
    the crops JAX's program takes with them."""
    n, c = jax_est.config.num_aug, jax_est.config.crop_size

    @jax.jit
    def run(params, frame):
        (x1, y1, x2, y2), _, _ = jax_est._detect(params, frame)
        f32 = lambda v: v.astype(jnp.float32)
        new_k, rot = jg.virtual_camera(f32(x1), f32(x2), f32(y1), f32(y2), jax_est.k_matrix, c)
        new_k = jnp.tile(new_k[None], (n, 1, 1))
        new_k = new_k.at[:, :2, :2].multiply(jax_est._tta["scales"][:, None, None])
        rot = jg.mm(jax_est._tta["rotflip"], jnp.tile(rot, (n, 1, 1)))
        h = jg.warp_matrix(jax_est.k_matrix, new_k, rot)
        return h, jax_warp_image(jnp.round(frame).astype(jnp.int32), h, c)

    h, crops = run(jax_est.params, jnp.asarray(frame))
    return np.asarray(h), np.asarray(crops)


@pytest.mark.parametrize("num_aug", range(1, 9))
def test_tta_params_and_rotation_z_equal_jax(num_aug):
    flip, rotflip, gammas, scales = jg.tta_params(num_aug)
    # JAX's gammas are never applied to the crops; the port leaves them out
    for ours, ref in zip(tg.tta_params(num_aug), (flip, rotflip, scales)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    angles = np.linspace(-1.3, 1.3, 4 * num_aug + 1).astype(np.float32)
    np.testing.assert_array_equal(tg.rotation_z(angles),
                                  np.asarray(jg.rotation_z(jnp.asarray(angles))))


@pytest.mark.parametrize("num_aug, aggregate", [(4, "aug0"), (4, "mean"), (5, "mean")])
def test_tta_estimator_matches_jax(ci_params, wave, num_aug, aggregate):
    jax_est, ours = _pair(ci_params, num_aug=num_aug, tta_aggregate=aggregate, yolo_thresh=0.3)
    stages = {}
    with torch.no_grad():
        pose, bbox, conf, found, visible = ours._estimate_impl(
            ours.nets, torch.from_numpy(np.stack(wave).astype(np.float32)), stages=stages)
    homs = stages["homography"].numpy().reshape(len(wave), num_aug, 3, 3)
    crops = stages["crop"].numpy().reshape(len(wave), num_aug, 128, 128, 3)
    for i, frame in enumerate(wave):
        jp, jb, jconf, jf, jv = jax_est._estimate_jit(jax_est.params, jnp.asarray(frame))
        np.testing.assert_array_equal(bbox[i].numpy(), np.asarray(jb))
        assert bool(found[i]) == bool(jf) and bool(visible[i]) == bool(jv)
        np.testing.assert_allclose(float(conf[i]), float(jconf), atol=1e-5)
        jh, jcrops = _jax_crops(jax_est, frame)
        np.testing.assert_array_equal(homs[i], jh)
        # the crops equal JAX's warp_image of those homographies outside its program
        for a in range(num_aug):
            plain = np.asarray(jax_warp_image(jnp.asarray(frame.astype(np.int32)),
                                              jnp.asarray(jh[a:a + 1]), 128))[0]
            np.testing.assert_array_equal(crops[i, a], plain)
        flips = (crops[i] != jcrops).any(-1).sum(axis=(1, 2))
        assert flips.max() <= MAX_FLIPS, flips
        tol = TOL_POSE if flips.sum() == 0 else TOL_POSE_FLIPPED
        np.testing.assert_allclose(pose[i].numpy(), np.asarray(jp), atol=tol, rtol=0)
    assert found.all() and visible.all()


@pytest.fixture(scope="module")
def mixed_visibility(ci_params):
    """pose-ci-motions with one seeded random direction added to all 32
    joints' 2D heatmap weights, which pulls a crop's joints together
    toward one side, and eight rendered wave frames: the augmentations of
    a frame then differ in how many joints fall inside the field of view,
    and on some frames no kept augmentation is visible."""
    rng = np.random.default_rng(0)
    params = copy.deepcopy(ci_params)
    kernel = np.array(params["head"]["params"]["conv_final"]["kernel"])
    kernel[:, :32] += 2.0 * rng.normal(size=(kernel.shape[0], 1)).astype(np.float32)
    params["head"]["params"]["conv_final"]["kernel"] = kernel
    frames, _ = render_motion_clip("wave", n_frames=8, frame_hw=CI_FRAME_HW,
                                   intrinsics=CI_INTRINSICS, cycles=2.0)
    return params, frames


def _jax_tta_internals(jax_est, frames, monkeypatch):
    """Per frame, JAX's program's pose and visible, and inside it the
    per-augmentation poses (A, J, 3) and FOV masks (A, 32) that its
    aggregation reads."""
    import isbfsar_tpu.hpe.estimator as jax_module

    seen = {}

    def spy_fov(*args, **kw):
        seen["fov"] = jg.is_within_fov(*args, **kw)
        return seen["fov"]

    class SpyJnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def einsum(spec, *operands, **kw):
            out = jnp.einsum(spec, *operands, **kw)
            if spec == "bjc,jn->bnc":
                seen["pose_all"] = out
            return out

    monkeypatch.setattr(jax_module, "is_within_fov", spy_fov)
    monkeypatch.setattr(jax_module, "jnp", SpyJnp())

    @jax.jit
    def run(params, frame):
        pose, _, _, _, visible = jax_est._estimate_impl(params, frame)
        return pose, visible, seen["pose_all"], seen["fov"]

    return [[np.asarray(v) for v in run(jax_est.params, jnp.asarray(f))] for f in frames]


@pytest.mark.parametrize("num_aug", [4, 5])
def test_tta_mean_with_mixed_visibility_matches_jax(mixed_visibility, num_aug, monkeypatch):
    """The "mean" aggregate's two branches in one batch: the weights of the
    visible kept augmentations where only some are visible, and the plain
    mean of the kept ones where none is. Each augmentation's visibility
    is JAX's exactly; the port's batched aggregate of JAX's own
    per-augmentation poses and FOV masks equals JAX's per-frame one within
    float32 rounding of its weighted sum. (The poses themselves are left
    out: with most joints outside the view the reconstruction is
    ill-conditioned, and the closed-form solve and JAX's SVD part by more
    than the aggregate's rounding.)"""
    params, frames = mixed_visibility
    jax_est, ours = _pair(params, num_aug=num_aug, tta_aggregate="mean", yolo_thresh=0.0)
    counts, aggregate = [], ours._aggregate
    ours._aggregate = lambda poses, fov: (counts.append(fov.sum(dim=2)), aggregate(poses, fov))[1]
    with torch.no_grad():
        _, _, _, _, visible = ours._estimate_impl(
            ours.nets, torch.from_numpy(np.stack(frames).astype(np.float32)))
    ref = _jax_tta_internals(jax_est, frames, monkeypatch)
    jpose = np.stack([r[0] for r in ref])
    jvisible = np.stack([r[1] for r in ref])
    pose_all = np.stack([r[2] for r in ref])  # (B, A, J, 3)
    fov = np.stack([r[3] for r in ref])  # (B, A, 32)
    np.testing.assert_array_equal(counts[0].numpy(), fov.sum(axis=2))
    np.testing.assert_array_equal(visible.numpy(), jvisible)
    keep = ours._tta["keep"].numpy() > 0
    kept = (fov.sum(axis=2) >= fov.shape[2] / 4)[:, keep]
    assert (kept.any(axis=1) & ~kept.all(axis=1)).any(), fov.sum(axis=2)
    assert (~kept.any(axis=1)).any(), fov.sum(axis=2)
    got, got_visible = ours._aggregate(torch.from_numpy(pose_all), torch.from_numpy(fov))
    np.testing.assert_array_equal(got_visible.numpy(), jvisible)
    # a sum of A terms, each weight at most 1: a few float32 places of the
    # largest term each
    bound = 4 * num_aug * np.finfo(np.float32).eps * np.abs(pose_all).max(axis=1)
    assert np.all(np.abs(got.numpy() - jpose) <= bound), np.abs(got.numpy() - jpose).max()


def test_identity_augs_equal_num_aug_0(ci_params, wave):
    """With every augmentation forced to the identity, both aggregates give
    the num_aug=0 prediction (JAX tests/test_hpe.py's check)."""
    _, base = _pair(ci_params, yolo_thresh=0.0)
    batch = torch.from_numpy(np.stack(wave).astype(np.float32))
    with torch.no_grad():
        want = base._estimate_impl(base.nets, batch)
    for aggregate in ("aug0", "mean"):
        _, aug = _pair(ci_params, num_aug=4, tta_aggregate=aggregate, yolo_thresh=0.0)
        aug._tta = {"keep": torch.ones(4), "rotflip": torch.eye(3).expand(4, 3, 3),
                    "scales": torch.ones(4)}
        with torch.no_grad():
            got = aug._estimate_impl(aug.nets, batch)
        # the convolutions run on 4x the batch: summation orders differ
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5, rtol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("num_aug", [2, 3, 6, 7])
def test_aug0_with_a_flipped_aug_0_is_refused(num_aug):
    with pytest.raises(ValueError, match="flipped augmentation"):
        HumanPoseEstimator(tc.HPEConfig(**CI_KW, num_aug=num_aug, tta_aggregate="aug0"),
                           CI_INTRINSICS, backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW,
                           yolo_width=0.25, device="cpu")


@pytest.mark.parametrize("num_aug", [0, 4])
def test_skeleton_none_gives_122_joints_as_jax(ci_params, wave, num_aug):
    jax_est, ours = _pair(ci_params, skeleton=None, num_aug=num_aug, tta_aggregate="aug0")
    assert ours.edges is None and jax_est.edges is None
    res = ours.estimate(wave[1])
    ref = jax_est.estimate(wave[1])
    assert res["pose"].shape == ref["pose"].shape == (122, 3)
    assert res["bbox"] == ref["bbox"] and res["edges"] is None
    np.testing.assert_allclose(res["pose"], ref["pose"], atol=TOL_POSE, rtol=0)


@pytest.fixture(scope="module")
def tta_pipelines(ci_params):
    """JAX's and the port's FusedPipeline at num_aug=5 ("mean") on the
    trained CI stack, with two support actions, on 12 rendered wave frames."""
    h, w = CI_FRAME_HW
    kw = dict(**CI_KW, num_aug=5, tta_aggregate="mean")
    jhpe = JaxEstimator(jc.HPEConfig(**kw), JAX_CI_INTRINSICS, params=ci_params,
                        backbone_stages=JAX_V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25)
    jar = JaxRecognizer(jc.ARConfig.for_input("skeleton"), seed=0)
    jpipe = JaxPipeline(jc.PipelineConfig(main=jc.MainConfig(cam_width=w, cam_height=h),
                                          intrinsics=JAX_CI_INTRINSICS, hpe=jc.HPEConfig(**kw),
                                          param_dtype="float32"),
                        hpe=jhpe, ar=jar, with_focus=False, input_format="i420")
    rng = np.random.default_rng(0)
    support = [{"flag": f"a{i}", "data": {"poses": rng.normal(size=(16, 90)).astype(np.float32)},
                "requires_focus": False} for i in range(2)]
    for item in support:
        jar.train(item)

    def port(cuda_graphs):
        hpe = HumanPoseEstimator(tc.HPEConfig(**kw), CI_INTRINSICS, params=ci_params,
                                 backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW,
                                 yolo_width=0.25, device="cpu")
        ar = ActionRecognizer(tc.ARConfig.for_input("skeleton"),
                              params=jax.tree.map(np.asarray, jar.params), device="cpu")
        for item in support:
            ar.train(item)
        return FusedPipeline(tc.PipelineConfig(main=tc.MainConfig(cam_width=w, cam_height=h),
                                               intrinsics=CI_INTRINSICS, hpe=tc.HPEConfig(**kw),
                                               param_dtype="float32"),
                             hpe=hpe, ar=ar, with_focus=False, device="cpu",
                             cuda_graphs=cuda_graphs)

    clip, _ = render_motion_clip("wave", n_frames=12, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    frames = [bgr_to_i420(f) for f in clip]
    jpipe.start()
    ref = list(jpipe.stream_batched(frames, 4))
    return port, frames, ref


@pytest.mark.parametrize("cuda_graphs", [False, True])
def test_tta_fused_pipeline_matches_jax(tta_pipelines, cuda_graphs):
    """TTA inside the fused step: the JAX program, and the port eagerly and
    through the static-buffer step its CUDA graphs replay."""
    port, frames, ref = tta_pipelines
    pipe = port(cuda_graphs)
    pipe.start()
    ours = list(pipe.stream_batched(frames, 4))
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        for key in b:
            if key in BOOLEANS:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"frame {i} {key}")
            else:
                np.testing.assert_allclose(a[key], b[key], atol=TOL[key], rtol=0,
                                           err_msg=f"frame {i} {key}")
    assert all(o["pose_ok"] for o in ours)
