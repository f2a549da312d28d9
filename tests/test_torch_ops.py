"""Ops of the PyTorch port against their JAX counterparts, on the CPU.

Inputs come from ``np.random.default_rng``; each case runs the JAX function
and the port's and compares them at the stated tolerance. The port's ops
are batched over a leading frame axis where the JAX ones took one frame.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isbfsar_tpu.configs import CameraIntrinsics, HPEConfig
from isbfsar_tpu.ops import geometry as jg
from isbfsar_tpu.ops import nms as jn
from isbfsar_tpu.ops import reconstruct as jr
from isbfsar_tpu.ops import smooth as js
from isbfsar_tpu.ops import softargmax as jsa
from isbfsar_tpu.ops import tuples as jt
from isbfsar_tpu.ops import warp as jw
from isbfsar_tpu.utils import skeleton as jsk
from isbfsar_tpu_torch.ops import geometry as tg
from isbfsar_tpu_torch.ops import nms as tn
from isbfsar_tpu_torch.ops import reconstruct as tr
from isbfsar_tpu_torch.ops import smooth as ts
from isbfsar_tpu_torch.ops import softargmax as tsa
from isbfsar_tpu_torch.ops import tuples as tt
from isbfsar_tpu_torch.ops import warp as tw
from isbfsar_tpu_torch.utils import skeleton as tsk

T = torch.from_numpy
K = CameraIntrinsics().matrix()


def _boxes(rng, n):
    x1 = rng.uniform(0, 500, n).astype(np.float32)
    y1 = rng.uniform(0, 350, n).astype(np.float32)
    return x1, x1 + rng.uniform(20, 140, n).astype(np.float32), y1, y1 + rng.uniform(40, 130, n).astype(np.float32)


def test_virtual_camera_and_warp_matrix_match_jax():
    # float32 geometry in two frameworks: agreement to a few ulp of the
    # largest entry (the JAX side pins Precision.HIGHEST)
    rng = np.random.default_rng(0)
    x1, x2, y1, y2 = _boxes(rng, 16)
    new_k, rot = tg.virtual_camera(T(x1), T(x2), T(y1), T(y2), T(K), 256)
    h = tg.warp_matrix(T(K), new_k, rot)
    for i in range(16):
        jk, jrot = jg.virtual_camera(*(jnp.float32(v[i]) for v in (x1, x2, y1, y2)), jnp.asarray(K), 256)
        jh = jg.warp_matrix(jnp.asarray(K), jk[None], jrot)
        np.testing.assert_allclose(new_k[i].numpy(), np.asarray(jk), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(rot[i].numpy(), np.asarray(jrot[0]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(h[i].numpy(), np.asarray(jh[0]), rtol=1e-5, atol=1e-5)


def test_inv_intrinsics_and_fov_match_jax():
    rng = np.random.default_rng(1)
    k = np.tile(K, (4, 1, 1)) * rng.uniform(0.5, 2.0, (4, 1, 1)).astype(np.float32)
    k[:, 2] = [0, 0, 1]
    np.testing.assert_array_equal(tg.inv_intrinsics(T(k)).numpy(), np.asarray(jg.inv_intrinsics(jnp.asarray(k))))
    coords = rng.uniform(0, 256, (4, 32, 2)).astype(np.float32)
    np.testing.assert_array_equal(tg.is_within_fov(T(coords)).numpy(), np.asarray(jg.is_within_fov(jnp.asarray(coords))))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_warp_image_truncation_gather_matches_jax(dtype):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 120, 160, 3)).astype(dtype)
    hs = []
    for _ in range(2):
        h = np.eye(3, dtype=np.float32) + rng.normal(0, 0.02, (3, 3)).astype(np.float32)
        h[:2, 2] = rng.uniform(-60, 60, 2)  # sweeps the crop partly out of bounds
        h[:2, :2] *= 0.8
        hs.append(h)
    hs = np.stack(hs)
    out = tw.warp_image(T(img), T(hs), 64).numpy()
    for i in range(2):
        ref = np.asarray(jw.warp_image(jnp.asarray(img[i]), jnp.asarray(hs[i:i + 1]), 64))[0]
        np.testing.assert_array_equal(out[i], ref)
    assert (out == 0).all(-1).any() and not (out == 0).all()


def test_to_int32_saturates_like_xla():
    v = np.array([1.7, -1.7, 3e9, -3e9, np.nan, np.inf], np.float32)
    expect = np.asarray(jnp.asarray(v).astype(jnp.int32))
    got = tw.to_int32(T(v)).numpy()
    np.testing.assert_array_equal(got[:2], expect[:2])
    assert got[2] > 160 and got[3] < 0 and got[4] == expect[4] == 0 and got[5] > 160


def test_best_person_box_matches_jax():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 1, (3, 4032, 1, 4)).astype(np.float32)
    confs = rng.uniform(0, 1, (3, 4032, 80)).astype(np.float32) ** 4
    confs[2] *= 0.2  # a frame where nothing clears the gate
    box, conf, found = tn.best_person_box(T(boxes), T(confs), 0.3)
    for i in range(3):
        jb, jc, jf = jn.best_person_box(jnp.asarray(boxes[i]), jnp.asarray(confs[i]), 0.3)
        np.testing.assert_array_equal(box[i].numpy(), np.asarray(jb))
        assert float(conf[i]) == float(jc) and bool(found[i]) == bool(jf)
    assert found.numpy().tolist() == [True, True, False]


def test_softargmax_decode_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (2, 8, 8, 288)).astype(np.float32)
    j2, j3 = jsa.split_head_logits(jnp.asarray(logits))
    t2, t3 = tsa.split_head_logits(T(logits))
    np.testing.assert_array_equal(t3.numpy(), np.asarray(j3))
    np.testing.assert_allclose(tsa.decode_heatmap3d(t3).numpy(), np.asarray(jsa.decode_heatmap3d(j3)), atol=1e-6)
    np.testing.assert_allclose(tsa.decode_heatmap2d(t2, 255.0).numpy(),
                               np.asarray(jsa.decode_heatmap2d(j2, 255.0)), atol=5e-5)


def test_reconstruct_absolute_matches_jax():
    # well-conditioned systems: a spread-out 2D decode and plausible depths
    rng = np.random.default_rng(5)
    coords2d = rng.uniform(20, 236, (4, 32, 2)).astype(np.float32)
    rel = np.concatenate([rng.normal(0, 0.3, (4, 32, 2)), rng.uniform(-0.2, 0.2, (4, 32, 1))], -1).astype(np.float32)
    k = np.tile(np.array([[600, 0, 128], [0, 600, 128], [0, 0, 1]], np.float32), (4, 1, 1))
    fov = rng.uniform(0, 1, (4, 32)) > 0.2
    ref = np.asarray(jr.reconstruct_absolute(jnp.asarray(coords2d), jnp.asarray(rel), jnp.asarray(k), jnp.asarray(fov)))
    out = tr.reconstruct_absolute(T(coords2d), T(rel), T(k), T(fov)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_gated_one_euro_sequence_matches_jax():
    rng = np.random.default_rng(6)
    xs = rng.normal(0, 0.1, (12, 30, 3)).astype(np.float32).cumsum(0)
    oks = rng.uniform(0, 1, 12) > 0.3
    oks[0] = False  # the filter latches on the first good frame
    jst, tst = js.one_euro_gated_state((30, 3)), ts.one_euro_gated_state((30, 3))
    for x, ok in zip(xs, oks):
        jst, jy = js.one_euro_gated_step(jst, jnp.asarray(x), jnp.asarray(ok))
        tst, ty = ts.one_euro_gated_step(tst, T(x), torch.tensor(ok))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tst["dx"].numpy(), np.asarray(jst["dx"]), rtol=1e-6, atol=1e-7)
    assert bool(tst["init"]) == bool(jst["init"])


def test_skeleton_tables_match_jax():
    cfg = HPEConfig()
    spec = jsk.get_skeleton(cfg.skeleton)
    ours = tsk.get_skeleton(cfg.skeleton)
    assert ours.indices == spec.indices and ours.joint_names == spec.joint_names
    np.testing.assert_array_equal(ours.edges, spec.edges)
    ref = jsk.load_expand_joints()[:, list(spec.indices)]
    np.testing.assert_array_equal(tsk.joint_matrix(cfg.skeleton), ref)
    np.testing.assert_array_equal(tt.frame_tuples(16, 2), jt.frame_tuples(16, 2))


def test_geometry_is_float32_exact_matmul():
    # mm is a plain float32 matmul: on the CPU it must agree with float64
    # to float32 rounding (no reduced-precision path)
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(5, 3, 3)).astype(np.float32), rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.mm(T(a), T(b)).numpy(), a.astype(np.float64) @ b, rtol=1e-6, atol=1e-6)
    assert jax.devices()[0].platform == "cpu"
