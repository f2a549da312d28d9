"""Port of the fused I420 input stage: plain version vs the JAX kernel.

``isbfsar_tpu_torch.ops.fused_input`` runs its plain PyTorch version for
CPU tensors; it is held here against the Pallas kernel
``fused_i420_inputs(..., interpret=True)`` with the tolerances of
tests/test_pallas_input.py (BGR atol 1e-4, YOLO atol 1e-5). The CUDA
kernel itself is tested on the GPU by tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isbfsar_tpu.ops.image import _area_weights as jax_area_weights
from isbfsar_tpu.ops.image import bgr_to_i420 as cv2_bgr_to_i420
from isbfsar_tpu.ops.image import i420_to_bgr as jax_i420_to_bgr
from isbfsar_tpu.ops.image import resize_area as jax_resize_area
from isbfsar_tpu.ops.pallas_input import fused_i420_inputs as pallas_fused
from isbfsar_tpu_torch.ops import fused_input
from isbfsar_tpu_torch.ops.image import _area_weights, bgr_to_i420, i420_to_bgr, resize_area

SHAPES = [(480, 640, 256), (120, 160, 128)]  # H, W, S


def _yuv(h, w, seed):
    rng = np.random.default_rng(seed)
    return cv2_bgr_to_i420(rng.integers(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("h,w,s", SHAPES)
def test_plain_version_matches_pallas_kernel(h, w, s):
    yuv = _yuv(h, w, 7)
    ref_bgr, ref_yolo = pallas_fused(jnp.asarray(yuv), h, s, interpret=True)
    bgr, yolo = fused_input.fused_i420_inputs(torch.from_numpy(yuv), h, s)
    assert bgr.shape == (h, w, 3) and yolo.shape == (1, s, s, 3)
    np.testing.assert_allclose(bgr.numpy(), np.asarray(ref_bgr), atol=1e-4, rtol=0)
    np.testing.assert_allclose(yolo.numpy(), np.asarray(ref_yolo), atol=1e-5, rtol=0)


def test_batched_plain_version_equals_per_frame():
    frames = np.stack([_yuv(120, 160, seed) for seed in range(3)])
    bgr, yolo = fused_input.fused_i420_inputs(torch.from_numpy(frames), 120, 128)
    assert bgr.shape == (3, 120, 160, 3) and yolo.shape == (3, 1, 128, 128, 3)
    for i in range(3):
        b1, y1 = fused_input.fused_i420_inputs(torch.from_numpy(frames[i]), 120, 128)
        np.testing.assert_array_equal(bgr[i].numpy(), b1.numpy())
        np.testing.assert_allclose(yolo[i].numpy(), y1.numpy(), atol=1e-6, rtol=0)


def test_cpu_path_launches_nothing():
    before = fused_input.fused_i420_inputs.launches
    fused_input.fused_i420_inputs(torch.from_numpy(_yuv(120, 160, 0)), 120, 128)
    assert fused_input.fused_i420_inputs.launches == before


def test_other_devices_are_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        fused_input.fused_i420_inputs(torch.empty((180, 160), dtype=torch.uint8, device="meta"), 120)


@pytest.mark.parametrize("src,dst", [(480, 256), (640, 256), (120, 128), (160, 128), (720, 256)])
def test_band_tables_rebuild_dense_area_weights(src, dst):
    np.testing.assert_array_equal(_area_weights(src, dst), jax_area_weights(src, dst))
    lo, w, k = fused_input.band_tables(src, dst)
    assert k <= int(np.ceil(src / dst)) + 1
    assert lo.min() >= 0 and lo.max() + k <= src
    dense = np.zeros((dst, src), np.float32)
    for i in range(dst):
        dense[i, lo[i]:lo[i] + k] = w[i]
    np.testing.assert_array_equal(dense, _area_weights(src, dst))


def test_i420_decode_and_resize_match_jax():
    yuv = _yuv(120, 160, 3)
    bgr = i420_to_bgr(torch.from_numpy(yuv), 120)
    np.testing.assert_array_equal(bgr.numpy(), np.asarray(jax_i420_to_bgr(jnp.asarray(yuv), 120)))
    ref = np.asarray(jax_resize_area(jnp.asarray(bgr.numpy()), 96, 64))
    np.testing.assert_allclose(resize_area(bgr, 96, 64).numpy(), ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("h,w", [(480, 640), (120, 160), (8, 12)])
def test_numpy_i420_encoder_matches_cv2(h, w):
    rng = np.random.default_rng(h)
    bgr = rng.integers(0, 256, (h, w, 3), np.uint8)
    np.testing.assert_array_equal(bgr_to_i420(bgr), cv2_bgr_to_i420(bgr))


PLAN_SHAPES = [(480, 640, 256), (240, 320, 128), (120, 160, 128)]


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("h,w,s", PLAN_SHAPES)
def test_band_plan_owns_every_row_once_and_loads_every_tap(h, w, s, g):
    """The CUDA kernel's host plan: the own ranges tile [0, H) in order, each
    inside its band's load range, and the load range holds every tap of the
    band's output rows; the chroma rows and the shared memory sizes follow."""
    plan = fused_input.band_plan(h, w, s, g)
    lo, _, k = fused_input.band_tables(h, s)
    load_lo, load_hi, own_lo, own_hi = plan.plan.T
    assert plan.plan.dtype == np.int32 and len(plan.plan) == -(-s // g)
    owned = np.zeros(h, int)
    for a, b in zip(own_lo, own_hi):
        owned[a:b] += 1
    assert (owned == 1).all() and (own_lo[1:] == own_hi[:-1]).all()
    assert (load_lo <= own_lo).all() and (own_hi <= load_hi).all()
    assert (load_lo >= 0).all() and (load_hi <= h).all()
    for band, (a, b) in enumerate(zip(load_lo, load_hi)):
        outs = np.arange(band * g, min(band * g + g, s))
        assert a <= lo[outs].min() and lo[outs].max() + k <= b
    assert plan.rows == (load_hi - load_lo).max()
    assert plan.crows == ((load_hi - 1) // 2 - load_lo // 2 + 1).max()
    assert plan.raw_bytes == plan.rows * w + plan.crows * w and plan.raw_bytes % 16 == 0
    assert plan.smem_bytes == fused_input.HEADER_BYTES + plan.rows * w * 12 + 2 * plan.raw_bytes


def test_chosen_band_leaves_room_for_two_blocks_and_fills_the_card():
    for h, w, s in PLAN_SHAPES:
        for batch, g in ((16, 2), (1, 1)):
            plan = fused_input.choose_plan(h, w, s, batch, 132)
            assert plan.g == g and plan.blocks_per_sm >= 2
            assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= fused_input.SMEM_PER_SM
    assert fused_input.choose_plan(720, 1280, 256, 16, 132).g == 1
    with pytest.raises(ValueError, match="shared memory"):
        fused_input.choose_plan(1024, 2048, 16, 1, 132)


def _emulate_kernel(yuv, h, s, g):
    """numpy mirror of csrc/fused_i420.cu's blocks for one frame: each band
    decodes its loaded rows from the Y, U and V row ranges it copies in,
    writes its own BGR rows, then runs the row and the column pass."""
    w = yuv.shape[1]
    plan = fused_input.band_plan(h, w, s, g)
    row_lo, row_w, kr = fused_input.band_tables(h, s)
    col_lo, col_w, kc = fused_input.band_tables(w, s)
    u_plane = yuv[h:h + h // 4].reshape(h // 2, w // 2)
    v_plane = yuv[h + h // 4:].reshape(h // 2, w // 2)
    f = np.float32
    bgr = np.full((h, w, 3), np.nan, f)
    writes = np.zeros((h, w), int)
    yolo = np.zeros((3, s, s), f)
    for band, (load_lo, load_hi, own_lo, own_hi) in enumerate(plan.plan):
        c_lo, c_hi = load_lo >> 1, ((load_hi - 1) >> 1) + 1
        raw_y, raw_u, raw_v = yuv[load_lo:load_hi], u_plane[c_lo:c_hi], v_plane[c_lo:c_hi]
        crow = ((np.arange(load_lo, load_hi) >> 1) - c_lo)[:, None]
        ccol = (np.arange(w) >> 1)[None, :]
        yy = (raw_y.astype(f) - f(16)) * f(1.164)
        u = raw_u[crow, ccol].astype(f) - f(128)
        v = raw_v[crow, ccol].astype(f) - f(128)
        frame = np.clip(np.stack([yy + f(2.018) * u, (yy - f(0.391) * u) - f(0.813) * v,
                                  yy + f(1.596) * v], -1), 0, 255).astype(f)
        bgr[own_lo:own_hi] = frame[own_lo - load_lo:own_hi - load_lo]
        writes[own_lo:own_hi] += 1
        for i in range(band * g, min(band * g + g, s)):
            tmp = np.zeros((w, 3), f)
            for t in range(kr):
                tmp = tmp + row_w[i, t] * frame[row_lo[i] + t - load_lo]
            acc = np.zeros((s, 3), f)
            for t in range(kc):
                acc = acc + tmp[col_lo + t] * col_w[:, t:t + 1]
            yolo[:, i] = (acc[:, ::-1] / f(255)).T
    assert (writes == 1).all()
    return bgr, yolo


@pytest.mark.parametrize("g", fused_input.BANDS)
@pytest.mark.parametrize("h,w,s", PLAN_SHAPES)
def test_kernel_blocks_rebuild_the_plain_version(h, w, s, g):
    yuv = _yuv(h, w, 5)
    bgr, yolo = _emulate_kernel(yuv, h, s, g)
    ref_bgr, ref_yolo = fused_input.fused_i420_reference(torch.from_numpy(yuv), h, s)
    np.testing.assert_array_equal(bgr, ref_bgr.numpy())
    np.testing.assert_allclose(yolo.transpose(1, 2, 0)[None], ref_yolo.numpy(), atol=1e-5, rtol=0)
