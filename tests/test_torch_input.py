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
