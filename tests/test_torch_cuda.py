"""The PyTorch port's CUDA kernel on the GPU. Every test here needs an
NVIDIA GPU and nvcc and skips elsewhere. The file imports neither JAX nor
the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from isbfsar_tpu_torch.ops import fused_input
from isbfsar_tpu_torch.ops.image import bgr_to_i420

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([bgr_to_i420(rng.integers(0, 256, (h, w, 3), np.uint8)) for _ in range(b)])


@pytest.mark.parametrize("h,w,s,b", [(480, 640, 256, 16), (120, 160, 128, 3), (120, 160, 128, 1)])
def test_kernel_matches_plain_version(cuda, h, w, s, b):
    yuv = torch.from_numpy(_frames(b, h, w)).to(cuda)
    before = fused_input.fused_i420_inputs.launches
    bgr, yolo = fused_input.fused_i420_inputs(yuv, h, s)
    ref_bgr, ref_yolo = fused_input.fused_i420_reference(yuv, h, s)
    torch.cuda.synchronize()
    assert fused_input.fused_i420_inputs.launches == before + 1
    assert bgr.shape == (b, h, w, 3) and yolo.shape == (b, 1, s, s, 3)
    torch.testing.assert_close(bgr, ref_bgr, atol=1e-4, rtol=0)
    torch.testing.assert_close(yolo, ref_yolo, atol=1e-5, rtol=0)
    assert yolo[:, 0].permute(0, 3, 1, 2).is_contiguous()


def test_single_frame_layout(cuda):
    yuv = torch.from_numpy(_frames(1, 120, 160)[0]).to(cuda)
    bgr, yolo = fused_input.fused_i420_inputs(yuv, 120, 128)
    assert bgr.shape == (120, 160, 3) and yolo.shape == (1, 128, 128, 3)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "rows", "odd_height"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    yuv = torch.from_numpy(_frames(2, 120, 160)).to(cuda)
    height = 120
    if bad == "dtype":
        yuv = yuv.to(torch.int32)
    elif bad == "contiguity":
        yuv = yuv.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rows":
        yuv = yuv[:, :-2].contiguous()
    else:
        height = 118
    before = fused_input.fused_i420_inputs.launches
    with pytest.raises(ValueError):
        fused_input.fused_i420_inputs(yuv, height, 128)
    assert fused_input.fused_i420_inputs.launches == before
