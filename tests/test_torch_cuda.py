"""The PyTorch port's CUDA kernel and CUDA graphs on the GPU. Every test here
needs an NVIDIA GPU and nvcc and skips elsewhere. The file imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from isbfsar_tpu_torch.ops import fused_input
from isbfsar_tpu_torch.ops.image import bgr_to_i420

pytestmark = pytest.mark.cuda

SHAPES = [(480, 640, 256), (240, 320, 128), (120, 160, 128)]  # H, W, S


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ci_pipes():
    """The trained CI stack on the card, with CUDA graphs and eager, sharing
    the nets and the support set, and 18 frames at its size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: CUDA graphs have no CPU mode")
    from isbfsar_tpu_torch.profile_slice import build_ci, ci_frames, twin

    graphs = build_ci("cuda", cuda_graphs=True)
    return graphs, twin(graphs, cuda_graphs=False), ci_frames(18)


def _frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([bgr_to_i420(rng.integers(0, 256, (h, w, 3), np.uint8)) for _ in range(b)])


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("h,w,s", SHAPES)
def test_kernel_matches_plain_version(cuda, h, w, s, b):
    yuv = torch.from_numpy(_frames(b, h, w)).to(cuda)
    before = fused_input.fused_i420_inputs.launches
    bgr, yolo = fused_input.fused_i420_inputs(yuv, h, s)
    ref_bgr, ref_yolo = fused_input.fused_i420_reference(yuv, h, s)
    torch.cuda.synchronize()
    assert fused_input.fused_i420_inputs.launches == before + 1
    assert bgr.shape == (b, h, w, 3) and yolo.shape == (b, 1, s, s, 3)
    torch.testing.assert_close(bgr, ref_bgr, atol=0, rtol=0)
    torch.testing.assert_close(yolo, ref_yolo, atol=1e-5, rtol=0)
    assert yolo[:, 0].permute(0, 3, 1, 2).is_contiguous()


def test_single_frame_layout(cuda):
    yuv = torch.from_numpy(_frames(1, 120, 160)[0]).to(cuda)
    bgr, yolo = fused_input.fused_i420_inputs(yuv, 120, 128)
    assert bgr.shape == (120, 160, 3) and yolo.shape == (1, 128, 128, 3)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "rows", "odd_height", "width",
                                 "shared_memory"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    yuv = torch.from_numpy(_frames(2, 120, 160)).to(cuda)
    height, size = 120, 128
    if bad == "dtype":
        yuv = yuv.to(torch.int32)
    elif bad == "contiguity":
        yuv = yuv.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rows":
        yuv = yuv[:, :-2].contiguous()
    elif bad == "odd_height":
        height = 118
    elif bad == "width":  # the bulk copies need rows of a multiple of 32 bytes
        yuv = torch.zeros((1, 180, 176), dtype=torch.uint8, device=cuda)
    else:  # one output row's band of 64 source rows of 2048 pixels does not fit
        yuv, height, size = torch.zeros((1, 1536, 2048), dtype=torch.uint8, device=cuda), 1024, 16
    before = fused_input.fused_i420_inputs.launches
    with pytest.raises(ValueError):
        fused_input.fused_i420_inputs(yuv, height, size)
    assert fused_input.fused_i420_inputs.launches == before


def _run(pipe, frames):
    pipe.start()
    outs = [pipe.step(f) for f in frames]
    pipe.start()
    return outs + list(pipe.stream_batched(frames, 8))  # batches of 8 and a tail of 2


def test_graph_replay_equals_eager(ci_pipes):
    graphs, eager, frames = ci_pipes
    ours, ref = _run(graphs, frames), _run(eager, frames)
    assert sorted(graphs._graphs) == [1, 8] and all(g.graph is not None for g in graphs._graphs.values())
    assert not eager._graphs
    for i, (a, b) in enumerate(zip(ours, ref, strict=True)):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"output {i} {key}")


def test_launches_are_counted_under_replay(ci_pipes):
    graphs, _, frames = ci_pipes
    graphs.step(frames[0])  # B=1 is captured by now
    assert graphs._graphs[1].kernel_launches == 1
    before = fused_input.fused_i420_inputs.launches
    confs = [float(graphs.step(f)["conf"]) for f in frames[:4]]
    assert fused_input.fused_i420_inputs.launches == before + 4
    # the kernel is in the graph: what the detector sees follows the frame
    assert len(set(confs)) > 1 and float(graphs.step(frames[0])["conf"]) == confs[0]
