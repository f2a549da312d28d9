"""Fused I420 input stage: decode + INTER_AREA resize + normalize, one pass.

Port of the TPU kernel ``isbfsar_tpu/ops/pallas_input.py::fused_i420_inputs``
as the hand-written CUDA kernel ``csrc/fused_i420.cu`` (sm_90a), built with
nvcc into ``build/isbfsar_tpu_torch/`` beside the package on first use
(``ops/build.py``) and loaded with ctypes. Its bound on an H100 is bytes:
78.9 MB for a batch of 16 480x640 frames at S = 256, about 23.6 us at
3.35 TB/s (the note at the head of the source has the count).

The kernel's work item is one frame and one band of G YOLO output rows;
:func:`band_plan` is the host-side plan of those bands (the source rows
each band loads into shared memory and the rows whose BGR output it
writes), and :func:`choose_plan` picks G so that two blocks fit in an
SM's shared memory and every SM gets work. The kernel is persistent: the
wrapper launches as many blocks as fit on the card at once, or fewer when
there are fewer items.

:func:`fused_i420_inputs` launches the kernel for a CUDA tensor and runs
the plain version (:func:`fused_i420_reference`, ``i420_to_bgr`` then
``yolo_preprocess`` in float32) for a CPU tensor. A CUDA tensor gets the
kernel or an error, never the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.ops import build as _build
from isbfsar_tpu_torch.ops.image import _area_weights, i420_to_bgr, yolo_preprocess


def build() -> _build.BuildInfo:
    """Compile ``csrc/fused_i420.cu`` of this module's tree unless a library
    of this exact source exists."""
    return _build.build("fused_i420", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc"))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build().path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_i420_inputs.argtypes = [p, p, p] + [i] * 11 + [p, p, i, p, p, i, p, p]
    lib.fused_i420_inputs.restype = ctypes.c_int
    lib.fused_i420_init.argtypes = [i]
    lib.fused_i420_init.restype = ctypes.c_int
    err = lib.fused_i420_init(SMEM_PER_BLOCK)
    if err != 0:
        raise RuntimeError(f"fused_i420_inputs: raising the shared memory limit failed with "
                           f"CUDA error {err}")
    return lib


def band_tables(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """INTER_AREA weights as bands: (lo (dst,) int32, w (dst, k) float32, k).

    Output ``i`` is ``sum_t w[i, t] * in[lo[i] + t]``: the nonzero run of row
    ``i`` of ``_area_weights(src, dst)``, zero-padded to the widest run.
    """
    dense = _area_weights(src, dst)
    nz = dense != 0
    first = nz.argmax(axis=1)
    last = src - 1 - nz[:, ::-1].argmax(axis=1)
    k = int((last - first).max()) + 1
    lo = np.minimum(first, src - k).astype(np.int32)
    w = np.stack([dense[i, lo[i]:lo[i] + k] for i in range(dst)]).astype(np.float32)
    return lo, np.ascontiguousarray(w), k


# Shared memory of one H100 SM (NVIDIA's Hopper tuning guide): 228 KB, of
# which a block may take up to 227 KB, and 1 KB is reserved for each block.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
THREADS_PER_SM = 2048
THREADS = 256  # kThreads in the source
HEADER_BYTES = 32  # kHeaderBytes in the source: two mbarriers
BANDS = (2, 1)  # the band heights G the plan tries, tallest first


class BandPlan(NamedTuple):
    g: int  # YOLO output rows per work item
    plan: np.ndarray  # (n_bands, 4) int32: load_lo, load_hi, own_lo, own_hi source rows
    rows: int  # the most source rows a band loads
    crows: int  # the most chroma rows a band loads
    raw_bytes: int  # one buffer of raw Y, U and V rows
    smem_bytes: int  # dynamic shared memory of a block: the decoded rows and two raw buffers

    @property
    def blocks_per_sm(self) -> int:
        return min(THREADS_PER_SM // THREADS, SMEM_PER_SM // (self.smem_bytes + 1024))


def band_plan(height: int, width: int, size: int, g: int) -> BandPlan:
    """The kernel's work items for one frame: band ``b`` computes YOLO rows
    ``[b g, (b + 1) g)``, loads the source rows ``[load_lo, load_hi)`` that
    their INTER_AREA taps touch, and writes the BGR output of the source
    rows ``[own_lo, own_hi)``. The own ranges start at each band's first
    loaded row (0 for the first band) and end where the next band's start,
    so they tile ``[0, height)`` and each lies inside its band's load
    range: consecutive output rows' tap ranges touch or overlap."""
    lo, _, k = band_tables(height, size)
    first = np.arange(0, size, g)
    last = np.minimum(first + g, size) - 1
    load_lo, load_hi = lo[first], lo[last] + k
    own_lo = np.concatenate([[0], load_lo[1:]])
    own_hi = np.concatenate([own_lo[1:], [height]])
    plan = np.stack([load_lo, load_hi, own_lo, own_hi], axis=1).astype(np.int32)
    rows = int((load_hi - load_lo).max())
    crows = int((((load_hi - 1) >> 1) - (load_lo >> 1) + 1).max())
    raw = rows * width + 2 * crows * (width // 2)
    smem = HEADER_BYTES + rows * width * 12 + 2 * raw
    return BandPlan(g, np.ascontiguousarray(plan), rows, crows, raw, smem)


@functools.lru_cache(maxsize=None)
def choose_plan(height: int, width: int, size: int, batch: int, sms: int) -> BandPlan:
    """The tallest band of ``BANDS`` whose block leaves room for a second
    block on an SM and whose work items, ``batch`` frames of bands, give
    each of the ``sms`` SMs one; else the shortest band that fits. An H100
    ran B=16 480x640 S=256 fastest at G=2 (G=4 5% and G=1 2% slower) and
    B=1 at G=1 (``kernel_bench.py``, PERF.md). ValueError when not even
    one output row fits."""
    fits = [plan for plan in (band_plan(height, width, size, g) for g in BANDS)
            if plan.blocks_per_sm >= 2]
    if not fits:
        raise ValueError(f"fused_i420_inputs: a band of {height}x{width} -> {size} needs "
                         f"more shared memory than two blocks of an SM can hold")
    return next((plan for plan in fits if batch * len(plan.plan) >= sms), fits[-1])


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _device_tables(height: int, width: int, size: int, g: int, device: str):
    """The banded weights and the band plan on the device, built once per
    shape (before any CUDA graph capture: the first call is eager)."""
    put = lambda a: torch.from_numpy(a).to(device)
    row_lo, row_w, kr = band_tables(height, size)
    col_lo, col_w, kc = band_tables(width, size)
    plan = band_plan(height, width, size, g)
    return put(row_lo), put(row_w), kr, put(col_lo), put(col_w), kc, put(plan.plan)


def fused_i420_reference(yuv: torch.Tensor, height: int, yolo_size: int = 256):
    """Plain PyTorch version: ``i420_to_bgr`` then ``yolo_preprocess``, float32."""
    bgr = i420_to_bgr(yuv, height)
    return bgr, yolo_preprocess(bgr, yolo_size)


def fused_i420_inputs(yuv: torch.Tensor, height: int, yolo_size: int = 256):
    """Planar I420 -> (BGR float frame, YOLO input), in the JAX layout.

    yuv: (height*3/2, W) or (B, height*3/2, W) uint8. Returns ``bgr``
    (..., height, W, 3) float32 and ``yolo`` (..., 1, S, S, 3) float32 RGB/255.
    On CUDA the YOLO input is a view of an NCHW (B, 3, S, S) buffer, so
    ``yolo[:, 0].permute(0, 3, 1, 2)`` is contiguous.
    """
    if yuv.device.type == "cpu":
        return fused_i420_reference(yuv, height, yolo_size)
    if yuv.device.type != "cuda":
        raise ValueError(f"fused_i420_inputs: unsupported device {yuv.device}")
    single = yuv.dim() == 2
    if single:
        yuv = yuv.unsqueeze(0)
    if yuv.dim() != 3 or yuv.dtype != torch.uint8 or not yuv.is_contiguous():
        raise ValueError(f"fused_i420_inputs: want contiguous (B, H*3/2, W) uint8, got "
                         f"{tuple(yuv.shape)} {yuv.dtype} contiguous={yuv.is_contiguous()}")
    b, rows, width = yuv.shape
    if height % 4 or width % 2 or rows != height * 3 // 2:
        raise ValueError(f"fused_i420_inputs: {rows}x{width} is not an I420 frame of "
                         f"height {height} (height % 4 == 0 and even width required)")
    if width % 32 or yuv.data_ptr() % 16:
        raise ValueError(f"fused_i420_inputs: the bulk copies of the Y, U and V rows need "
                         f"16-byte alignment: width {width} must be a multiple of 32 and "
                         f"the frames 16-byte aligned")
    if b * max(height * width, yolo_size * yolo_size) * 3 >= 2**31:
        raise ValueError("fused_i420_inputs: batch too large for 32-bit indexing")
    dev = str(yuv.device)
    plan = choose_plan(height, width, yolo_size, b, _sm_count(dev))
    row_lo, row_w, kr, col_lo, col_w, kc, bands = _device_tables(
        height, width, yolo_size, plan.g, dev)
    grid = min(b * len(bands), plan.blocks_per_sm * _sm_count(dev))
    bgr = torch.empty((b, height, width, 3), dtype=torch.float32, device=yuv.device)
    yolo = torch.empty((b, 3, yolo_size, yolo_size), dtype=torch.float32, device=yuv.device)
    lib = _library()
    with torch.cuda.device(yuv.device):
        stream = torch.cuda.current_stream(yuv.device).cuda_stream
        err = lib.fused_i420_inputs(
            yuv.data_ptr(), bgr.data_ptr(), yolo.data_ptr(), b, height, width, yolo_size,
            plan.g, len(bands), plan.rows, plan.crows, plan.raw_bytes, plan.smem_bytes, grid,
            row_lo.data_ptr(), row_w.data_ptr(), kr, col_lo.data_ptr(), col_w.data_ptr(), kc,
            bands.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_i420_inputs: kernel launch failed with CUDA error {err}")
    fused_i420_inputs.launches += 1
    yolo = yolo.permute(0, 2, 3, 1).unsqueeze(1)
    return (bgr[0], yolo[0]) if single else (bgr, yolo)


fused_i420_inputs.launches = 0  # kernel launches; the CPU path does not count
