"""Fused I420 input stage: decode + INTER_AREA resize + normalize, one pass.

Port of the TPU kernel ``isbfsar_tpu/ops/pallas_input.py::fused_i420_inputs``
as the hand-written CUDA kernel ``csrc/fused_i420.cu`` (sm_90a), built with
nvcc into ``build/isbfsar_tpu_torch/`` beside the package on first use and
loaded with ctypes. Its bound on an H100 is bytes: 78.9 MB for a batch of
16 480x640 frames at S = 256, about 23.6 us at 3.35 TB/s (the note at the
head of the source has the count).

:func:`fused_i420_inputs` launches the kernel for a CUDA tensor and runs
the plain version (:func:`fused_i420_reference`, ``i420_to_bgr`` then
``yolo_preprocess`` in float32) for a CPU tensor. A CUDA tensor gets the
kernel or an error, never the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.ops.image import _area_weights, i420_to_bgr, yolo_preprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_i420.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "isbfsar_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: str
    seconds: float  # 0.0 when the library for this source was already built
    log: str  # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused I420 kernel needs the CUDA toolkit")
    return path


def build() -> BuildInfo:
    """Compile ``csrc/fused_i420.cu`` unless a library of this exact source exists."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libfused_i420-{digest}.so")
    if os.path.exists(out):
        return BuildInfo(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build().path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_i420_inputs.argtypes = [p, p, p, i, i, i, i, p, p, i, p, p, i, p]
    lib.fused_i420_inputs.restype = ctypes.c_int
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


@functools.lru_cache(maxsize=None)
def _device_tables(src: int, dst: int, device: str):
    lo, w, k = band_tables(src, dst)
    return torch.from_numpy(lo).to(device), torch.from_numpy(w).to(device), k


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
    if b * max(height * width, yolo_size * yolo_size) * 3 >= 2**31:
        raise ValueError("fused_i420_inputs: batch too large for 32-bit indexing")
    dev = str(yuv.device)
    row_lo, row_w, kr = _device_tables(height, yolo_size, dev)
    col_lo, col_w, kc = _device_tables(width, yolo_size, dev)
    bgr = torch.empty((b, height, width, 3), dtype=torch.float32, device=yuv.device)
    yolo = torch.empty((b, 3, yolo_size, yolo_size), dtype=torch.float32, device=yuv.device)
    lib = _library()
    with torch.cuda.device(yuv.device):
        stream = torch.cuda.current_stream(yuv.device).cuda_stream
        err = lib.fused_i420_inputs(
            yuv.data_ptr(), bgr.data_ptr(), yolo.data_ptr(), b, height, width, yolo_size,
            row_lo.data_ptr(), row_w.data_ptr(), kr, col_lo.data_ptr(), col_w.data_ptr(), kc,
            stream)
    if err != 0:
        raise RuntimeError(f"fused_i420_inputs: kernel launch failed with CUDA error {err}")
    fused_i420_inputs.launches += 1
    yolo = yolo.permute(0, 2, 3, 1).unsqueeze(1)
    return (bgr[0], yolo[0]) if single else (bgr, yolo)


fused_i420_inputs.launches = 0  # kernel launches; the CPU path does not count
