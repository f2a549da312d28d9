"""Head pose from six face landmarks: the hand-written CUDA kernel
``csrc/head_pose.cu`` (sm_90a) and its wrapper.

The kernel runs the 40-iteration PnP of
``focus/geometry.py::head_pose_from_landmarks`` with one thread per
frame, in float64 registers, in one launch (the head of the source says
why). It is built with nvcc into ``build/isbfsar_tpu_torch/`` at first use
(``ops/build.py``) and loaded with ctypes.

:func:`head_pose_from_landmarks` launches the kernel for a CUDA tensor and
runs the plain version (``focus/geometry.py``) for a CPU tensor. A CUDA
tensor gets the kernel or an error, never the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from isbfsar_tpu_torch.focus import geometry
from isbfsar_tpu_torch.ops import build as _build


# float64 operations of the source, counted from it (a square root or a
# division counts as one): per frame before the loop, per iteration outside
# the Jacobi sweeps, and per sweep (three column-pair rotations)
OPS_PER_FRAME = 100
OPS_PER_ITERATION = 530
OPS_PER_SWEEP = 192


def operations(frames: int, iters: int, sweeps: int) -> int:
    """float64 operations of a launch over ``frames`` frames whose Jacobi
    sweeps, summed over frames and iterations, come to ``sweeps``."""
    return frames * (OPS_PER_FRAME + iters * OPS_PER_ITERATION) + sweeps * OPS_PER_SWEEP


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build("head_pose").path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.head_pose_from_landmarks.argtypes = [p, p, p, p, p, p, i, f, i, p]
    lib.head_pose_from_landmarks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _canonical(device: str) -> torch.Tensor:
    """The canonical face on the device, made once (before any CUDA graph
    capture: the first call is eager)."""
    return torch.from_numpy(geometry.CANONICAL_FACE_3D).to(device)


def head_pose_from_landmarks(landmarks_px: torch.Tensor, intrinsics: torch.Tensor,
                             assumed_depth: float = 0.6, iters: int = 40,
                             sweeps: Optional[torch.Tensor] = None):
    """(B, 6, 2) float32 pixel landmarks, (3, 3) float32 intrinsics ->
    (rot (B, 3, 3), center (B, 3)) float32.

    sweeps: an optional (B,) int32 CUDA tensor that receives the Jacobi
    sweeps each frame took over all iterations (what the work depends on).
    """
    if landmarks_px.device.type == "cpu":
        return geometry.head_pose_from_landmarks(landmarks_px, intrinsics, assumed_depth, iters)
    if landmarks_px.device.type != "cuda":
        raise ValueError(f"head_pose_from_landmarks: unsupported device {landmarks_px.device}")
    if iters < 1:
        raise ValueError("head_pose_from_landmarks needs iters >= 1")
    for name, t, shape in (("landmarks", landmarks_px, (landmarks_px.shape[0], 6, 2)),
                           ("intrinsics", intrinsics, (3, 3))):
        if (t.dtype != torch.float32 or t.device != landmarks_px.device
                or tuple(t.shape) != shape or not t.is_contiguous() or t.dim() != len(shape)):
            raise ValueError(f"head_pose_from_landmarks: want contiguous float32 {name} of shape "
                             f"{shape} on {landmarks_px.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    b = landmarks_px.shape[0]
    if sweeps is not None and (sweeps.dtype != torch.int32 or tuple(sweeps.shape) != (b,)
                               or sweeps.device != landmarks_px.device):
        raise ValueError("head_pose_from_landmarks: sweeps must be a (B,) int32 tensor on the card")
    rot = torch.empty((b, 3, 3), dtype=torch.float32, device=landmarks_px.device)
    center = torch.empty((b, 3), dtype=torch.float32, device=landmarks_px.device)
    if b == 0:
        return rot, center
    model = _canonical(str(landmarks_px.device))
    lib = _library()
    with torch.cuda.device(landmarks_px.device):
        stream = torch.cuda.current_stream(landmarks_px.device).cuda_stream
        err = lib.head_pose_from_landmarks(
            landmarks_px.data_ptr(), intrinsics.data_ptr(), model.data_ptr(), rot.data_ptr(),
            center.data_ptr(), None if sweeps is None else sweeps.data_ptr(), b,
            float(assumed_depth), int(iters), stream)
    if err != 0:
        raise RuntimeError(f"head_pose_from_landmarks: kernel launch failed with CUDA error {err}")
    head_pose_from_landmarks.launches += 1
    return rot, center


head_pose_from_landmarks.launches = 0  # kernel launches; the CPU path does not count
