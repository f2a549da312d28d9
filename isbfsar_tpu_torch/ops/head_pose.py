"""The focus geometry of a frame from its six face landmarks: the
hand-written CUDA kernel ``csrc/head_pose.cu`` (sm_90a) and its wrapper.

The kernel runs the 40-iteration PnP of
``focus/geometry.py::head_pose_from_landmarks``, each Procrustes step
solved by QCP, and then the geometry the focus step reads from its
result (``rotmat_to_rotvec``, ``normalization_camera`` and the head's
rotation vector in the normalized camera), one thread per frame, in
float64 registers, in one launch (the head of the source says why). It is
built with nvcc into ``build/isbfsar_tpu_torch/`` at first use
(``ops/build.py``) and loaded with ctypes.

:func:`focus_geometry` launches the kernel for a CUDA tensor and runs the
plain version, :func:`focus_geometry_reference` (the same functions of
``focus/geometry.py`` composed), for a CPU tensor. A CUDA tensor gets the
kernel or an error, never the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from isbfsar_tpu_torch.focus import geometry
from isbfsar_tpu_torch.ops import build as _build
from isbfsar_tpu_torch.ops.geometry import mm

MAX_NEWTON = 16  # kMaxNewton in the source: Newton steps in one iteration at most

# float64 operations of the source, counted from it (an add, a multiply, a
# square root, a reciprocal, a division, an arc cosine or a sine counts as
# one; a fused multiply-add as two): per frame outside the iterations
# (rays, the model's moments, the center, the normalizing camera, the warp
# and both rotation vectors), per iteration outside the Newton steps (lift,
# means, spread, H, the quartic's coefficients, the adjugate, the rotation,
# the translation, the depths), and per Newton step
OPS_PER_FRAME = 291
OPS_PER_ITERATION = 564
OPS_PER_NEWTON_STEP = 14


def operations(frames: int, iters: int, newton_steps: int) -> int:
    """float64 operations of a launch over ``frames`` frames whose Newton
    steps, summed over frames and iterations, come to ``newton_steps``."""
    return frames * (OPS_PER_FRAME + iters * OPS_PER_ITERATION) + newton_steps * OPS_PER_NEWTON_STEP


class FocusGeometry(NamedTuple):
    """Per-frame focus geometry, float32 with a leading batch axis."""

    rot: torch.Tensor  # (B, 3, 3) head rotation, camera frame
    center: torch.Tensor  # (B, 3) head center, metres
    rotvec: torch.Tensor  # (B, 3) rotmat_to_rotvec(rot)
    warp: torch.Tensor  # (B, 3, 3) normalized-crop pixels -> frame pixels
    r_norm: torch.Tensor  # (B, 3, 3) the normalizing rotation
    head_rot2d: torch.Tensor  # (B, 2) rotmat_to_rotvec(r_norm @ rot)[:, :2]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build("head_pose").path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.focus_geometry.argtypes = [p] * 10 + [i, f, f, f, f, i, p]
    lib.focus_geometry.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _canonical(device: str) -> torch.Tensor:
    """The canonical face on the device, made once (before any CUDA graph
    capture: the first call is eager)."""
    return torch.from_numpy(geometry.CANONICAL_FACE_3D).to(device)


def geometry_of_pose(rot: torch.Tensor, center: torch.Tensor, intrinsics: torch.Tensor,
                     norm_distance: float = 0.6, out_size: int = 224) -> FocusGeometry:
    """The plain geometry the focus step derives from a head pose."""
    warp, r_norm = geometry.normalization_camera(center, intrinsics, norm_distance, out_size)
    return FocusGeometry(rot, center, geometry.rotmat_to_rotvec(rot), warp, r_norm,
                         geometry.rotmat_to_rotvec(mm(r_norm, rot))[..., :2])


def focus_geometry_reference(landmarks_px: torch.Tensor, intrinsics: torch.Tensor,
                             assumed_depth: float = 0.6, norm_distance: float = 0.6,
                             out_size: int = 224, iters: int = 40) -> FocusGeometry:
    """The plain version: ``focus/geometry.py``'s functions composed as the
    focus step applies them."""
    rot, center = geometry.head_pose_from_landmarks(landmarks_px, intrinsics, assumed_depth, iters)
    return geometry_of_pose(rot, center, intrinsics, norm_distance, out_size)


def focus_geometry(landmarks_px: torch.Tensor, intrinsics: torch.Tensor,
                   assumed_depth: float = 0.6, norm_distance: float = 0.6, out_size: int = 224,
                   iters: int = 40, steps: Optional[torch.Tensor] = None) -> FocusGeometry:
    """(B, 6, 2) float32 pixel landmarks, (3, 3) float32 upper-triangular
    intrinsics -> :class:`FocusGeometry`.

    steps: an optional (B, 2) int32 CUDA tensor that receives, per frame,
    the Newton steps over all iterations (what the work depends on) and the
    most that one iteration took (at most ``MAX_NEWTON``).
    """
    if landmarks_px.device.type == "cpu":
        return focus_geometry_reference(landmarks_px, intrinsics, assumed_depth, norm_distance,
                                        out_size, iters)
    if landmarks_px.device.type != "cuda":
        raise ValueError(f"focus_geometry: unsupported device {landmarks_px.device}")
    if iters < 1:
        raise ValueError("focus_geometry needs iters >= 1")
    if out_size < 1:
        raise ValueError("focus_geometry needs out_size >= 1")
    b = landmarks_px.shape[0]
    for name, t, shape, dtype in (("landmarks", landmarks_px, (b, 6, 2), torch.float32),
                                  ("intrinsics", intrinsics, (3, 3), torch.float32),
                                  ("steps", steps, (b, 2), torch.int32)):
        if t is not None and (t.dtype != dtype or t.device != landmarks_px.device
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"focus_geometry: want contiguous {dtype} {name} of shape {shape} "
                             f"on {landmarks_px.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    out = FocusGeometry(*(torch.empty(shape, dtype=torch.float32, device=landmarks_px.device)
                          for shape in ((b, 3, 3), (b, 3), (b, 3), (b, 3, 3), (b, 3, 3), (b, 2))))
    if b == 0:
        return out
    model = _canonical(str(landmarks_px.device))
    lib = _library()
    with torch.cuda.device(landmarks_px.device):
        stream = torch.cuda.current_stream(landmarks_px.device).cuda_stream
        err = lib.focus_geometry(
            landmarks_px.data_ptr(), intrinsics.data_ptr(), model.data_ptr(),
            *(t.data_ptr() for t in out), None if steps is None else steps.data_ptr(), b,
            float(assumed_depth), float(norm_distance), geometry.focal_length(out_size),
            out_size / 2.0, int(iters), stream)
    if err != 0:
        raise RuntimeError(f"focus_geometry: kernel launch failed with CUDA error {err}")
    focus_geometry.launches += 1
    return out


focus_geometry.launches = 0  # kernel launches; the CPU path does not count
