"""Camera geometry for the pose pipeline (port of ``isbfsar_tpu/ops/geometry.py``).

The crop gather truncates source coordinates, so a last-ulp change in the
homography flips whole crop pixels. The products here therefore reproduce,
bit for bit, what XLA computes for the JAX functions in float32: each dot
element is a chain of fused multiply-adds over the contraction index in
order, as are the vector norms, and a cross-product component is
``fma(a, b, -(c * d))``. A float32 fused multiply-add is emulated in
float64, where the product of two float32 values is exact, with one
rounding back to float32. Every op is elementwise, so the result is the
same on the CPU and on the card and does not depend on the batch size,
which a cuBLAS or MKL product does not promise. Batched over a leading
frame axis. The test-time augmentation's rotations are host numpy
(``tta_params``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding."""
    return (a.double() * b.double() + c.double()).float()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, n) @ (..., n, p) in float32, each element the FMA chain
    ``fma(a[n-1], b[n-1], ... fma(a[1], b[1], a[0] * b[0]))``."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = fma(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, its squares summed as an FMA chain.
    The square root is taken in float64 and rounded once: PyTorch's float32
    square root on the CPU is not always correctly rounded."""
    acc = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = fma(v[..., k], v[..., k], acc)
    out = torch.sqrt(acc.double()).float()
    return out[..., None] if keepdim else out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) x (..., 3), each component ``fma(a_i, b_j, -(a_j * b_i))``."""
    comps = [fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
             for i, j in ((1, 2), (2, 0), (0, 1))]
    return torch.stack(comps, dim=-1)


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def inv_intrinsics(k: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) upper-triangular intrinsics."""
    fx, s, cx = k[..., 0, 0], k[..., 0, 1], k[..., 0, 2]
    fy, cy = k[..., 1, 1], k[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], dim=-1)
    row1 = torch.stack([zero, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def project(points: torch.Tensor) -> torch.Tensor:
    return points[..., :2] / points[..., 2:3]


def is_within_fov(imcoords: torch.Tensor, lower: float = 18.0, upper: float = 238.0) -> torch.Tensor:
    """(..., 2) pixel coords -> bool (...,) inside [lower, upper] on both axes."""
    return ((imcoords >= lower) & (imcoords <= upper)).all(dim=-1)


def look_at_rotation(forward: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(b, 3) look directions -> (b, 3, 3) row-stacked [x; y; z] rotations."""
    new_z = forward / norm(forward, keepdim=True)
    new_x = cross(new_z, up.expand_as(new_z))
    alt_x = torch.stack([new_z[:, 2], torch.zeros_like(new_z[:, 2]), -new_z[:, 0]], dim=1)
    degenerate = norm(new_x, keepdim=True) == 0
    new_x = torch.where(degenerate, alt_x, new_x)
    new_x = new_x / norm(new_x, keepdim=True)
    new_y = cross(new_z, new_x)
    return torch.stack([new_x, new_y, new_z], dim=1)


def virtual_camera(x1, x2, y1, y2, intrinsics: torch.Tensor, out_dim: int):
    """Zoomed, derotated virtual camera looking at each pixel bbox.

    x1, x2, y1, y2: (b,) float32; intrinsics (3, 3).
    Returns (new_K (b, 3, 3), rotation (b, 3, 3)).
    """
    k = intrinsics.to(torch.float32)
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    pts = torch.stack([
        torch.stack([cx, cy], -1),
        torch.stack([cx, y1], -1),
        torch.stack([x2, cy], -1),
        torch.stack([cx, y2], -1),
        torch.stack([x1, cy], -1),
    ], dim=1)  # (b, 5, 2)
    inv_k = inv_intrinsics(k)
    cam = mm(to_homogeneous(pts), inv_k.t())
    cam = to_homogeneous(cam[..., :2])

    # the up vector (0, -1, 0), made on the device: a host copy cannot be
    # recorded into a CUDA graph
    up = torch.zeros((1, 3), dtype=torch.float32, device=k.device)
    up[:, 1] = -1.0
    rot = look_at_rotation(cam[:, 0], up)

    side = cam[:, 1:5]
    side_new = project(mm(side, mm(k, rot).transpose(1, 2)))
    vert = norm(side_new[:, 0] - side_new[:, 2])
    horiz = norm(side_new[:, 1] - side_new[:, 3])
    zoom = out_dim / torch.maximum(vert, horiz)  # (b,)

    new_k = torch.zeros((cx.shape[0], 3, 3), dtype=torch.float32, device=k.device)
    new_k[:, :2, :2] = k[:2, :2] * zoom[:, None, None]
    new_k[:, :2, 2] = out_dim / 2.0
    new_k[:, 2, 2] = 1.0
    return new_k, rot


def warp_matrix(intrinsics: torch.Tensor, new_k: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Full-frame -> crop homography ``K @ Rᵀ @ inv(new_K)``: (b, 3, 3)."""
    return mm(mm(intrinsics, rot.transpose(-1, -2)), inv_intrinsics(new_k))


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's math functions: XLA's CPU float32 ``sin`` and ``cos``
    give what ``sinf`` and ``cosf`` give, bit for bit, where numpy's and
    torch's float32 versions differ from them in the last place."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    return lib


def rotation_z(angle: np.ndarray) -> np.ndarray:
    """(n,) float32 angles -> (n, 3, 3) float32 rotations about the z axis,
    with the sines and cosines XLA computes for them on the CPU."""
    angle = np.asarray(angle, np.float32).reshape(-1)
    lib = _libm()
    sin = np.array([lib.sinf(float(a)) for a in angle], np.float32)
    cos = np.array([lib.cosf(float(a)) for a in angle], np.float32)
    zero, one = np.zeros_like(angle), np.ones_like(angle)
    return np.stack([np.stack([cos, -sin, zero], -1), np.stack([sin, cos, zero], -1),
                     np.stack([zero, zero, one], -1)], axis=-2)


def tta_params(num_aug: int):
    """Test-time augmentation parameters, host numpy: (should_flip (A,) bool,
    rotflip (A, 3, 3) float32, scales). As in the JAX package: aug i is
    flipped where (i - A//2) is odd, the angles leave out the linspace's
    end point, and the scales come out one short for an even A (the
    estimator pads them with the last)."""
    angle_range = np.float32(np.deg2rad(25))
    angles = np.linspace(-angle_range, angle_range, num_aug + 1)[:-1]
    scales = np.concatenate([
        np.linspace(0.8, 1.0, (num_aug + 1) // 2)[:-1],
        np.linspace(1.0, 1.1, num_aug - num_aug // 2),
    ], axis=0)
    should_flip = (np.arange(num_aug) - num_aug // 2) % 2 != 0
    flipmat = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    maybe_flip = np.where(should_flip[:, None, None], flipmat, np.eye(3, dtype=np.float32))
    rotflip = maybe_flip @ rotation_z(-angles)
    return should_flip, rotflip.astype(np.float32), scales
