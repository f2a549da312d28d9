"""Camera geometry for the pose pipeline (port of ``isbfsar_tpu/ops/geometry.py``).

The JAX functions pin ``Precision.HIGHEST``; here every product is a
float32 ``torch.matmul``, which runs in full float32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (the pipeline's
constructor pins it). Batched over a leading frame axis.
"""

from __future__ import annotations

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul for small geometric systems."""
    return torch.matmul(a, b)


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
    new_z = forward / torch.linalg.norm(forward, dim=-1, keepdim=True)
    new_x = torch.linalg.cross(new_z, up.expand_as(new_z), dim=-1)
    alt_x = torch.stack([new_z[:, 2], torch.zeros_like(new_z[:, 2]), -new_z[:, 0]], dim=1)
    degenerate = torch.linalg.norm(new_x, dim=-1, keepdim=True) == 0
    new_x = torch.where(degenerate, alt_x, new_x)
    new_x = new_x / torch.linalg.norm(new_x, dim=-1, keepdim=True)
    new_y = torch.linalg.cross(new_z, new_x, dim=-1)
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

    up = torch.tensor([[0.0, -1.0, 0.0]], dtype=torch.float32, device=k.device)
    rot = look_at_rotation(cam[:, 0], up)

    side = cam[:, 1:5]
    side_new = project(mm(side, mm(k, rot).transpose(1, 2)))
    vert = torch.linalg.norm(side_new[:, 0] - side_new[:, 2], dim=-1)
    horiz = torch.linalg.norm(side_new[:, 1] - side_new[:, 3], dim=-1)
    zoom = out_dim / torch.maximum(vert, horiz)  # (b,)

    new_k = torch.zeros((cx.shape[0], 3, 3), dtype=torch.float32, device=k.device)
    new_k[:, :2, :2] = k[:2, :2] * zoom[:, None, None]
    new_k[:, :2, 2] = out_dim / 2.0
    new_k[:, 2, 2] = 1.0
    return new_k, rot


def warp_matrix(intrinsics: torch.Tensor, new_k: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Full-frame -> crop homography ``K @ Rᵀ @ inv(new_K)``: (b, 3, 3)."""
    return mm(mm(intrinsics, rot.transpose(-1, -2)), inv_intrinsics(new_k))
