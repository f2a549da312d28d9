"""Absolute 3D pose reconstruction (port of ``isbfsar_tpu/ops/reconstruct.py``).

Weighted least squares for the camera-space reference point, solved with
an SVD pseudo-inverse at ``np.linalg.lstsq``'s default cutoff, all in
float32 (``torch.matmul`` is full float32 with TF32 off).
"""

from __future__ import annotations

import torch

from isbfsar_tpu_torch.ops.geometry import inv_intrinsics, mm, to_homogeneous


def _rms_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=1, keepdim=True))


def reconstruct_reference_point(normalized_2d, coords3d_rel, validity) -> torch.Tensor:
    """(b, j, 2), (b, j, 3), (b, j) -> (b, 3) camera-space reference point."""
    b, j, _ = normalized_2d.shape
    flat2d = normalized_2d.reshape(b, 2 * j)
    scale2d = _rms_scale(flat2d)
    unit2d = flat2d / scale2d

    eye = torch.eye(2, dtype=normalized_2d.dtype, device=normalized_2d.device).repeat(j, 1)
    a = torch.cat([eye.expand(b, 2 * j, 2), -unit2d[..., None]], dim=2)

    rel_backproj = normalized_2d * coords3d_rel[..., 2:] - coords3d_rel[..., :2]
    flat_b = rel_backproj.reshape(b, 2 * j)
    scale_b = _rms_scale(flat_b)
    rhs = (flat_b / scale_b)[..., None]

    w = validity.to(normalized_2d.dtype) + 1e-4
    w = w.repeat_interleave(2, dim=-1)[..., None]

    aw = a * w
    bw = rhs * w
    u, s, vt = torch.linalg.svd(aw, full_matrices=False)
    eps = torch.finfo(s.dtype).eps
    cutoff = s[..., :1] * (max(aw.shape[-2:]) * eps)
    s_inv = torch.where(s > cutoff, 1.0 / torch.clamp(s, min=1e-30), torch.zeros_like(s))
    utb = torch.einsum("bri,brk->bik", u, bw)
    x = torch.einsum("bij,bjk->bik", vt.transpose(1, 2), s_inv[..., None] * utb)
    ref = x[..., 0]
    return torch.cat([ref[:, :2], ref[:, 2:] / scale2d], dim=1) * scale_b


def back_project(camcoords2d, delta_z, z_offset) -> torch.Tensor:
    return to_homogeneous(camcoords2d) * (delta_z + z_offset[:, None])[..., None]


def reconstruct_absolute(coords2d, coords3d_rel, intrinsics, in_fov) -> torch.Tensor:
    """coords2d (b, j, 2) px; coords3d_rel (b, j, 3); intrinsics (b, 3, 3);
    in_fov (b, j) bool -> (b, j, 3) absolute camera-space joints."""
    inv_k = inv_intrinsics(intrinsics.to(torch.float32))
    normalized = mm(to_homogeneous(coords2d), inv_k.transpose(1, 2))[..., :2]
    ref = reconstruct_reference_point(normalized, coords3d_rel, in_fov)
    abs_from_3d = coords3d_rel + ref[:, None]
    abs_from_2d = back_project(normalized, coords3d_rel[..., 2], ref[:, 2])
    return torch.where(in_fov[..., None], abs_from_2d, abs_from_3d)
