"""Absolute 3D pose reconstruction (port of ``isbfsar_tpu/ops/reconstruct.py``).

Weighted least squares for the camera-space reference point with
``np.linalg.lstsq``'s cutoff, in closed form and all in float32.
"""

from __future__ import annotations

import torch

from isbfsar_tpu_torch.ops.geometry import inv_intrinsics, mm, to_homogeneous


def _rms_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=1, keepdim=True))


def reconstruct_reference_point(normalized_2d, coords3d_rel, validity) -> torch.Tensor:
    """(b, j, 2), (b, j, 3), (b, j) -> (b, 3) camera-space reference point.

    The JAX function solves the weighted system ``diag(w) [I_2, -u_j] t =
    diag(w) b_j`` with an SVD pseudo-inverse at ``np.linalg.lstsq``'s cutoff.
    A CUDA SVD reads its convergence flag on the host, which a CUDA graph
    cannot hold, so this solves the same system in closed form with
    elementwise ops and sums over the joints. With weights ``o = w^2`` and
    weighted means ``u_m``, ``b_m``, the normal matrix has the eigenvalue
    ``W = sum o`` (direction ``(-u_my, u_mx, 0)``) and the two of
    ``[[W, -W r], [-W r, C + W r^2]]`` on ``{(u_m / r, 0), e_z}``, where
    ``r = |u_m|`` and ``C = sum o |u - u_m|^2``. The least-squares point is
    ``t_z = -sum o (u - u_m).(b - b_m) / C`` and ``t_xy = b_m + u_m t_z``.
    When the smallest singular value ``sqrt(W C / lambda_max)`` is at or
    under the cutoff (the 2D decode collapsed onto one point), the
    solution keeps the other two singular directions only, as the
    pseudo-inverse does. ``sqrt(W)`` never falls under the cutoff: it is at
    least ``s_max / sqrt(2j + 1)``.
    """
    b, j, _ = normalized_2d.shape
    flat2d = normalized_2d.reshape(b, 2 * j)
    scale2d = _rms_scale(flat2d)
    u = (flat2d / scale2d).reshape(b, j, 2)

    rel_backproj = normalized_2d * coords3d_rel[..., 2:] - coords3d_rel[..., :2]
    flat_b = rel_backproj.reshape(b, 2 * j)
    scale_b = _rms_scale(flat_b)
    rhs = (flat_b / scale_b).reshape(b, j, 2)

    w = validity.to(normalized_2d.dtype) + 1e-4
    o = (w * w)[..., None]  # (b, j, 1)
    total = o.sum(dim=1)  # (b, 1): W
    u_m = (o * u).sum(dim=1) / total  # (b, 2)
    b_m = (o * rhs).sum(dim=1) / total
    du, db = u - u_m[:, None], rhs - b_m[:, None]
    spread = (o[..., 0] * (du * du).sum(dim=-1)).sum(dim=1, keepdim=True)  # (b, 1): C
    cov = (o[..., 0] * (du * db).sum(dim=-1)).sum(dim=1, keepdim=True)
    t_z = -cov / spread
    full = torch.cat([b_m + u_m * t_z, t_z], dim=1)

    r2 = (u_m * u_m).sum(dim=1, keepdim=True)
    s = spread + total * r2
    lam_max = (total + s + torch.sqrt((total - s) ** 2 + 4.0 * total * total * r2)) / 2.0
    lam_min = total * spread / lam_max
    eps = torch.finfo(normalized_2d.dtype).eps
    keep = torch.sqrt(lam_min) > torch.sqrt(lam_max) * (max(2 * j, 3) * eps)

    # the pseudo-inverse without the smallest singular direction
    g_xy = total * b_m  # (b, 2): the x, y rows of A^T diag(o) b
    g_z = -(o[..., 0] * (u * rhs).sum(dim=-1)).sum(dim=1, keepdim=True)
    g_par = (g_xy * u_m).sum(dim=1, keepdim=True)
    e2 = total * total * r2 + (total - lam_max) ** 2
    c = (total * g_par + (total - lam_max) * g_z) / (torch.clamp(e2, min=1e-30) * lam_max)
    perp = (g_xy - g_par * u_m / torch.clamp(r2, min=1e-30)) / total
    trunc = torch.cat([perp + total * u_m * c, (total - lam_max) * c], dim=1)

    ref = torch.where(keep, full, trunc)
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
