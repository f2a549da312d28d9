"""Face and gaze geometry (port of ``isbfsar_tpu/focus/geometry.py``).

Head pose from six landmarks by an iterative weak-perspective PnP,
ETH-XGaze-style camera normalization, and the rotation helpers of the
focus heuristics. Batched over a leading frame axis.

``rotmat_to_rotvec``, ``normalization_camera`` and ``denormalize_gaze``
are elementwise chains: a CUDA graph cannot hold ``torch.linalg.inv``,
``det`` or ``svd``, which wait for the host on CUDA. The 3x3 inverse is
taken by cofactors, and the products, norms and cross products are those
of ``ops/geometry.py``.

:func:`head_pose_from_landmarks` here, followed by ``rotmat_to_rotvec``
and ``normalization_camera``, is the plain version of the CUDA kernel in
``ops/head_pose.py`` (``focus_geometry_reference`` there composes them):
it serves CPU tensors and is the kernel's oracle on the card, outside any
graph. On the card the focus step runs the kernel and calls
``denormalize_gaze`` alone from here.
"""

from __future__ import annotations

import numpy as np
import torch

from isbfsar_tpu_torch.ops.geometry import cross, inv_intrinsics, mm, norm, to_homogeneous

# Canonical 3D landmark model (meters, camera-facing, origin at the face
# center): right eye, left eye, nose tip, mouth center, right ear, left ear.
CANONICAL_FACE_3D = np.array(
    [
        [-0.032, -0.025, 0.00],
        [0.032, -0.025, 0.00],
        [0.000, 0.010, -0.03],
        [0.000, 0.045, -0.01],
        [-0.070, 0.000, 0.03],
        [0.070, 0.000, 0.03],
    ],
    np.float32,
)

# The lifted landmarks count as one point when their RMS spread is below
# this fraction of their distance (see head_pose_from_landmarks).
DEGENERATE_SPREAD = 1e-6


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def rotmat_to_rotvec(r: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: (..., 3, 3) -> (..., 3) axis-angle vector, with the
    angle ~ pi branch handled explicitly (the antisymmetric part vanishes
    there, and a near-pi head rotation must not read as frontal)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    angle = torch.arccos(cos)
    axis_raw = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                            r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    sin = torch.sin(angle)
    half = torch.full_like(angle, 0.5)
    scale = torch.where(torch.abs(sin) > 1e-6, angle / (2.0 * sin + 1e-12), half)
    rotvec_generic = axis_raw * scale[..., None]

    # angle ~ pi: R + I == 2 a a^T; |axis| from the diagonal, signs from the
    # column of (R + I) / 2 with the largest diagonal entry
    b = (r + _eye(r)) / 2.0
    diag = torch.stack([b[..., 0, 0], b[..., 1, 1], b[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(b, -1, k[..., None, None].expand(*b.shape[:-1], 1))[..., 0]
    axis_pi = col / (norm(col, keepdim=True) + 1e-12)
    rotvec_pi = axis_pi * angle[..., None]

    near_pi = (cos < -1.0 + 1e-4)[..., None]
    return torch.where(near_pi, rotvec_pi, rotvec_generic)


def _svd_rotation(h: torch.Tensor):
    """Procrustes core: the proper rotation from the (..., 3, 3)
    cross-covariance ``h``, reflection corrected by the determinant sign,
    exactly as the JAX function writes it. Returns (rot, svals, d)."""
    u, svals, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(mm(u, vt).transpose(-1, -2)))
    flip = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return mm(mm(u, flip), vt).transpose(-1, -2), svals, d


def kabsch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Optimal rotation aligning src -> dst, both (..., n, 3)."""
    src_c = src - src.mean(dim=-2, keepdim=True)
    dst_c = dst - dst.mean(dim=-2, keepdim=True)
    rot, _, _ = _svd_rotation(mm(src_c.transpose(-1, -2), dst_c))
    return rot


def umeyama(src: torch.Tensor, dst: torch.Tensor):
    """Similarity Procrustes over (..., n, 3): (rot, scale, t) with
    dst ~ scale * rot @ src + t."""
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    sc, dc = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    rot, svals, d = _svd_rotation(mm(sc.transpose(-1, -2), dc))
    scale = (svals[..., 0] + svals[..., 1] + svals[..., 2] * d) / torch.clamp(
        (sc ** 2).sum(dim=(-2, -1)), min=1e-12)
    t = mu_d - scale[..., None] * mm(rot, mu_s[..., :, None])[..., 0]
    return rot, scale, t


def head_pose_from_landmarks(landmarks_px: torch.Tensor, intrinsics: torch.Tensor,
                             assumed_depth: float = 0.6, iters: int = 40):
    """Head rotation and metric position from six 2D landmarks.

    landmarks_px (..., 6, 2) pixels, intrinsics (3, 3). Back-projects the
    landmarks to rays, then ``iters`` times: lifts the rays at the current
    depths, fits the canonical model to the lifted points with a
    similarity Procrustes (:func:`umeyama`), and re-lifts each ray at the
    aligned model's depth. Returns (rot (..., 3, 3), center (..., 3)),
    the center being the mean of the aligned model's points.

    Degenerate landmarks: when the lifted points have no spread (RMS below
    ``DEGENERATE_SPREAD`` of their distance; six landmarks at one pixel),
    the cross-covariance is zero up to rounding, the fitted scale is zero,
    and the reference's next depths come from a translation divided by
    1e-6, so its later iterations blow up (to NaN at the principal point).
    Here such an iteration takes the rotation the reference takes for an
    exactly zero cross-covariance, the identity, and keeps the depths, so
    the result is finite and the same in float32 and float64.
    """
    if iters < 1:
        raise ValueError("head_pose_from_landmarks needs iters >= 1")
    rays = mm(to_homogeneous(landmarks_px), inv_intrinsics(intrinsics).transpose(-1, -2))
    canonical = torch.from_numpy(CANONICAL_FACE_3D).to(rays.device)
    canonical = canonical.expand(*rays.shape[:-2], 6, 3)
    depth = torch.full_like(rays[..., 2:3], assumed_depth)
    eye = _eye(rays)
    for _ in range(iters):
        lifted = rays * depth
        rot, scale, t = umeyama(canonical, lifted)
        spread = ((lifted - lifted.mean(dim=-2, keepdim=True)) ** 2).sum(dim=(-2, -1))
        dist = (lifted.mean(dim=-2) ** 2).sum(dim=-1)
        degenerate = spread <= DEGENERATE_SPREAD ** 2 * 6 * dist
        rot = torch.where(degenerate[..., None, None], eye, rot)
        scale = torch.where(degenerate, torch.zeros_like(scale), scale)
        t = torch.where(degenerate[..., None], lifted.mean(dim=-2), t)
        t_metric = t / torch.clamp(scale, min=1e-6)[..., None]
        model_cam = mm(canonical, rot.transpose(-1, -2)) + t_metric[..., None, :]
        depth = torch.where(degenerate[..., None, None], depth, model_cam[..., 2:3])
    center = model_cam.mean(dim=-2)
    return rot, center


def inv3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverse by cofactors (elementwise, so a CUDA graph holds it)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def focal_length(out_size: int) -> float:
    """The normalized camera's default focal length: 960 at a 224 crop,
    scaled with the crop (ETH-XGaze's face convention)."""
    return 960.0 * out_size / 224.0


def normalization_camera(face_center: torch.Tensor, intrinsics: torch.Tensor,
                         norm_distance: float = 0.6, out_size: int = 224,
                         focal_norm: float = None):
    """ETH-XGaze normalization: a virtual camera looking at the face.

    face_center (..., 3), intrinsics (3, 3). Returns (warp (..., 3, 3)
    mapping normalized-crop pixels to frame pixels, r_norm (..., 3, 3) the
    normalizing rotation). The scale moves the face to ``norm_distance``;
    the focal length defaults to 960 at a 224 crop, scaled with ``out_size``.
    """
    if focal_norm is None:
        focal_norm = focal_length(out_size)
    z_axis = face_center / norm(face_center, keepdim=True)
    down = torch.zeros_like(z_axis)
    down[..., 1] = 1.0
    x_axis = cross(down, z_axis)
    x_axis = x_axis / norm(x_axis, keepdim=True)
    y_axis = cross(z_axis, x_axis)
    r_norm = torch.stack([x_axis, y_axis, z_axis], dim=-2)  # rows

    scale = norm_distance / norm(face_center)
    scaled = torch.cat([r_norm[..., :2, :], r_norm[..., 2:, :] * scale[..., None, None]], dim=-2)
    # filled through slices: a fill kernel each, where an element assignment
    # would copy a scalar from the host, which a CUDA graph cannot hold
    cam_norm = torch.zeros((3, 3), dtype=torch.float32, device=face_center.device)
    cam_norm[0:1, 0:1] = focal_norm
    cam_norm[1:2, 1:2] = focal_norm
    cam_norm[:2, 2:] = out_size / 2.0
    cam_norm[2:, 2:] = 1.0
    # normalized-pixel -> frame-pixel homography (the inverse of the usual chain)
    fwd = mm(mm(cam_norm, scaled), inv_intrinsics(intrinsics))
    warp = inv3(fwd)
    return warp / warp[..., 2:3, 2:3], r_norm


def denormalize_gaze(gaze_vec_norm: torch.Tensor, r_norm: torch.Tensor) -> torch.Tensor:
    """Gaze vector in the normalized camera frame -> the original camera frame."""
    return mm(r_norm.transpose(-1, -2), gaze_vec_norm[..., None])[..., 0]
