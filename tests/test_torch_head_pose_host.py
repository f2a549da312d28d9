"""The focus-geometry kernel's own arithmetic on the CPU.

``isbfsar_tpu_torch/csrc/head_pose.cu`` is plain C++ when nvcc does not
compile it, so ``g++`` builds its per-frame function, with a small host
loop over frames, into a shared library here. Every output of that build
is held against the plain version (``ops/head_pose.py::focus_geometry_reference``,
the focus geometry functions composed) and the rotation and center
against the JAX package's ``head_pose_from_landmarks``, on random faces,
the committed face frames at both sizes, a flat face, near-pi head
rotations and six landmarks at one pixel.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from isbfsar_tpu.focus import geometry as jg
from isbfsar_tpu_torch.configs import CameraIntrinsics
from isbfsar_tpu_torch.focus import geometry as tg
from isbfsar_tpu_torch.kernel_bench import TOL_HEAD, face_landmarks, geometry_errors
from isbfsar_tpu_torch.ops import head_pose
from isbfsar_tpu_torch.profile_slice import CI_INTRINSICS, focus_frames

# the suite runs in several processes at once
torch.set_num_threads(2)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "isbfsar_tpu_torch", "csrc", "head_pose.cu")
HOST_LOOP = r"""
#include "%s"
extern "C" void focus_geometry_host(const float* lm, const float* k, const float* model,
                                    float* rot, float* center, float* rotvec, float* warp,
                                    float* r_norm, float* rot2d, int* steps, int batch,
                                    float assumed_depth, float norm_distance, float focal,
                                    float half_size, int iters) {
  for (int b = 0; b < batch; ++b)
    steps[2 * b] = focus_frame(lm + 12 * b, k, model, assumed_depth, norm_distance, focal,
                               half_size, iters, rot + 9 * b, center + 3 * b, rotvec + 3 * b,
                               warp + 9 * b, r_norm + 9 * b, rot2d + 2 * b, steps + 2 * b + 1);
}
"""
# Near pi the plain version's float32 arc cosine is ill-conditioned: a few
# ulps of the trace move the angle by sqrt(2 * 3.6e-7) = 8.5e-4 there (the
# host build, in float64, reads 4.9e-4 from it at exactly pi).
TOL_NEAR_PI = 2e-3
K = CameraIntrinsics().matrix()


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """The kernel's source built with g++ for the host, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's arithmetic for the host")
    out = tmp_path_factory.mktemp("head_pose_host")
    src, lib = out / "host.cpp", out / "libhead_pose_host.so"
    src.write_text(HOST_LOOP % SOURCE)
    subprocess.run([gxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.focus_geometry_host.argtypes = [p] * 10 + [i, f, f, f, f, i]
    dll.focus_geometry_host.restype = None
    return dll


def run_host(dll, lms: np.ndarray, k: np.ndarray, size: int, depth: float = 0.6):
    """(FocusGeometry of numpy arrays, (B, 2) Newton steps) of the host build."""
    lms = np.ascontiguousarray(lms, np.float32)
    k = np.ascontiguousarray(k, np.float32)
    b = len(lms)
    model = np.ascontiguousarray(tg.CANONICAL_FACE_3D)
    out = head_pose.FocusGeometry(*(np.empty(s, np.float32) for s in
                                    ((b, 3, 3), (b, 3), (b, 3), (b, 3, 3), (b, 3, 3), (b, 2))))
    steps = np.zeros((b, 2), np.int32)
    dll.focus_geometry_host(lms.ctypes.data, k.ctypes.data, model.ctypes.data,
                            *(a.ctypes.data for a in out), steps.ctypes.data, b, depth, depth,
                            tg.focal_length(size), size / 2.0, 40)
    return out, steps


def _project(model, rotvec, pos):
    p = (model @ Rotation.from_rotvec(rotvec).as_matrix().T + pos) @ K.T
    return (p[:, :2] / p[:, 2:]).astype(np.float32)


def _inputs(kind: str):
    """(landmarks, intrinsics, gaze crop size) of one kind of input."""
    if kind == "random_faces":
        return face_landmarks(16, np.random.default_rng(7)), K, 224
    if kind in ("face_frames_480", "face_frames_240"):
        height, intr, size = ((480, CameraIntrinsics(), 224) if kind.endswith("480")
                              else (240, CI_INTRINSICS, 64))
        return focus_frames(height)["landmarks"], intr.matrix(), size
    if kind == "flat":  # the canonical face pressed to a plane: a near rank-2 H
        flat = jg.CANONICAL_FACE_3D * np.array([1.0, 1.0, 1e-3], np.float32)
        return np.stack([_project(flat, v, [0.05, -0.02, 0.7])
                         for v in ([0.1, 0.3, 0.0], [0.0, -0.5, 0.2], [0.4, 0.0, -0.3])]), K, 224
    if kind == "near_pi":  # rotmat_to_rotvec's near-pi branch, about each axis
        return np.stack([_project(jg.CANONICAL_FACE_3D, v, [0.0, 0.0, 0.6])
                         for v in NEAR_PI]), K, 224
    pts = np.array([[320.0, 240.0], [100.3, 50.7], [K[0, 2], K[1, 2]], [0.0, 0.0]], np.float32)
    return np.repeat(pts[:, None], 6, axis=1), K, 224  # six landmarks at one pixel


# head rotations within 0.014 rad of pi (the branch's threshold), so that
# each column of (R + I) / 2 is the one taken: turned away (y), upside down
# in the image (z), and upside down and turned away (x)
NEAR_PI = np.array([[0.0, np.pi, 0.0], [0.0, np.pi - 4e-3, 0.0], [3e-3, np.pi - 2e-3, 0.0],
                    [0.2, 0.0, np.pi - 0.01], [np.pi - 0.02, 0.3, 0.0]])
KINDS = ["random_faces", "face_frames_480", "face_frames_240", "flat", "near_pi", "one_pixel"]


@pytest.mark.parametrize("size", [224, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_host_build_matches_plain_composition(host_build, kind, size):
    """Every output within kernel_bench.TOL_HEAD of the plain version (the
    limits and what the host reads are stated there), the rotation vectors
    of near-pi poses within TOL_NEAR_PI."""
    lms, k, _ = _inputs(kind)
    got, _ = run_host(host_build, lms, k, size)
    want = head_pose.focus_geometry_reference(torch.from_numpy(np.asarray(lms, np.float32)),
                                              torch.from_numpy(np.asarray(k, np.float32)),
                                              out_size=size)
    assert all(np.isfinite(a).all() for a in got)
    err = geometry_errors(got, want, size)
    tol = dict(TOL_HEAD)
    if kind == "near_pi":
        tol.update(rotvec=TOL_NEAR_PI, head_rot2d=TOL_NEAR_PI)
        # the branch ran: the angle is pi to within the limit, not the ~0 of
        # the antisymmetric formula
        np.testing.assert_allclose(np.linalg.norm(got.rotvec, axis=-1),
                                   np.linalg.norm(NEAR_PI, axis=-1), atol=TOL_NEAR_PI)
    if kind == "one_pixel":
        np.testing.assert_array_equal(got.rot, np.broadcast_to(np.eye(3, dtype=np.float32),
                                                               got.rot.shape))
    assert all(err[f] <= tol[f] for f in tol), sorted(err.items())


@pytest.mark.parametrize("kind", KINDS[:-1])
def test_host_build_rot_and_center_match_jax(host_build, kind):
    """The rotation and center against JAX's solve, at the limits of
    tests/test_torch_focus.py::test_head_pose_plain_matches_jax (1e-5 and
    1e-5 m). Six landmarks at one pixel are left out: JAX's solve reaches
    NaN there (ROADMAP C.5)."""
    lms, k, size = _inputs(kind)
    got, _ = run_host(host_build, lms, k, size)
    rot, center = jax.vmap(lambda x: jg.head_pose_from_landmarks(x, jnp.asarray(k), 0.6))(
        jnp.asarray(lms))
    np.testing.assert_allclose(got.rot, np.asarray(rot), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.center, np.asarray(center), atol=1e-5, rtol=0)


def test_host_newton_steps_stay_under_the_cap(host_build):
    """At least one Newton step in every iteration of a real face, fewer
    than MAX_NEWTON in any one iteration, and none on a degenerate frame."""
    for kind in KINDS:
        lms, k, size = _inputs(kind)
        _, steps = run_host(host_build, lms, k, size)
        if kind == "one_pixel":
            assert not steps.any()
            continue
        assert (steps[:, 0] >= 40).all() and (steps[:, 1] >= 1).all(), kind
        assert (steps[:, 1] < head_pose.MAX_NEWTON).all(), (kind, steps)
