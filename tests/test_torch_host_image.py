"""The synthetic trainers' host image operations against cv2 5.0.0, pixel
for pixel, in sweeps: ``ops/image.py::resize_area_u8`` (INTER_AREA),
``warp_affine_linear_u8`` (warpAffine at INTER_LINEAR, border 0),
``resize_linear_u8`` at the focus detector's 480x640 -> 128, and
``utils/draw.py::ellipse`` (filled and whole). No difference is left on
any sweep: cv2 5.0.0's warpAffine computes in float32 with fused
multiply-adds (the fixed point of older releases does not match it), and
its ellipse is the float sine table's polygon."""

import cv2
import numpy as np
import pytest

from isbfsar_tpu_torch.ops.image import resize_area_u8, resize_linear_u8, warp_affine_linear_u8
from isbfsar_tpu_torch.train import posestack as tps
from isbfsar_tpu_torch.utils import draw


def _images(rng, h, w, n):
    """Random, binary and few-level images: rounding ties at every stage."""
    for i in range(n):
        kind = i % 3
        if kind == 0:
            yield rng.integers(0, 256, (h, w, 3), np.uint8)
        elif kind == 1:
            yield (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
        else:
            yield (rng.integers(0, 4, (h, w, 3)) * 85).astype(np.uint8)


@pytest.mark.parametrize("h,w,out", [(240, 320, 128), (480, 640, 256), (100, 77, 31)])
def test_resize_area_equals_cv2(h, w, out):
    rng = np.random.default_rng(h)
    for img in _images(rng, h, w, 6):
        want = cv2.resize(img, (out, out), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area_u8(img, out, out), want)


def test_resize_area_on_rendered_scenes_equals_cv2():
    """The detector trainers' inputs: rendered humanoid scenes, with and
    without a person, at the CI and the production sizes."""
    for hw, out, intr in (((240, 320), 128, tps.CI_INTRINSICS), ((480, 640), 256, None)):
        sampler = tps.SyntheticHumanSampler(hw, intr, seed=0)
        for person in (True, False, True):
            frame, _ = sampler.sample(person=person, hard=not person)
            want = cv2.resize(frame, (out, out), interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(resize_area_u8(frame, out, out), want)


def test_resize_linear_to_128_equals_cv2():
    rng = np.random.default_rng(0)
    for img in _images(rng, 480, 640, 6):
        np.testing.assert_array_equal(resize_linear_u8(img, 128, 128), cv2.resize(img, (128, 128)))


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_affine_equals_cv2(seed):
    """Square crops of boxes from 3 to 400 px, inside, across and outside
    the frame (the refiner's crop matrices)."""
    rng = np.random.default_rng(seed)
    for img in _images(rng, 480, 640, 30):
        bw = rng.uniform(3, 400)
        cx, cy = rng.uniform(-50, 690), rng.uniform(-50, 530)
        side = max(1.4 * bw, 8.0)
        x0, y0 = cx - side / 2, cy - side / 2
        m = np.asarray([[64.0 / side, 0.0, -x0 * 64.0 / side],
                        [0.0, 64.0 / side, -y0 * 64.0 / side]], np.float32)
        want = cv2.warpAffine(img, m, (64, 64), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(warp_affine_linear_u8(img, m, 64, 64), want)


def test_warp_affine_general_matrices_equal_cv2():
    """Rotations and shears, and an output larger than the frame."""
    rng = np.random.default_rng(2)
    for img in _images(rng, 60, 80, 12):
        m = rng.normal(0, 1, (2, 3)).astype(np.float32)
        m[:, 2] = rng.uniform(-20, 80, 2)
        want = cv2.warpAffine(img, m, (96, 72), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(warp_affine_linear_u8(img, m, 96, 72), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_filled_ellipse_equals_cv2(seed):
    """Centers inside and far outside the frame, axes 0-300 (every step of
    the polygon: 90, 30, 18 and 5 degrees), circles and flat ellipses."""
    rng = np.random.default_rng(seed)
    for i in range(300):
        img = rng.integers(0, 60, (120, 160, 3)).astype(np.uint8)
        want = img.copy()
        center = (int(rng.integers(-60, 220)), int(rng.integers(-60, 180)))
        axes = ((int(rng.integers(0, 300)),) * 2 if i % 3 == 0
                else (int(rng.integers(0, 40)), int(rng.integers(0, 40))))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.ellipse(want, center, axes, 0, 0, 360, color, -1)
        draw.ellipse(img, center, axes, color)
        np.testing.assert_array_equal(img, want, err_msg=f"{center} {axes}")
