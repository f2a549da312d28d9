"""The gaze-focus trainers' host side against the JAX package (which draws
and warps with cv2) on the CPU, pixel for pixel: the face renderer, the
sampler's draws, the refiner's crop and the BlazeFace and refiner
batches."""

import numpy as np
import pytest

from isbfsar_tpu.train import gazefocus as jgf
from isbfsar_tpu_torch.train import gazefocus as tgf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_frames_and_truth_equal_jax(seed):
    """Eight scenes of each sampler (faces of 0.5% to 25% of the frame,
    turned heads, gazes): frames equal pixel for pixel, ground truth equal."""
    want, got = jgf.SyntheticFaceSampler(seed=seed), tgf.SyntheticFaceSampler(seed=seed)
    for _ in range(8):
        wf, wgt, wgaze = want.sample()
        gf, ggt, ggaze = got.sample()
        np.testing.assert_array_equal(gf, wf)
        assert ggaze == wgaze
        for k in wgt:
            np.testing.assert_array_equal(ggt[k], wgt[k])


def test_render_face_scene_at_the_edges_equals_jax():
    """Tiny and frame-filling faces, off-center and at the border, straight
    and turned."""
    for area, center, yaw, gaze in ((0.0005, (5.0, 7.0), 0.0, (0.0, 0.0)),
                                    (0.9, None, 1.2, (-1.5, 1.5)),
                                    (0.05, (630.0, 470.0), -0.9, (0.5, -0.2))):
        want = jgf.render_face_scene(area, gaze, center, (480, 640), np.random.default_rng(1),
                                     head_yaw=yaw)
        got = tgf.render_face_scene(area, gaze, center, (480, 640), np.random.default_rng(1),
                                    head_yaw=yaw)
        np.testing.assert_array_equal(got[0], want[0])
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])


@pytest.mark.parametrize("seed", [0, 3])
def test_refiner_crop_equals_jax(seed):
    """``make_refiner_crop`` (cv2's warpAffine in JAX) on jittered boxes:
    the crop, its origin and its side equal."""
    sampler = tgf.SyntheticFaceSampler(seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        frame, gt, _ = sampler.sample()
        box = gt["bbox"] * np.asarray([640, 480, 640, 480], np.float32)
        box = box + rng.normal(0, 0.12, 4) * 40
        got, want = tgf.make_refiner_crop(frame, box), jgf.make_refiner_crop(frame, box)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_detector_and_refiner_batches_equal_jax():
    """The BlazeFace batch (cv2's INTER_LINEAR to 128 in JAX) and the
    refiner batch (the 12% box jitter drawn after each scene) as JAX's
    ``train_focus_params`` builds them."""
    import cv2

    got = tgf.face_detector_batch(tgf.SyntheticFaceSampler(seed=4), 3)
    sampler = jgf.SyntheticFaceSampler((480, 640), seed=4)
    for i in range(3):
        frame, gt, _ = sampler.sample()
        img = (cv2.resize(frame, (128, 128))[..., ::-1] / 255.0).astype(np.float32)
        np.testing.assert_array_equal(got["image"][i], img)
        np.testing.assert_array_equal(got["bbox"][i], gt["bbox"])
        np.testing.assert_array_equal(got["landmarks"][i], gt["landmarks"])
    got = tgf.refiner_batch(tgf.SyntheticFaceSampler(seed=5), 3)
    sampler = jgf.SyntheticFaceSampler((480, 640), seed=5)
    for i in range(3):
        frame, gt, _ = sampler.sample()
        box_px = gt["bbox"] * np.asarray([640, 480, 640, 480], np.float32)
        bw, bh = box_px[2] - box_px[0], box_px[3] - box_px[1]
        jit = sampler.rng.normal(0, 0.12, 4) * np.asarray([bw, bh, bw, bh])
        crop, origin, side = jgf.make_refiner_crop(frame, box_px + jit)
        target = ((gt["landmarks"] * np.asarray([640, 480], np.float32) - origin) / side)
        np.testing.assert_array_equal(got["crop"][i], crop)
        np.testing.assert_array_equal(got["landmarks"][i], target.astype(np.float32))
