"""The heatmap trainer of the port (``train/posestack.py::HeatmapTrainer``)
against the JAX package's on the CPU: the crop chain and its targets, one
train step in float64 and in float32 (``tests/torch_synth_parity.py``),
and remat.

The crops are bit-equal to JAX's vmapped crop chain (its code, jitted as
the trainer's step would see it); the 2D targets within 3e-5 px (read
7.6e-6: XLA sums the joints' centroid in another order) and the 3D targets
within 1e-6 (read 2.4e-7). Step readings (``python -m
tests.torch_synth_parity heatmap``): float64 loss 1.5e-8 of 0.20, gradient
3.9e-6 of its leaf, parameters 4.2e-5, running stats 3.6e-8; float32: the
port 1.0e-4 in the parameters from JAX's float64 step, JAX itself 3.5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu.ops.geometry import mm, project, virtual_camera, warp_matrix
from isbfsar_tpu.ops.warp import warp_image
from isbfsar_tpu.train import posestack as jps
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.train import posestack as tps
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_GT2D, TOL_GT3D = 3e-5, 1e-6


def jax_crop_and_targets(k_matrix, c: int):
    """JAX ``HeatmapTrainer``'s per-frame crop chain (train/posestack.py
    :1003-1017), vmapped and jitted as its train step runs it."""
    def one(frame, box_px, joints3d):
        x1, y1, x2, y2 = box_px[0], box_px[1], box_px[2], box_px[3]
        new_k, rot = virtual_camera(x1, x2, y1, y2, k_matrix, c)
        h_mat = warp_matrix(k_matrix, new_k[None], rot)
        crop = warp_image(jnp.round(frame).astype(jnp.int32), h_mat, c)[0]
        x_crop = mm(joints3d[None], jnp.swapaxes(rot, 1, 2))[0]
        uv = project(x_crop)
        gt2d = uv * jnp.asarray([new_k[0, 0], new_k[1, 1]]) + jnp.asarray(
            [new_k[0, 2], new_k[1, 2]])
        centroid = jnp.mean(x_crop, axis=0, keepdims=True)
        return crop, gt2d, (x_crop - centroid) / jps.BOX_SIZE_M + 0.5

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("seed", [1, 2])
def test_crops_bit_equal_and_targets_match_jax(seed):
    b = tps.pose_batch(tps.SyntheticHumanSampler(tps.CI_FRAME_HW, tps.CI_INTRINSICS, seed=seed),
                       4, 0.08)
    want = jax_crop_and_targets(jnp.asarray(tps.CI_INTRINSICS.matrix()), 128)(
        b["frame"], b["box_px"], b["joints3d"])
    trainer = tps.HeatmapTrainer(tps.CI_INTRINSICS, crop_size=128, stages=V2_TINY, device="cpu")
    crops, gt2d, gt3d = trainer.crop_and_targets(
        *(torch.from_numpy(b[k]) for k in ("frame", "box_px", "joints3d")))
    np.testing.assert_array_equal(crops.numpy(), np.asarray(want[0]))
    assert float(np.max(np.abs(gt2d.numpy() - np.asarray(want[1])))) <= TOL_GT2D
    assert float(np.max(np.abs(gt3d.numpy() - np.asarray(want[2])))) <= TOL_GT3D


@pytest.fixture(scope="module")
def heatmap_readings():
    return P.readings("heatmap")


def test_step_in_float64_matches_jax(heatmap_readings):
    over = {k: v for k, v in heatmap_readings["float64"].items()
            if not v <= P.TOL_STEP_64[k]}
    assert not over, (over, heatmap_readings)


def test_step_in_float32_is_near_jax(heatmap_readings):
    P.check_readings(heatmap_readings)


def test_remat_equals_plain():
    """Remat per MBConv gives the step without it, bit for bit."""
    b = P.batch("heatmap")
    init = tps.HeatmapTrainer(tps.CI_INTRINSICS, crop_size=128, stages=V2_TINY,
                              device="cpu").variables
    out = []
    for remat in (False, True):
        t = tps.HeatmapTrainer(tps.CI_INTRINSICS, crop_size=128, stages=V2_TINY,
                               variables=init, remat=remat, device="cpu")
        out.append((t.train_step(b), t.variables))
    assert out[0][0] == out[1][0]
    assert P.max_abs(P.numpy_tree(out[0][1]), P.numpy_tree(out[1][1])) == 0.0


def test_warm_start_needs_the_same_crop_and_stages():
    init = tps.HeatmapTrainer(tps.CI_INTRINSICS, crop_size=128, stages=V2_TINY,
                              device="cpu").variables
    with pytest.raises(ValueError, match="warm-start pose"):
        tps.HeatmapTrainer(tps.CI_INTRINSICS, crop_size=128, stages=V2_TINY[:-1],
                           variables=init, device="cpu")
