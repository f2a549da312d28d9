"""The gaze trainer of the port (``train/gazefocus.py::GazeTrainer``) and
its batched crop against the JAX package's on the CPU: one train step in
float64 and in float32 from JAX's init (``tests/torch_synth_parity.py``),
the batched normalized crops and their labels against JAX's per-frame
``crop_fn``, and ``vector_to_pitchyaw``.

Readings: the step (``python -m tests.torch_synth_parity gaze``), float64
loss 6.3e-7 of 1.35, gradient 6.4e-7, parameters 8.0e-6, running stats
6.0e-8; in float32 the gradient 1.3e-5 from JAX's float64 step (JAX's own
3.0e-2). The crops (RGB / 255, 64 faces of 8 batches at 64 px) differ
from JAX's by up to 1.7e-4 and the labels by up to 1.8e-7 rad: the port's
plain head pose on the CPU and JAX's reach warps 8.4e-6 apart (relative),
which moves a sample point by about 1e-4 px, and so the value at a
drawn edge (test limits 5e-4 and 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.models.gaze import pitchyaw_to_vector as jax_pitchyaw_to_vector
from isbfsar_tpu.models.gaze import vector_to_pitchyaw as jax_vector_to_pitchyaw
from isbfsar_tpu.train import gazefocus as jgf
from isbfsar_tpu_torch.models.gaze import vector_to_pitchyaw
from isbfsar_tpu_torch.train import gazefocus as tgf
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_CROP, TOL_LABEL = 5e-4, 1e-6


@pytest.fixture(scope="module")
def gaze_readings():
    return P.readings("gaze")


def test_step_in_float64_matches_jax(gaze_readings):
    over = {k: v for k, v in gaze_readings["float64"].items() if not v <= P.TOL_STEP_64[k]}
    assert not over, (over, gaze_readings)


def test_step_in_float32_is_near_jax(gaze_readings):
    P.check_readings(gaze_readings)


@pytest.mark.parametrize("seed", [1, 5])
def test_batched_crops_and_labels_match_jax_per_frame(seed):
    """One gaze batch of 8 (the draws in JAX's order) through the port's
    batched crop against JAX's jitted per-frame ``crop_fn`` and its
    labels."""
    frames, lms, gazes = tgf.gaze_batch(tgf.SyntheticFaceSampler(seed=seed), 8, 0.005)
    crops, r_norm = tgf.make_normalized_crop_fn(tgf.CI_FOCUS_CFG, with_rnorm=True,
                                                device="cpu")(frames, lms)
    labels = tgf.gaze_labels(gazes, r_norm).numpy()
    jcfg = jc.FocusConfig(gaze_image_size=64, compute_dtype="float32")
    crop_fn = jgf.make_normalized_crop_fn(jcfg, with_rnorm=True)
    for i in range(8):
        want, jr = crop_fn(jnp.asarray(frames[i]), jnp.asarray(lms[i]))
        v_cam = jax_pitchyaw_to_vector(jnp.asarray(gazes[i], jnp.float32))
        want_label = np.asarray(jax_vector_to_pitchyaw(jr @ v_cam))
        assert float(np.max(np.abs(crops[i].numpy() - np.asarray(want)))) <= TOL_CROP, i
        assert float(np.max(np.abs(labels[i] - want_label))) <= TOL_LABEL, i


def test_gaze_batch_draws_as_jax():
    """The batch's scenes and landmark jitter, in JAX's order (the scene,
    then its jitter), are JAX's."""
    frames, lms, gazes = tgf.gaze_batch(tgf.SyntheticFaceSampler(seed=3), 4, 0.005)
    sampler = jgf.SyntheticFaceSampler((480, 640), seed=3)
    scale = np.asarray([640, 480], np.float32)
    for i in range(4):
        frame, gt, gaze = sampler.sample(min_area=0.04)
        jittered = gt["landmarks"] + sampler.rng.normal(0, 0.005, (6, 2))
        np.testing.assert_array_equal(frames[i], frame)
        np.testing.assert_array_equal(lms[i], (jittered * scale).astype(np.float32))
        np.testing.assert_array_equal(gazes[i], np.asarray(gaze, np.float32))


def test_vector_to_pitchyaw_matches_jax():
    v = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    want = np.asarray(jax_vector_to_pitchyaw(jnp.asarray(v)))
    assert float(np.max(np.abs(vector_to_pitchyaw(torch.from_numpy(v)).numpy() - want))) <= 5e-7
