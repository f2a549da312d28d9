"""The BlazeFace and landmark-refiner trainers of the port
(``train/gazefocus.py``) against the JAX package's on the CPU: the face
loss, and one train step of each in float64 and in float32 from JAX's init
(``tests/torch_synth_parity.py`` says what is compared and why). The gaze
trainer: ``test_torch_gaze_train.py``.

Readings (``python -m tests.torch_synth_parity blaze lm``), float64 then
float32 against JAX's float64 step: BlazeFace loss 7.5e-8 of 4.10,
gradient 3.9e-7, parameters 1.3e-6, running stats 1.2e-7, and in float32
the gradient 3.4e-6 (JAX's own 2.2e-6); the refiner loss 3.7e-9 of 0.19,
gradient 1.1e-6, parameters 5.6e-5, stats 4.9e-8, and in float32 the
gradient 2.2e-6 (JAX's own 2.7e-3). The loss itself in float32: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu.train import gazefocus as jgf
from isbfsar_tpu_torch.train import gazefocus as tgf
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_LOSS = 1e-6


def _random_case(seed: int, n: int = 50):
    """4 images: boxes, landmarks, scores, GT box and landmarks; image 2's
    GT lies off every box (argmax ties at index 0), image 3 has duplicated
    best boxes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (4, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (4, n, 2))], -1).astype(np.float32)
    lms = rng.uniform(0, 1, (4, n, 6, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, (4, n)).astype(np.float32)
    gt = boxes[np.arange(4), rng.integers(0, n, 4)].copy()
    gt[2] = [2.0, 2.0, 2.5, 2.5]
    boxes[3, 9] = boxes[3, 4] = gt[3]
    return boxes, lms, scores, gt, rng.uniform(0, 1, (4, 6, 2)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_face_loss_matches_jax(seed):
    case = _random_case(seed)
    want_total, want_aux = jax.vmap(jgf.blazeface_loss)(*case)
    total, aux = tgf.blazeface_loss(*(torch.from_numpy(a) for a in case))
    assert float(np.max(np.abs(total.numpy() - np.asarray(want_total)))) <= TOL_LOSS
    for k, v in aux.items():
        assert float(np.max(np.abs(v.numpy() - np.asarray(want_aux[k])))) <= TOL_LOSS, k


def test_face_loss_gradient_matches_jax():
    boxes, lms, scores, gt, gt_lms = _random_case(2)
    jg = jax.grad(lambda b, l, s: jnp.mean(jax.vmap(jgf.blazeface_loss)(b, l, s, gt, gt_lms)[0]),
                  argnums=(0, 1, 2))(boxes, lms, scores)
    ts = [torch.from_numpy(a).requires_grad_() for a in (boxes, lms, scores)]
    tgf.blazeface_loss(*ts, torch.from_numpy(gt), torch.from_numpy(gt_lms))[0].mean().backward()
    for t, want in zip(ts, jg):
        assert float(np.max(np.abs(t.grad.numpy() - np.asarray(want)))) <= 1e-7


@pytest.fixture(scope="module", params=["blaze", "lm"])
def focus_readings(request):
    return request.param, P.readings(request.param)


def test_step_in_float64_matches_jax(focus_readings):
    kind, r = focus_readings
    over = {k: v for k, v in r["float64"].items() if not v <= P.TOL_STEP_64[k]}
    assert not over, (kind, over, r)


def test_step_in_float32_is_near_jax(focus_readings):
    P.check_readings(focus_readings[1])
