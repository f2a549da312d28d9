"""The YOLO trainer of the port (``train/posestack.py``) against the JAX
package's on the CPU: the person loss and the IoU, one train step in
float64 and in float32 (``tests/torch_synth_parity.py`` says what is
compared and why), and remat.

Readings (``python -m tests.torch_synth_parity yolo``; the limits are
``torch_synth_parity.TOL_STEP_64`` and ``FLOAT32_RATIO``): float64 loss
5.7e-8 of 1.24, gradient 3.7e-7 of its leaf, parameters 3.7e-6, running
stats 1.3e-13; in float32 the port reads 0.066 in the gradient from JAX's
float64 step and JAX's own float32 step 0.39.
The loss itself in float32 (random boxes, ties included): 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu.train import posestack as jps
from isbfsar_tpu.train.detection import pairwise_iou as jax_pairwise_iou
from isbfsar_tpu_torch.train import posestack as tps
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_LOSS = 1e-6


def _random_case(seed: int, n: int = 60):
    """A batch of 4 images: boxes, confs, the GT box and the person flag;
    image 1 has no person, image 2's GT lies off every box (all IoUs 0,
    argmax ties at index 0), image 3 has duplicated best boxes (a tie)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (4, n, 2))
    wh = rng.uniform(0.02, 0.3, (4, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    confs = rng.uniform(0, 1, (4, n, 80)).astype(np.float32)
    gt = boxes[np.arange(4), rng.integers(0, n, 4)].copy()
    gt[2] = [2.0, 2.0, 2.5, 2.5]
    boxes[3, 7] = boxes[3, 5] = gt[3]
    has = np.asarray([True, False, True, True])
    return boxes[:, :, None], confs, gt, has


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_person_loss_matches_jax(seed):
    boxes, confs, gt, has = _random_case(seed)
    want_total, want_aux = jax.vmap(jps.yolo_person_loss)(boxes, confs, gt, has)
    total, aux = tps.yolo_person_loss(*(torch.from_numpy(a) for a in (boxes, confs, gt, has)))
    assert float(np.max(np.abs(total.numpy() - np.asarray(want_total)))) <= TOL_LOSS
    for k, v in aux.items():
        assert float(np.max(np.abs(v.numpy() - np.asarray(want_aux[k])))) <= TOL_LOSS, k


def test_person_loss_gradient_matches_jax():
    """The loss's gradient with respect to the boxes and confs (the clips'
    and the argmax's gradients included)."""
    boxes, confs, gt, has = _random_case(3)
    jg = jax.grad(lambda b, c: jnp.mean(jax.vmap(jps.yolo_person_loss)(b, c, gt, has)[0]),
                  argnums=(0, 1))(boxes, confs)
    tb, tc = (torch.from_numpy(a).requires_grad_() for a in (boxes, confs))
    tps.yolo_person_loss(tb, tc, torch.from_numpy(gt), torch.from_numpy(has))[0].mean().backward()
    for got, want in ((tb.grad, jg[0]), (tc.grad, jg[1])):
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= 1e-7


def test_pairwise_iou_matches_jax():
    boxes, _, gt, _ = _random_case(4)
    want = np.asarray(jax_pairwise_iou(boxes[0, :, 0], boxes[1, :10, 0]))
    got = tps.pairwise_iou(torch.from_numpy(boxes[0, :, 0]), torch.from_numpy(boxes[1, :10, 0]))
    assert float(np.max(np.abs(got.numpy() - want))) <= 1e-7


@pytest.fixture(scope="module")
def yolo_readings():
    return P.readings("yolo")


def test_step_in_float64_matches_jax(yolo_readings):
    over = {k: v for k, v in yolo_readings["float64"].items() if not v <= P.TOL_STEP_64[k]}
    assert not over, (over, yolo_readings)


def test_step_in_float32_is_near_jax(yolo_readings):
    P.check_readings(yolo_readings)


def test_remat_equals_plain():
    """Remat per CSP stage gives the step without it, bit for bit."""
    b = P.batch("yolo")
    init = tps.YoloTrainer(width=0.25, input_size=128, device="cpu").variables
    out = []
    for remat in (False, True):
        t = tps.YoloTrainer(width=0.25, input_size=128, variables=init, remat=remat,
                            device="cpu")
        loss = t.train_step(b)
        out.append((loss, t.variables))
    assert out[0][0] == out[1][0]
    assert P.max_abs(P.numpy_tree(out[0][1]), P.numpy_tree(out[1][1])) == 0.0


def test_warm_start_refuses_another_size():
    init = tps.YoloTrainer(width=0.25, input_size=128, device="cpu").variables
    with pytest.raises(ValueError, match="warm-start yolo"):
        tps.YoloTrainer(width=0.5, input_size=128, variables=init, device="cpu")
