"""hybrid training against the JAX package on the CPU: one step's loss,
gradients and running statistics in float64 with the discriminator off
and on (``torch_rgb_parity.TOL_STEP_64``), and the trainer's float32 step
against JAX's float64 one (``tests/torch_rgb_parity.py`` says why).

The float32 step is ``Trainer.step``, the production path, with
``optimize_every`` 2 so that its accumulated gradient is the step's
gradient. ``TOL_FLOAT32`` holds its distance from JAX's float64 step, a
few times what this CPU reads and about what JAX's own float32 step is
from it (``python -m tests.torch_rgb_parity``: the port / JAX): the
few-shot loss 3e-3 (read 4.4e-4 / 2.6e-3 of 5.85), the gradient as one
vector 0.1 in relative L2 (read 0.020 / 0.035), the running stats 1e-4 of
each leaf's largest entry (read 1.2e-5 / 4.6e-5).
"""

import numpy as np
import pytest
import torch

from isbfsar_tpu_torch.train import trainer as ttr
from tests import torch_rgb_parity as P

torch.set_num_threads(2)

MODE = "hybrid"
TOL_FLOAT32 = {"loss": 3e-3, "grad": 0.1, "stats": 1e-4}


@pytest.fixture(scope="module")
def steps():
    return P.steps(MODE)


@pytest.mark.parametrize("disc_on", [False, True])
def test_loss_and_gradients_match_jax(steps, disc_on):
    P.check_step(steps, disc_on)


def test_batch_stats_after_a_step_match_jax(steps):
    P.check_step_stats(steps)


def test_float32_step_is_near_the_float64_step(steps, tmp_path):
    variables, batch = steps["variables"], steps["batch"]
    ((_, jmet), jgrads), _ = steps[True]
    cfg = P.configs(MODE, optimize_every=2)[1]
    trainer = ttr.Trainer(cfg, log_dir=str(tmp_path), use_wandb=False, device="cpu")
    trainer.load_state({**trainer.state(), **variables})
    metrics = trainer.step(batch, disc_on=True)
    state = P.numpy_tree(trainer.state())
    np.testing.assert_array_equal(metrics["fs_correct"].numpy(), jmet["fs_correct"])
    err = P.float32_errors(float(metrics["fs_loss"]), state["opt_state"]["acc_grads"],
                           state["batch_stats"], jmet, jgrads)
    for k, tol in TOL_FLOAT32.items():
        assert err[k] <= tol, (k, err)
