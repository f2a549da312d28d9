"""The rgb dp and sp steps of the port's trainer over CPU process groups
(gloo) against JAX's 1-device step.

The float32 step at the CI size is ill-conditioned in both packages
(``tests/torch_rgb_parity.py``), so the steps are run in float64
(``compute_dtype="float64"``) on ``torch_rgb_parity``'s init and batch and
held to JAX's float64 ``value_and_grad`` at
``torch_rgb_parity.TOL_STEP_64``, which holds the port's 1-device step
there, widened by the port's own float64 1-vs-n reading on this CPU
(parameters 1e-13, statistics 3e-14, losses 7e-14). The negative control (the BatchNorm sync off) is held against the same
JAX step from the other side: beyond the rgb bounds by JAX's margins. The
float32 certificates are ``test_torch_parallel_dp.py`` and
``test_torch_parallel_tp_sp.py``.
"""

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu_torch.parallel import parity
from tests import torch_rgb_parity as RP

torch.set_num_threads(2)

TOL_64 = dict(RP.TOL_STEP_64, stats=RP.TOL_STEP_64["stats"] + 3e-14,
              loss=RP.TOL_STEP_64["loss"] + 1e-13)


@pytest.fixture(scope="module")
def jax_rgb_step():
    """JAX's float64 ``value_and_grad`` (discriminator on) from the port's
    seeded rgb init on ``torch_rgb_parity``'s batch, and the port's
    1-device float64 step on it, which both certificates share."""
    variables = RP.init_variables("rgb")
    batch = RP.batch("rgb")
    one = parity.one_device_step(*parity._dp_case(2, "rgb", compute_dtype="float64",
                                                  batch_seed=RP.BATCH_SEED))
    return variables, RP.jax_value_and_grads("rgb", variables, batch, "float64", (True,))[True], one


@pytest.mark.parametrize("layout", ["dp2", "dp1xsp2"])
def test_rgb_float64_step_matches_jax(jax_rgb_step, layout):
    """The dp (DDP, synced BatchNorm) and the sp rgb step in float64: the
    gradient (from the SGD update), the losses and the running statistics
    are JAX's 1-device step's."""
    variables, ((_, jmet), jgrads), one = jax_rgb_step
    if layout == "dp2":
        report = parity.dp_parity_check(2, modality="rgb", compute_dtype="float64", trees=True,
                                        batch_seed=RP.BATCH_SEED, one=one)
    else:
        report = parity.sp_parity_check(2, batch_size=2, compute_dtype="float64", trees=True,
                                        batch_seed=RP.BATCH_SEED, one=one)
    assert report["max_param_diff"] <= 1e-12  # float64: the 1-vs-n step agrees to rounding
    trees = report["trees"]
    assert RP.max_abs(trees["init"][0], variables["params"]) == 0.0
    lr = parity._cfg("rgb", 2).initial_lr
    grads = jax.tree.map(lambda a, b: (np.asarray(a, np.float64) - b) / lr, trees["init"][0],
                         trees["many"]["params"])
    assert RP.max_rel(jgrads, grads) <= TOL_64["grad_rel"]
    assert RP.max_abs(jmet["batch_stats"], trees["many"]["stats"]) <= TOL_64["stats"]
    summary = trees["many"]["summary"]
    assert abs(summary["train/fs_loss"] - float(jmet["fs_loss"])) <= TOL_64["loss"]
    assert abs(summary["train/os_loss"] - float(jmet["os_loss"])) <= TOL_64["loss"]


def test_unsynced_rgb_step_is_far_from_jax(jax_rgb_step):
    """The negative control against JAX: the same DDP rgb step in float64
    with each rank's BatchNorm on its own episode lands beyond the rgb
    bounds from JAX's 1-device step by more than JAX's margins (3x in
    param_rel_diff, 10x in the statistics)."""
    variables, ((_, jmet), jgrads), one = jax_rgb_step
    report = parity.bn_fault_injection_check(2, one=one, compute_dtype="float64",
                                             batch_seed=RP.BATCH_SEED, trees=True)
    trees = report["trees"]
    lr = parity._cfg("rgb", 2).initial_lr
    init = trees["init"][0]
    jax_after = jax.tree.map(lambda p, g: np.asarray(p, np.float64) - lr * np.asarray(g), init,
                             jgrads)
    rel = parity.param_rel_diff(jax_after, trees["many"]["params"], init)
    stats = RP.max_abs(jmet["batch_stats"], trees["many"]["stats"])
    assert rel > 3 * parity.RGB_BOUNDS["param_rel_diff"], rel
    assert stats > 10 * parity.RGB_BOUNDS["max_stats_diff"], stats
