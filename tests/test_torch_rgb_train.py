"""rgb training: the port's BatchNorm in training, its ResNet-50 with batch
statistics, and the trainer's loss, gradients and running statistics,
against the JAX package on the CPU (``tests/torch_rgb_parity.py`` says why
the step is compared in float64). Hybrid: ``test_torch_hybrid_train.py``;
evaluation, remat and checkpoints: ``test_torch_rgb_train_state.py``.

Tolerances, each two to five times what this CPU reads:
- BatchNorm (float32, Flax's ``nn.BatchNorm`` itself, inputs of mean 3
  and deviation 2): outputs 3e-6 (read 9.5e-7), the running mean and var
  2e-6 (read 8.3e-7) after one and after two updates; inference 2e-6
  (read 8.3e-7);
- the ResNet-50 forward in training at 32², 16 frames, float64: features
  5e-11 (read 7.3e-12 of 9.1), running stats after the update 5e-13
  (read 1.5e-13); in float32 the port's features must be no farther from
  the float64 result than JAX's are;
- one step in float64: ``torch_rgb_parity.TOL_STEP_64``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu.models.resnet import resnet50 as jax_resnet50
from isbfsar_tpu_torch.models.layers import BatchNorm, init_random, update_running_stats
from isbfsar_tpu_torch.models.resnet import resnet50
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables
from tests import torch_rgb_parity as P

torch.set_num_threads(2)

MODE = "rgb"
TOL_BN = {"out": 3e-6, "mean": 2e-6, "var": 2e-6, "inference": 2e-6}
TOL_FEATURES_64, TOL_STATS_64 = 5e-11, 5e-13


@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (16, 1, 1, 8)])
def test_batchnorm_trains_like_flax(shape):
    """Flax's ``nn.BatchNorm(use_running_average=False, momentum=0.9,
    epsilon=1e-5)`` on two batches in turn (the second from the first's
    running stats): the port's output with ``train=True`` and its running
    averages after each :meth:`BatchNorm.update`; and the inference output
    from the running averages. The batches have a mean far from 0, where
    ``E[x²] - E[x]²`` differs most from torch's own variance."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    xs = [(rng.normal(size=shape) * 2 + 3).astype(np.float32) for _ in range(2)]
    params = {"scale": rng.normal(size=c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=c).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    norm = BatchNorm(c, 1e-5)
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    for x in xs:
        want, mut = bn.apply({"params": params, "batch_stats": stats}, x,
                             mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
        collected = []
        got = norm(torch.from_numpy(x).permute(0, 3, 1, 2), True, collected)
        assert [n for n, _, _ in collected] == [norm]
        update_running_stats(collected)
        err = float(np.max(np.abs(got.permute(0, 2, 3, 1).detach().numpy() - np.asarray(want))))
        assert err <= TOL_BN["out"], err
        for k in ("mean", "var"):
            err = float(np.max(np.abs(getattr(norm, k).numpy() - stats[k])))
            assert err <= TOL_BN[k], (k, err)
    infer = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want = infer.apply({"params": params, "batch_stats": stats}, xs[0])
    with torch.no_grad():
        got = norm(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    err = float(np.max(np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want))))
    assert err <= TOL_BN["inference"], err


def test_resnet50_training_forward_matches_jax():
    """The ResNet-50 at 32² on 16 frames with ``train=True``: in float64 the
    pooled features and the running stats after the update equal JAX's
    ``apply(train=True, mutable=["batch_stats"])``; in float32 the port is
    no farther from that float64 result than JAX is."""
    net = resnet50(torch.float64)
    init_random(net, torch.Generator().manual_seed(0))
    variables = jax.tree.map(lambda t: t.numpy(), to_flax_variables(net.state_dict()))
    x = np.random.default_rng(1).normal(size=(16, P.RGB_SIZE, P.RGB_SIZE, 3))
    want = {}
    for dtype in ("float64", "float32"):
        with jax.enable_x64(dtype == "float64"):
            jnet = jax_resnet50(dtype=jnp.dtype(dtype))
            feats, mut = jax.jit(lambda v, x: jnet.apply(v, x, train=True,
                                                         mutable=["batch_stats"]))(
                P.cast(variables, dtype), x.astype(dtype))
            want[dtype] = np.asarray(feats), jax.tree.map(np.asarray, mut["batch_stats"])
    got = {}
    for dtype in ("float64", "float32"):
        port = resnet50(getattr(torch, dtype)).to(getattr(torch, dtype))
        port.load_state_dict(convert_variables(P.cast(variables, dtype)), strict=True)
        stats = []
        feats = port(torch.from_numpy(x.astype(dtype)).permute(0, 3, 1, 2), True, stats)
        assert len(stats) == 53  # every BatchNorm of the ResNet-50 once, in call order
        update_running_stats(stats)
        batch_stats = to_flax_variables(port.state_dict())["batch_stats"]
        got[dtype] = feats.detach().numpy(), jax.tree.map(lambda t: t.numpy(), batch_stats)
    assert float(np.max(np.abs(got["float64"][0] - want["float64"][0]))) <= TOL_FEATURES_64
    assert P.max_abs(want["float64"][1], got["float64"][1]) <= TOL_STATS_64
    truth = want["float64"][0]
    port_err = float(np.max(np.abs(got["float32"][0] - truth)))
    jax_err = float(np.max(np.abs(want["float32"][0] - truth)))
    assert port_err <= jax_err, (port_err, jax_err)


@pytest.fixture(scope="module")
def steps():
    return P.steps(MODE)


@pytest.mark.parametrize("disc_on", [False, True])
def test_loss_and_gradients_match_jax(steps, disc_on):
    P.check_step(steps, disc_on)


def test_batch_stats_after_a_step_match_jax(steps):
    P.check_step_stats(steps)
