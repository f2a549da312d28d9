"""Tensor and sequence parallelism in the port's trainer over CPU process
groups (gloo): the tp and sp certificates of
``isbfsar_tpu_torch/parallel/parity.py``, each n-rank step also held
against JAX's 1-device step from the same init.

- tp on a dp2 x tp2 mesh (4 ranks), skeleton: the 1-device step to 5e-5
  (JAX's bound; this CPU reads 1.5e-8), and JAX's 1-device step to 6e-8 +
  2e-8 (``tests/test_torch_train.py``'s ``TOL_PARAM`` and this CPU's
  1-vs-n reading).
- sp on a dp1 x sp2 mesh, rgb: the BatchNorm bounds (this CPU reads
  param_rel_diff 0.022, stats 3.2e-5), every train-mode extractor apply on
  L/2 frames.
- rgb against JAX: ``tests/test_torch_parallel_jax_rgb.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu.configs import ARConfig as JaxConfig
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.train import trainer as jtr
from isbfsar_tpu_torch.parallel import parity
from isbfsar_tpu_torch.train.synthetic import episodic_batch

torch.set_num_threads(2)

TOL_PARAM_N, TOL_LOSS = 6e-8 + 2e-8, 1e-6


def test_tp_certificate_and_jax(tmp_path):
    """dp2 x tp2: the K/V, MLP and discriminator pairs split over tp, at
    least 4 split leaves and more than half of the elements; the 1-device
    step to 5e-5 and JAX's 1-device step."""
    report = parity.tp_parity_check(4, trees=True)
    assert report["mesh"] == "dp2xtp2"
    assert report["sharded_leaves"] >= 4 and report["sharded_elem_frac"] > 0.5
    assert report["max_param_diff"] <= 5e-5
    trees = report["trees"]
    batch = episodic_batch(parity._cfg("skeleton", 2), 2, 32, "skeleton", seed=0)
    jcfg = dataclasses.replace(JaxConfig.for_input("skeleton"), batch_size=2, n_task=2,
                               eval_every_n_epoch=10_000)
    jt = jtr.Trainer(jcfg, mesh=make_mesh(1), log_dir=str(tmp_path), use_wandb=False)
    init = trees["init"][0]
    jt.load_state({"params": init, "batch_stats": {}, "opt_state": jt.optimizer.init(init)})
    summary = jt.run_epoch(0, [batch], train=True)
    assert parity.max_diff(jax.tree.map(np.asarray, jt.params),
                           trees["many"]["params"]) <= TOL_PARAM_N
    for k in ("train/fs_loss", "train/os_loss"):
        assert abs(trees["many"]["summary"][k] - summary[k]) <= TOL_LOSS, k


def test_sp_rgb_certificate():
    """dp1 x sp2, rgb: each rank embeds 4 of the 8 frames of every clip
    (query, support, unknown), the BatchNorm statistics over both ranks,
    the features gathered along L: the 1-device step to the BN bounds."""
    report = parity.sp_parity_check(2)
    assert report["mesh"] == "dp1xsp2"
    assert report["extractor_applies_sp_sharded"] == "6/6"
    assert report["param_rel_diff"] <= 0.10 and report["max_stats_diff"] <= 1e-3
    assert report["max_metric_diff"] <= 0.05


@pytest.mark.slow
@pytest.mark.parametrize("kw", [dict(modality="hybrid"), dict(param_sharding="fsdp"),
                                dict(remat=True)], ids=["hybrid", "fsdp", "remat"])
def test_sp_compositions(kw):
    """sp on the hybrid input (the skeleton MLP on the same frame slices),
    with FSDP2 over dp, and with remat on the n-rank side (the BatchNorm
    sync inside the recomputed blocks): each against the default 1-device
    step, on a dp2 x sp2 mesh."""
    report = parity.sp_parity_check(4, **kw)
    assert report["mesh"] == "dp2xsp2"
    assert report["extractor_applies_sp_sharded"] == "12/12"
    assert report["param_rel_diff"] <= 0.10 and report["max_stats_diff"] <= 1e-3


@pytest.mark.slow
def test_sp_cuts_per_rank_flops():
    """For one global batch of 4 rgb episodes, a rank of a dp4 x sp2 step
    does well under the FLOPs of a rank of the dp4 step (the extractor
    dominates and sees half the frames): ``FlopCounterMode`` over one
    rank's train step, ratio below 0.75."""
    flops = parity.flops_per_rank("rgb", 4)
    assert flops["dp"] > 0 and flops["sp"] > 0
    assert flops["sp"] / flops["dp"] < 0.75, flops
