"""Data parallelism in the port's trainer over CPU process groups (gloo):
the dp certificates of ``isbfsar_tpu_torch/parallel/parity.py`` (skeleton,
rgb with synced BatchNorm, and the unsynced negative control), FSDP2, the
open-set loss over ranks whose counts of correct episodes differ, and a
checkpoint written by a sharded run resumed by the JAX trainer.

Every n-rank skeleton step is also held against JAX's 1-device step from
the same init (the port's seeded init as a Flax tree). The port's
1-device trainer is held to JAX's at ``TOL_PARAM`` 6e-8 on the parameters
and 1e-6 on the losses (``tests/test_torch_train.py``); the port's own
1-vs-n reading on this CPU is 1.5e-8 (dp and fsdp, ``max_param_diff``),
so the n-rank step is held to JAX's at 6e-8 + 2e-8.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.train import trainer as jtr
from isbfsar_tpu.utils import checkpoint as jckpt
from isbfsar_tpu_torch.parallel import parity
from isbfsar_tpu_torch.train import trainer as ttr
from isbfsar_tpu_torch.train.synthetic import episodic_batch
from isbfsar_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

TOL_PARAM_N, TOL_LOSS = 6e-8 + 2e-8, 1e-6


def _jax_step(n_batch, init_params, batch, tmp_path, **kw):
    """JAX's 1-device trainer's run_epoch(0) on ``batch`` from
    ``init_params``: (summary, params as numpy)."""
    jcfg = dataclasses.replace(jc.ARConfig.for_input("skeleton"), batch_size=n_batch,
                               n_task=n_batch, eval_every_n_epoch=10_000, **kw)
    jt = jtr.Trainer(jcfg, mesh=make_mesh(1), log_dir=str(tmp_path / "jax"), use_wandb=False)
    jt.load_state({"params": init_params, "batch_stats": {},
                   "opt_state": jt.optimizer.init(init_params)})
    summary = jt.run_epoch(0, [batch], train=True)
    return summary, jax.tree.map(np.asarray, jt.params)


def _held_to_jax(report, n_batch, tmp_path):
    trees = report["trees"]
    batch = episodic_batch(parity._cfg("skeleton", n_batch), n_batch, 32, "skeleton", seed=0)
    summary, params = _jax_step(n_batch, trees["init"][0], batch, tmp_path)
    assert parity.max_diff(params, trees["many"]["params"]) <= TOL_PARAM_N
    for k in ("train/fs_loss", "train/os_loss"):
        assert abs(trees["many"]["summary"][k] - summary[k]) <= TOL_LOSS, k


def test_dp_skeleton_certificate_and_jax(tmp_path):
    """DDP over 2 ranks, one episode each: the 1-device step to 2e-6 (JAX's
    bound), and JAX's 1-device step."""
    report = parity.dp_parity_check(2, trees=True)
    assert report["max_param_diff"] <= 2e-6 and report["bn_stat_leaves"] == 0
    _held_to_jax(report, 2, tmp_path)


def test_fsdp_certificate_and_jax(tmp_path):
    """FSDP2 over 2 ranks: the 1-device step to 2e-6 with more than half of
    the elements split by ``fsdp_spec`` (leaves it would replicate, split
    by FSDP2 on dim 0, are not counted), and JAX's 1-device step."""
    report = parity.fsdp_parity_check(2, trees=True)
    assert report["max_param_diff"] <= 2e-6
    assert report["sharded_leaves"] >= 4 and report["sharded_elem_frac"] > 0.5
    _held_to_jax(report, 2, tmp_path)


def test_open_set_loss_counts_the_whole_batch(tmp_path):
    """4 episodes over 2 ranks, where the few-shot head is right on 0 of
    rank 0's and 1 of rank 1's: the open-set terms divide by the count over
    the whole batch and gate on any episode of it, so the DDP step and its
    losses equal JAX's 1-device step (a per-rank count would halve the
    discriminator's gradient here, and rank 0's gate would be shut)."""
    cfg = parity._cfg("skeleton", 4)
    batch = episodic_batch(cfg, 4, 32, "skeleton", seed=0)
    trainer = ttr.Trainer(cfg, log_dir=str(tmp_path / "one"), use_wandb=False, device="cpu")
    with torch.no_grad():
        _, metrics = trainer.loss_fn(trainer._prepare(batch), True, train=False)
    correct = metrics["fs_correct"].int().tolist()
    assert (sum(correct[:2]), sum(correct[2:])) == (0, 1), correct
    many = parity._n_rank_step(2, cfg, batch, "cpu", None)[0]
    summary, params = _jax_step(4, many["init"][0], batch, tmp_path)
    assert summary["train/os_loss"] > 0.1
    for k in ("train/fs_loss", "train/os_loss"):
        assert abs(many["summary"][k] - summary[k]) <= TOL_LOSS, (k, many["summary"][k], summary[k])
    assert parity.max_diff(params, many["params"]) <= TOL_PARAM_N
    # the summaries hold the whole batch's episodes
    assert many["summary"]["train/fs_accuracy"] == 0.25


@pytest.fixture(scope="module")
def rgb_one_device():
    """The 1-device rgb step both rgb checks hold their 2 ranks against."""
    return parity.one_device_step(*parity._dp_case(2, "rgb"))


def test_dp_rgb_certificate(rgb_one_device):
    """DDP rgb over 2 ranks with the BatchNorm statistics synced: within
    JAX's scale-aware bounds (this CPU reads param_rel_diff 0.017, stats
    1.8e-5, metrics 1.0e-3), BatchNorm leaves present and moved."""
    report = parity.dp_parity_check(2, modality="rgb", one=rgb_one_device)
    assert report["bn_stat_leaves"] == 106
    assert report["param_rel_diff"] <= 0.10 and report["max_stats_diff"] <= 1e-3
    assert report["max_metric_diff"] <= 0.05


def test_bn_fault_injection_rejected(rgb_one_device):
    """The negative control: the same DDP rgb step with each rank's
    BatchNorm on its own episode fails the rgb bounds by more than JAX's
    margins (this CPU reads 16x and 480x)."""
    report = parity.bn_fault_injection_check(2, one=rgb_one_device)
    assert report["rel_diff_margin"] > 3.0
    assert report["stats_diff_margin"] > 10.0


def test_sharded_checkpoint_resumes_in_jax(tmp_path):
    """An FSDP2 run over 2 ranks, three steps with optimize_every 2 (so the
    checkpoint is written mid-accumulation, by rank 0, from whole tensors):
    JAX's trainer restores it with its own template, holds the same state,
    and its next step equals the port's 1-device trainer's from the same
    file."""
    cfg = dataclasses.replace(parity._cfg("skeleton", 2), n_task=6, optimize_every=2,
                              first_milestone=1, second_milestone=1,
                              checkpoint_dir=str(tmp_path / "ckpt"))
    batches = [episodic_batch(cfg, 2, 32, "skeleton", seed=s) for s in range(4)]
    out = parity.fit_over_ranks(cfg, batches[:3], 2, str(tmp_path / "log"),
                                param_sharding="fsdp")
    path = tckpt.latest_checkpoint(str(tmp_path / "ckpt"))
    assert path.endswith("0.msgpack")
    jcfg = dataclasses.replace(jc.ARConfig.for_input("skeleton"), batch_size=2, n_task=6,
                               optimize_every=2, first_milestone=1, second_milestone=1)
    jt = jtr.Trainer(jcfg, mesh=make_mesh(1), log_dir=str(tmp_path / "jax"), use_wandb=False)
    jt.load_state(jckpt.load_checkpoint(path, {
        "params": jt.params, "batch_stats": jt.batch_stats, "opt_state": jt.opt_state}))
    assert int(jt.opt_state.mini_step) == 1 and int(jt.opt_state.gradient_step) == 1
    assert parity.max_diff(jax.tree.map(np.asarray, jt.params), out["state"]["params"]) == 0.0
    pt = ttr.Trainer(cfg, log_dir=str(tmp_path / "port"), use_wandb=False, device="cpu", seed=3)
    pt.load_state(tckpt.load_checkpoint(path, {"params": None, "batch_stats": None,
                                               "opt_state": None}))
    jt.run_epoch(0, batches[3:], train=True)
    pt.run_epoch(0, batches[3:], train=True)
    assert parity.max_diff(jax.tree.map(np.asarray, jt.params),
                           parity._numpy(pt.params)) <= TOL_PARAM_N


@pytest.mark.slow
def test_multihost_dp_step_matches_single_device():
    """2 nodes of 2 ranks (torchrun's node environment): each rank holds
    only its own row of the batch, the batch spans both nodes, and the DDP
    step equals the 1-device step (2e-6)."""
    from isbfsar_tpu_torch.parallel.multihost import multihost_dp_parity

    report = multihost_dp_parity(num_processes=2, local_devices=2)
    assert report["num_processes"] == 2 and report["global_devices"] == 4
    assert report["batch_processes_spanned"] == 2 and report["local_shards"] == 2
    assert report["rows_held"] == 1
    assert report["max_param_diff"] <= 2e-6 and report["max_metric_diff"] <= 2e-6
