"""rgb and hybrid training state against the JAX package on the CPU: the
evaluation step reads the running averages, remat gives the same step
with fewer bytes saved for the backward pass, and checkpoints with
``batch_stats`` pass between the packages (``tests/torch_rgb_parity.py``
has the CI-size set-up).

- The evaluation step (JAX's ``train=False``) in float64, with running
  stats away from their init, within ``torch_rgb_parity.TOL_STEP_64``.
- Remat on against off: one ``Trainer.step`` gives the same parameters,
  accumulated gradients and running stats, bit for bit on this CPU; the
  bytes saved for the backward pass of the step's forward (activations:
  the tensors autograd packs, by storage, plus the inputs a checkpoint
  keeps; parameters not counted) drop by 40% or more, the bound of JAX's
  ``tests/test_train.py::test_remat_cuts_train_step_memory``.
- A JAX trainer's checkpoint tree with running stats is read by the
  port, which writes back the same bytes; a port checkpoint after a step
  is read by the JAX trainer's ``load_checkpoint`` (the same bytes again)
  and by JAX's ``eval_cli._load_params``, and resumes in the port.
"""

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu.models.trx import TRXOS as JaxTRXOS
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.train import eval_cli as jax_eval_cli
from isbfsar_tpu.train import trainer as jtr
from isbfsar_tpu.utils import checkpoint as jckpt
from isbfsar_tpu_torch.models.resnet import Bottleneck
from isbfsar_tpu_torch.train import eval_cli, evals
from isbfsar_tpu_torch.train import trainer as ttr
from isbfsar_tpu_torch.utils import checkpoint as tckpt
from isbfsar_tpu_torch.weights import msgpack_dumps
from tests import torch_rgb_parity as P

torch.set_num_threads(2)

CKPT_KEYS = {"params": None, "batch_stats": None, "opt_state": None}
REMAT_CUT = 0.6  # saved bytes with remat at most 60% of those without


def moved_stats(variables: dict, seed: int = 2) -> dict:
    """``variables`` with running stats away from their init (mean 0,
    var 1), so that reading them shows."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        if path[-1].key == "mean":
            return (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (leaf * rng.uniform(0.5, 1.5, size=leaf.shape)).astype(np.float32)

    return {**variables,
            "batch_stats": jax.tree_util.tree_map_with_path(move, variables["batch_stats"])}


def port_trainer(mode: str, tmp_path, variables: dict, **kw) -> ttr.Trainer:
    trainer = ttr.Trainer(P.configs(mode, **kw)[1], log_dir=str(tmp_path), use_wandb=False,
                          device="cpu")
    trainer.load_state({**trainer.state(), **variables})
    return trainer


def test_eval_step_reads_the_running_averages(tmp_path):
    """The evaluation loss with moved running stats matches JAX's
    ``train=False`` and writes no running average; a float32 trainer's
    validation epoch leaves its state as it was."""
    mode = "rgb"
    variables, batch = moved_stats(P.init_variables(mode)), P.batch(mode)
    jcfg = P.configs(mode, "float64")[0]
    with jax.enable_x64(True):
        loss_fn = jtr.make_loss_fn(JaxTRXOS(jcfg), jcfg)
        v = P.cast(variables, "float64")
        _, want = jax.jit(lambda p, s, b: loss_fn(p, s, b, True, train=False))(
            v["params"], v["batch_stats"], P.jax_batch(batch, "float64"))
        want = jax.tree.map(np.asarray, want)
    model = P.port_model(mode, variables, "float64")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _, got = ttr.make_loss_fn(model, model.config)(P.torch_batch(batch, torch.float64), True,
                                                       train=False)
    tol = P.TOL_STEP_64
    np.testing.assert_array_equal(got["fs_correct"].numpy(), want["fs_correct"])
    for k in ("fs_loss", "os_loss"):
        assert abs(float(got[k]) - float(want[k])) <= tol["loss"], k
    for k in ("os_known_pred", "os_unknown_pred"):
        assert float(np.max(np.abs(got[k].numpy() - want[k]))) <= tol["pred"], k
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k

    trainer = port_trainer(mode, tmp_path, variables)
    state = msgpack_dumps(trainer.state())
    trainer.run_epoch(0, [batch], train=False)
    assert msgpack_dumps(trainer.state()) == state


def saved_bytes(trainer: ttr.Trainer, batch: dict) -> int:
    """Bytes of the activations the step's forward keeps for the backward
    pass: every tensor autograd packs (by storage, once), and each
    Bottleneck's input, which a checkpoint keeps to recompute the block;
    the parameters are not counted."""
    params = {p.untyped_storage().data_ptr() for p in trainer.model.parameters()}
    seen = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            seen[storage.data_ptr()] = storage.nbytes()
        return t

    hooks = [m.register_forward_pre_hook(lambda m, args: pack(args[0]))
             for m in trainer.model.modules() if isinstance(m, Bottleneck)]
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            trainer.loss_fn(trainer._prepare(batch), True, stats=[])
    finally:
        for h in hooks:
            h.remove()
    return sum(seen.values())


@pytest.mark.parametrize("mode", ["rgb", "hybrid"])
def test_remat_gives_the_same_step_and_keeps_less(mode, tmp_path):
    variables, batch = P.init_variables(mode), P.batch(mode)
    saved, states = {}, {}
    for remat in (False, True):
        trainer = port_trainer(mode, tmp_path / str(remat), variables, remat=remat,
                               optimize_every=2)
        assert trainer.model.rgb_extractor.ResNet_0.remat == remat
        saved[remat] = saved_bytes(trainer, batch)
        trainer.step(batch, disc_on=True)
        states[remat] = P.numpy_tree(trainer.state())
    for path, a, b in P.walk(states[False], states[True]):
        np.testing.assert_array_equal(a, b, err_msg=path)
    print(f"{mode}: saved for backward {saved[False] / 2**20:.1f} MiB without remat, "
          f"{saved[True] / 2**20:.1f} MiB with")
    assert saved[True] <= REMAT_CUT * saved[False], saved


def test_checkpoints_with_batch_stats_pass_between_the_packages(tmp_path):
    mode = "rgb"
    jcfg, pcfg = P.configs(mode, optimize_every=2)
    variables = moved_stats(P.init_variables(mode))
    jt = jtr.Trainer(jcfg, mesh=make_mesh(1), log_dir=str(tmp_path / "jax"), use_wandb=False)
    jt.load_state({**variables, "opt_state": jt.optimizer.init(variables["params"])})
    template = {"params": jt.params, "batch_stats": jt.batch_stats, "opt_state": jt.opt_state}
    with open(jckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), 0, template), "rb") as f:
        data = f.read()
    port = ttr.Trainer(pcfg, log_dir=str(tmp_path / "port"), use_wandb=False, device="cpu")
    port.load_state(tckpt.load_checkpoint(str(tmp_path / "jax_ckpt" / "0.msgpack"), CKPT_KEYS))
    assert msgpack_dumps(port.state()) == data  # JAX -> port

    port.step(P.batch(mode), disc_on=True)  # moves the stats, half an accumulation
    path = tckpt.save_checkpoint(str(tmp_path / "ckpt"), 0, port.state())
    with open(path, "rb") as f:
        written = f.read()
    restored = jckpt.load_checkpoint(path, template)
    again = jckpt.save_checkpoint(str(tmp_path / "jax_again"), 0,
                                  {k: restored[k] for k in ("params", "batch_stats", "opt_state")})
    with open(again, "rb") as f:
        assert f.read() == written  # port -> JAX
    want = P.numpy_tree(port.state())
    assert int(np.asarray(restored["opt_state"].mini_step)) == 1
    got = jax_eval_cli._load_params(jcfg, path)
    for key in ("params", "batch_stats"):
        for p, a, b in P.walk(want[key], jax.tree.map(np.asarray, got[key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}{p}")

    resumed = ttr.Trainer(pcfg, log_dir=str(tmp_path / "resumed"), use_wandb=False,
                          device="cpu", seed=5)
    resumed.load_state(tckpt.load_checkpoint(path, CKPT_KEYS))
    assert msgpack_dumps(resumed.state()) == written
    model, _ = evals.load_model(pcfg, eval_cli._load_params(path), "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, port.model.state_dict()[k]), k
    with pytest.raises(RuntimeError, match="Missing key"):  # rgb needs its running stats
        evals.load_model(pcfg, {"params": want["params"]}, "cpu")
