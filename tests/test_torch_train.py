"""The port's recognizer training against the JAX package's, on the CPU.

Both packages start from the JAX init (``jax.random.key(0)``), carried
across by the weight bridge, and see the same batches: each batch is built
by the JAX data loader with one thread, so the episodes are a function of
the seeds (with more threads, which episode gets which draw depends on
scheduling, in both packages). The model is the production ``ARConfig``
(way 5, seq_len 16, 30 joints, DISC head); only the batch (4-8) and the
number of steps are small.

Tolerances, each a few times what this CPU reads (oneDNN against XLA, both
float32):
- the forward: logits 2e-5 (read 3.8e-6 of 22.6), is_true 5e-7 (1.2e-7),
  prototypes 1.5e-5 (3.0e-6 of 2.5), attention 6e-7 (1.5e-7);
- losses 1e-6 (read 2.4e-7 of 2.7); every gradient leaf 3e-7 absolute
  (read at most 9.1e-8; the entries reach 0.07);
- parameters after the steps 6e-8 absolute (read 1.5e-8; the updates are
  lr * gradient, lr 1e-2 then 1e-4), the accumulated gradients 3e-7 (read
  7.5e-8).
``fs_correct``, the gate ``w``, the counters and the open-set summaries are
equal exactly; each test first asserts that ``fs_correct`` agrees, since a
flipped argmax would change the discriminator's gradient discontinuously.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from isbfsar_tpu import configs as jc
from isbfsar_tpu.models.trx import TRXOS as JaxTRXOS
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.train import dataloader as jdl
from isbfsar_tpu.train import eval_cli as jax_eval_cli
from isbfsar_tpu.train import trainer as jtr
from isbfsar_tpu.train.synthetic import generate_dataset as jax_generate_dataset
from isbfsar_tpu.utils import checkpoint as jckpt
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.train import dataloader as tdl
from isbfsar_tpu_torch.train import trainer as ttr
from isbfsar_tpu_torch.train.synthetic import episodic_batch, generate_dataset
from isbfsar_tpu_torch.utils import checkpoint as tckpt
from isbfsar_tpu_torch.weights import (convert_variables, msgpack_dumps, msgpack_restore,
                                       to_flax_variables)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_FORWARD = {"logits": 2e-5, "is_true": 5e-7, "prototypes": 1.5e-5, "attention": 6e-7}
TOL_LOSS, TOL_GRAD, TOL_PARAM, TOL_ACC = 1e-6, 3e-7, 6e-8, 3e-7
CKPT_KEYS = {"params": None, "batch_stats": None, "opt_state": None}


def _cfgs(**kw):
    return (dataclasses.replace(jc.ARConfig.for_input("skeleton"), **kw),
            dataclasses.replace(tc.ARConfig.for_input("skeleton"), **kw))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_tree"))
    jax_generate_dataset(root, n_classes=8, clips_per_class=3, seed=0)
    return root


@pytest.fixture(scope="module")
def jax_vars():
    cfg = jc.ARConfig.for_input("skeleton")
    q = {"sk": jnp.zeros((1, cfg.seq_len, 90))}
    s = {"sk": jnp.zeros((1, cfg.way, cfg.seq_len, 90))}
    variables = JaxTRXOS(cfg).init(jax.random.key(0), q, jnp.ones((1, cfg.way), bool),
                                   support_data=s)
    return jax.tree.map(np.asarray, variables)


def _batches(tree, n, b, seed):
    sampler = jdl.EpisodicSampler(tree, k=5, n_task=n * b, max_l=16, l=16, seed=seed)
    return list(jdl.batch_iterator(sampler, b, num_threads=1, seed=seed))


def _torch_batch(batch):
    return {k: ({m: torch.from_numpy(v) for m, v in batch[k].items()} if k.endswith("_set")
                else torch.from_numpy(np.asarray(batch[k], np.int32)))
            for k in ("support_set", "target_set", "unknown_set", "support_classes",
                      "target_class")}


def _jax_state(trainer):
    """A JAX trainer's {params, batch_stats, opt_state} as its checkpoint
    tree, numpy leaves."""
    tree = {"params": trainer.params, "batch_stats": trainer.batch_stats,
            "opt_state": trainer.opt_state}
    return jax.tree.map(np.asarray, serialization.to_state_dict(tree))


def _port_state(trainer):
    return jax.tree.map(lambda t: t.numpy(), trainer.state())


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def _check_state(want, got, what):
    """Trees equal in layout, dtype and shape; counters exact, parameters
    within TOL_PARAM and accumulated gradients within TOL_ACC."""
    for path, a, b in _walk(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path, a.dtype, b.dtype)
        tol = 0.0 if a.dtype.kind == "i" else TOL_ACC if "acc_grads" in path else TOL_PARAM
        err = float(np.max(np.abs(a.astype(np.float64) - b))) if a.size else 0.0
        assert err <= tol, f"{what} {path}: {err} > {tol}"


def _trainer_pair(jax_cfg, port_cfg, tmp_path, jax_vars):
    """A JAX trainer and a port trainer that starts from the JAX one's
    state, carried across as the JAX checkpoint's bytes."""
    jt = jtr.Trainer(jax_cfg, mesh=make_mesh(1), log_dir=str(tmp_path / "jax"),
                     use_wandb=False)
    jt.load_state({"params": jax_vars["params"], "batch_stats": {},
                   "opt_state": jt.optimizer.init(jax_vars["params"])})
    pt = ttr.Trainer(port_cfg, log_dir=str(tmp_path / "port"), use_wandb=False, device="cpu")
    pt.load_state(msgpack_restore(serialization.to_bytes(_jax_state(jt))))
    return jt, pt


def test_generate_dataset_writes_the_jax_files(tmp_path):
    jax_generate_dataset(str(tmp_path / "jax"), n_classes=3, clips_per_class=2, seed=5)
    generate_dataset(str(tmp_path / "port"), n_classes=3, clips_per_class=2, seed=5)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 3 * 2 * 16
    for f in files:
        with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("support", ["support_data", "support_features"])
def test_forward_matches_jax(jax_vars, support):
    jcfg, pcfg = _cfgs()
    model = TRXOS(pcfg)
    model.load_state_dict(convert_variables(jax_vars), strict=True)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 16, 90)).astype(np.float32)
    s = rng.normal(size=(4, 5, 16, 90)).astype(np.float32)
    mask = np.ones((4, 5), bool)
    mask[1, 3] = mask[2, 0] = False
    jm = JaxTRXOS(jcfg)
    if support == "support_data":
        want = jm.apply(jax_vars, {"sk": q}, mask, support_data={"sk": s})
        with torch.no_grad():
            got = model({"sk": torch.from_numpy(q)}, torch.from_numpy(mask),
                        support_data={"sk": torch.from_numpy(s)})
    else:
        feats = np.array(jm.apply(jax_vars, {"sk": s}, method=JaxTRXOS.extract_features))
        want = jm.apply(jax_vars, {"sk": q}, mask, support_features=feats)
        with torch.no_grad():
            got = model({"sk": torch.from_numpy(q)}, torch.from_numpy(mask),
                        support_features=torch.from_numpy(feats))
    np.testing.assert_array_equal(got["support_features"].numpy(),
                                  np.asarray(want["support_features"]))
    logits = np.asarray(want["logits"])
    live = logits > -1e29
    np.testing.assert_array_equal(got["logits"].numpy()[~live], logits[~live])
    for key, tol in TOL_FORWARD.items():
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.shape == b.shape, key
        if key == "logits":
            a, b = a[live], b[live]
        err = float(np.max(np.abs(a - b)))
        assert err <= tol, f"{key}: {err} > {tol}"


@pytest.mark.parametrize("disc_on", [False, True])
def test_loss_and_gradients_match_jax(tree, jax_vars, disc_on):
    jcfg, pcfg = _cfgs()
    batch = _batches(tree, 1, 8, seed=3)[0]
    model = TRXOS(pcfg)
    model.load_state_dict(convert_variables(jax_vars), strict=True)
    jloss = jtr.make_loss_fn(JaxTRXOS(jcfg), jcfg)
    keys = ("support_set", "target_set", "unknown_set", "support_classes", "target_class")
    (jtotal, jmet), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax_vars["params"], {}, {k: batch[k] for k in keys}, disc_on)
    total, met = ttr.make_loss_fn(model, pcfg)(_torch_batch(batch), disc_on)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)

    fs_correct = met["fs_correct"].numpy()
    np.testing.assert_array_equal(fs_correct, np.asarray(jmet["fs_correct"]))
    assert 0 < fs_correct.sum() < fs_correct.size  # the gate is exercised both ways
    assert abs(float(total.detach()) - float(jtotal)) <= TOL_LOSS
    assert abs(float(met["fs_loss"].detach()) - float(jmet["fs_loss"])) <= TOL_LOSS
    if disc_on:
        np.testing.assert_array_equal(met["os_weights"].numpy(), np.asarray(jmet["os_weights"]))
        assert abs(float(met["os_loss"].detach()) - float(jmet["os_loss"])) <= TOL_LOSS
        for k in ("os_known_pred", "os_unknown_pred"):
            assert float(np.max(np.abs(met[k].detach().numpy() - np.asarray(jmet[k])))) <= 5e-7
    else:
        assert "os_loss" not in met
    got = to_flax_variables(dict(zip(names, grads)))["params"]
    for path, a, b in _walk(jax.tree.map(np.asarray, jgrads), got):
        err = float(np.max(np.abs(a - b)))
        assert err <= TOL_GRAD, f"gradient {path}: {err} > {TOL_GRAD}"


def test_bce_clips_like_jax():
    pred = np.array([0.0, 1e-9, 0.3, 0.5, 1.0 - 1e-9, 1.0], np.float32)
    for target in (np.ones_like(pred), np.zeros_like(pred)):
        want = np.asarray(jtr._bce(jnp.asarray(pred), jnp.asarray(target)))
        got = ttr._bce(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("first,second,every,n_task", [
    (1, 1, 1, 8), (1, 2, 1, 8), (2, 2, 2, 12), (0, 3, 3, 20)])
def test_learning_rate_schedule_matches_optax(tmp_path, first, second, every, n_task):
    """The trainer's MultiStepLR over inner updates gives the lr that optax's
    piecewise-constant schedule gives at each count, duplicate milestones
    compounding, and ``load_state`` at a count restores that lr."""
    jcfg, pcfg = _cfgs(first_milestone=first, second_milestone=second, optimize_every=every,
                       n_task=n_task, batch_size=4)
    inner = max(1, (n_task // 4) // every)
    boundaries = jtr.milestone_boundaries(jcfg, inner)
    assert ttr.milestone_boundaries(pcfg, inner) == boundaries
    schedule = optax.piecewise_constant_schedule(jcfg.initial_lr, boundaries)
    trainer = ttr.Trainer(pcfg, log_dir=str(tmp_path), use_wandb=False, device="cpu")
    state = trainer.state()
    for count in range(4 * inner + 2):
        lr = trainer.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(schedule(count)), rtol=1e-6)
        resumed = ttr.Trainer(pcfg, log_dir=str(tmp_path), use_wandb=False, device="cpu")
        state["opt_state"]["inner_opt_state"]["1"]["count"] = torch.tensor(count, dtype=torch.int32)
        resumed.load_state(state)
        assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(lr, rel=1e-12)
        trainer.optimizer.step()
        trainer.scheduler.step()


def _summaries_match(want, got):
    """Losses within TOL_LOSS, accuracies and open-set metrics exact."""
    assert set(want) == set(got)
    for k, v in want.items():
        if k.endswith("_loss"):
            assert abs(got[k] - v) <= TOL_LOSS, (k, v, got[k])
        else:
            assert got[k] == v, (k, v, got[k])


@pytest.mark.parametrize("every,n_task,steps", [(1, 8, 3), (2, 12, 5)])
def test_steps_match_jax(tree, jax_vars, tmp_path, every, n_task, steps):
    """``run_epoch`` on the same batches from the same init: summaries,
    parameters and the whole optimizer state. first == second == 1 puts the
    100x drop inside the run (at inner update 2 with optimize_every 1, at 1
    with optimize_every 2, whose 3-step epochs leave it mid-accumulation);
    then a validation epoch on the same batches."""
    jcfg, pcfg = _cfgs(n_task=n_task, batch_size=4, optimize_every=every, first_milestone=1,
                       second_milestone=1, eval_every_n_epoch=1000)
    jt, pt = _trainer_pair(jcfg, pcfg, tmp_path, jax_vars)
    batches = _batches(tree, steps, 4, seed=7)
    _summaries_match(jt.run_epoch(0, batches, train=True), pt.run_epoch(0, batches, train=True))
    _check_state(_jax_state(jt), _port_state(pt), f"after {steps} steps")
    assert pt.mini_step == steps % every and pt.gradient_step == steps // every
    assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    _summaries_match(jt.run_epoch(1, batches, train=False), pt.run_epoch(1, batches, train=False))
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]


def test_discriminator_starts_at_its_epoch(tree, jax_vars, tmp_path):
    """Before ``start_discriminator_after_epoch`` the summaries carry no
    open-set loss and the discriminator does not move, in both packages."""
    jcfg, pcfg = _cfgs(n_task=8, batch_size=4, start_discriminator_after_epoch=2)
    jt, pt = _trainer_pair(jcfg, pcfg, tmp_path, jax_vars)
    batches = _batches(tree, 2, 4, seed=8)
    want, got = jt.run_epoch(1, batches, train=True), pt.run_epoch(1, batches, train=True)
    _summaries_match(want, got)
    assert got["train/os_loss"] == 0.0
    before = convert_variables(jax_vars)
    after = pt.model.state_dict()
    for k in before:
        if k.startswith("discriminator."):
            assert torch.equal(before[k], after[k]), k
    _check_state(_jax_state(jt), _port_state(pt), "disc off")


def test_fit_matches_jax(tree, jax_vars, tmp_path):
    """``fit`` with injected batches: epoch 0 validates (no step, no
    checkpoint), epoch 1 trains and writes {1.msgpack, 1.json}; the two
    packages' checkpoints hold the same tree."""
    jcfg, pcfg = _cfgs(n_task=8, batch_size=4, eval_every_n_epoch=2)
    jcfg = dataclasses.replace(jcfg, checkpoint_dir=str(tmp_path / "jax_ckpt"))
    pcfg = dataclasses.replace(pcfg, checkpoint_dir=str(tmp_path / "port_ckpt"))
    jt, pt = _trainer_pair(jcfg, pcfg, tmp_path, jax_vars)
    jt.valid_sampler = pt.valid_sampler = "valid"
    per_epoch = {0: _batches(tree, 2, 4, seed=9), 1: _batches(tree, 2, 4, seed=10)}
    seen = []

    def batches_fn(sampler, epoch):
        seen.append((sampler, epoch))
        return per_epoch[epoch]

    _summaries_match(jt.fit(2, batches_fn), pt.fit(2, batches_fn))
    assert seen == [("valid", 0), (None, 1)] * 2
    assert sorted(os.listdir(tmp_path / "port_ckpt")) == ["1.json", "1.msgpack"]
    path = tckpt.latest_checkpoint(str(tmp_path / "port_ckpt"))
    assert path.endswith("1.msgpack")
    with open(tmp_path / "port_ckpt" / "1.json") as a, open(tmp_path / "jax_ckpt" / "1.json") as b:
        assert json.load(a) == json.load(b) == {"step": 1, "epoch": 1}
    want = tckpt.load_checkpoint(jckpt.latest_checkpoint(str(tmp_path / "jax_ckpt")), CKPT_KEYS)
    _check_state(jax.tree.map(lambda t: t.numpy(), want),
                 jax.tree.map(lambda t: t.numpy(), tckpt.load_checkpoint(path, CKPT_KEYS)),
                 "fit checkpoints")


def test_jax_checkpoint_resumes_in_the_port(tree, jax_vars, tmp_path):
    """A JAX checkpoint written mid-accumulation (optimize_every 2, 3 steps):
    the port reads it, writes back the same bytes, and its next step equals
    the JAX trainer's next step."""
    jcfg, pcfg = _cfgs(n_task=12, batch_size=4, optimize_every=2, first_milestone=1,
                       second_milestone=1)
    jt, _ = _trainer_pair(jcfg, pcfg, tmp_path, jax_vars)
    batches = _batches(tree, 4, 4, seed=11)
    jt.run_epoch(0, batches[:3], train=True)
    path = jckpt.save_checkpoint(str(tmp_path / "ckpt"), 0, {
        "params": jt.params, "batch_stats": jt.batch_stats, "opt_state": jt.opt_state})
    pt = ttr.Trainer(pcfg, log_dir=str(tmp_path / "port"), use_wandb=False, device="cpu", seed=3)
    pt.load_state(tckpt.load_checkpoint(path, CKPT_KEYS))
    assert (pt.mini_step, pt.gradient_step, pt.scheduler.last_epoch) == (1, 1, 1)
    with open(path, "rb") as f:
        assert msgpack_dumps(pt.state()) == f.read()
    jt.run_epoch(0, batches[3:], train=True)
    pt.run_epoch(0, batches[3:], train=True)
    _check_state(_jax_state(jt), _port_state(pt), "the step after a JAX checkpoint")


def test_port_checkpoint_resumes_in_jax(tree, jax_vars, tmp_path):
    """A port checkpoint written mid-accumulation: the JAX trainer restores
    it with its own template (``load_checkpoint`` + ``load_state``) and its
    next step equals the port's; JAX's eval_cli reads its parameters."""
    jcfg, pcfg = _cfgs(n_task=12, batch_size=4, optimize_every=2, first_milestone=1,
                       second_milestone=1)
    _, pt = _trainer_pair(jcfg, pcfg, tmp_path, jax_vars)
    batches = _batches(tree, 4, 4, seed=12)
    pt.run_epoch(0, batches[:3], train=True)
    path = tckpt.save_checkpoint(str(tmp_path / "ckpt"), 0, pt.state(), meta={"epoch": 0})
    jt = jtr.Trainer(jcfg, mesh=make_mesh(1), log_dir=str(tmp_path / "jax2"), use_wandb=False,
                     seed=5)
    jt.load_state(jckpt.load_checkpoint(path, {
        "params": jt.params, "batch_stats": jt.batch_stats, "opt_state": jt.opt_state}))
    _check_state(_port_state(pt), _jax_state(jt), "restored by JAX")
    variables = jax_eval_cli._load_params(jcfg, path)
    for p, a, b in _walk(jax.tree.map(np.asarray, variables["params"]), pt.state()["params"]):
        np.testing.assert_array_equal(a, b, err_msg=p)
    jt.run_epoch(0, batches[3:], train=True)
    pt.run_epoch(0, batches[3:], train=True)
    _check_state(_jax_state(jt), _port_state(pt), "the step after a port checkpoint")


def _raw(leaf):
    """(dtype name, shape, bytes) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        leaf = leaf.numpy()
    else:
        leaf = np.asarray(leaf)
        name = leaf.dtype.name
        if name == "bfloat16":
            leaf = leaf.view(np.int16)
    return name, leaf.shape, leaf.tobytes()


def _same_bits(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same_bits(a[k], b[k], f"{path}/{k}")
    else:
        assert _raw(a) == _raw(b), path


def test_msgpack_round_trip_is_bit_for_bit():
    """``msgpack_dumps`` -> ``msgpack_restore`` gives back every leaf bit for
    bit (NaN, -0.0, inf, bfloat16, 0-d, empty and wide arrays, keys of every
    length class), and Flax's own decoder reads the same tree."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 70)).astype(np.float32)
    f32[0, :3] = [np.nan, -0.0, np.inf]
    bf16 = torch.randn(4, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tree = {
        "a" * 40: {"f32": torch.from_numpy(f32), "i32": torch.tensor(7, dtype=torch.int32),
                   "i64": torch.arange(300, dtype=torch.int64), "bf16": bf16,
                   "u8": np.arange(5, dtype=np.uint8), "f64": np.full((2, 1, 2), 2.5),
                   "empty": np.zeros((0, 3), np.float32)},
        "b" * 300: {},
        "c": {str(i): np.full((1,), i - 10, np.int16) for i in range(20)},
    }
    data = msgpack_dumps(tree)
    _same_bits(tree, msgpack_restore(data))
    _same_bits(tree, serialization.msgpack_restore(data))


@pytest.mark.parametrize("kind", ["episodic", "fsos"])
def test_samplers_give_the_jax_episodes(tree, kind):
    """With one loader thread the port's samplers give the JAX episodes,
    array for array."""
    if kind == "episodic":
        def make(dl):
            return dl.EpisodicSampler(tree, k=5, n_task=12, max_l=16, l=8, seed=4)
        kw = {"seed": 2}
    else:
        def make(dl):
            return dl.FSOSEpisodicSampler(tree, tree, support_class_ids=[6, 1, 3], l=16,
                                          exclude_exemplar_queries=True)
        kw = {"shuffle": False, "drop_last": False}
    want = list(jdl.batch_iterator(make(jdl), 5, num_threads=1, **kw))
    got = list(tdl.batch_iterator(make(tdl), 5, num_threads=1, **kw))
    assert len(want) == len(got) > 1
    for w, g in zip(want, got):
        for path, a, b in _walk(w, g):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)
    assert tdl.list_classes(tree) == jdl.list_classes(tree)


def test_episodic_batch_matches_jax():
    from isbfsar_tpu.train.synthetic import episodic_batch as jax_episodic_batch

    jcfg, pcfg = _cfgs()
    want = jax_episodic_batch(jcfg, 3, 224, "skeleton", seed=4)
    for path, a, b in _walk(want, episodic_batch(pcfg, 3, 224, "skeleton", seed=4)):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("kw,what", [
    ({"param_sharding": "fsdp"}, "need a mesh"), ({"param_sharding": "tp"}, "need a mesh"),
    ({"seq_axis": "sp"}, "need a mesh"), ({"input_type": "rgb"}, None),
    ({"input_type": "hybrid", "remat": True}, None)])
def test_trainer_refuses_what_the_port_lacks(tmp_path, kw, what):
    """The several-device options without a mesh (and no process group to
    make one from) are refused, never run replicated; rgb, hybrid and remat
    are accepted (``what`` None)."""
    cfg = tc.ARConfig.for_input(kw.pop("input_type", "skeleton"), remat=kw.pop("remat", False))
    if what is None:
        trainer = ttr.Trainer(cfg, log_dir=str(tmp_path), use_wandb=False, device="cpu", **kw)
        assert trainer.model.rgb_extractor.ResNet_0.remat == cfg.remat
        assert set(trainer.state()["batch_stats"]) == {"rgb_extractor"}
    else:
        with pytest.raises(ValueError, match=what):
            ttr.Trainer(cfg, log_dir=str(tmp_path), use_wandb=False, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        tckpt.save_checkpoint(str(tmp_path), 0, {}, backend="zip")


def test_trainer_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(tc.ARConfig(), log_dir=str(tmp_path), use_wandb=False)
    assert tc.ARConfig.for_input("rgb").initial_lr == jc.ARConfig.for_input("rgb").initial_lr


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def cli_trees(tmp_path_factory):
    """A 30-class tree (the 80/20 split leaves 6 validation classes: a
    5-way episode and its unknown class) and a 5-class held-out tree."""
    base = tmp_path_factory.mktemp("cli")
    generate_dataset(str(base / "train"), n_classes=30, clips_per_class=2, seed=0)
    generate_dataset(str(base / "held"), n_classes=5, clips_per_class=2, seed=1)
    return base


def _run(module, *args):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def test_train_and_eval_clis_on_the_cpu(cli_trees):
    """train_cli for 2 epochs (epoch 0 validates, epoch 1 trains and writes
    its checkpoint), then eval_cli fsos with --calibrate on that checkpoint:
    three JSON lines."""
    log = cli_trees / "log"
    proc = _run("isbfsar_tpu_torch.train.train_cli", "--data", str(cli_trees / "train"),
                "--epochs", "2", "--n-task", "16", "--batch-size", "8", "--log-dir", str(log),
                "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "24 train / 6 val" in proc.stdout and "done on cpu" in proc.stdout
    ckpt = tckpt.latest_checkpoint(str(log / "checkpoints"))
    assert ckpt.endswith("1.msgpack")
    proc = _run("isbfsar_tpu_torch.train.eval_cli", "fsos", "--data", str(cli_trees / "held"),
                "--checkpoint", ckpt, "--calibrate", str(cli_trees / "train"), "--repeats", "2",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert len(lines) == 3
    assert set(lines[0]) == {"FSOS-ACC", "FS-ACC", "OS-ACC"}
    calib = lines[1]["os_calibration"]
    assert 0.0 < calib["os_threshold"] < 1.0 and calib["n_queries"] > 0
    assert list(lines[2]) == [f"fsos@{calib['os_threshold']}"]
    proc = _run("isbfsar_tpu_torch.train.train_cli", "--data", str(cli_trees / "train"),
                "--epochs", "2", "--n-task", "16", "--batch-size", "8", "--log-dir", str(log),
                "--device", "cpu", "--resume", ckpt)
    assert proc.returncode == 0 and "resumed from" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("module,args,why", [
    ("train_cli", ["--param-sharding", "fsdp"], "no CUDA device"),
    ("train_cli", ["--param-sharding", "tp"], "no CUDA device"),
    ("train_cli", ["--sp-degree", "2"], "no CUDA device"),
    ("train_cli", ["--remat"], None),
    ("train_cli", ["--input-type", "rgb"], None),
    ("train_cli", [], "no CUDA device"),
    ("eval_cli", ["--plot", "x.png"], None),
    ("eval_cli", [], "no CUDA device"),
    ("train_cli", ["--input-type", "hybrid", "--remat"], None),
    ("eval_cli", ["--input-type", "rgb"], None)])
def test_clis_refuse_what_they_cannot_run(cli_trees, module, args, why):
    """The sharding options, rgb, hybrid, --remat and --plot are accepted,
    so that without a card they stop only at the device check."""
    if why in (None, "no CUDA device") and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    lead = ["fsos", "--checkpoint", "none.msgpack"] if module == "eval_cli" else []
    proc = _run(f"isbfsar_tpu_torch.train.{module}", *lead, "--data", str(cli_trees / "held"),
                *args)
    assert proc.returncode != 0
    assert (why or "no CUDA device") in proc.stderr, proc.stderr
    assert "A.12" not in proc.stderr
