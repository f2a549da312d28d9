"""The port's placement rules against the JAX package's own functions, its
refusals (the trainer's and train_cli's, a mesh without a process group,
a failing or hung rank), and train_cli under torchrun on CPU ranks."""

import dataclasses
import operator
import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from isbfsar_tpu.parallel import mesh as jmesh
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.parallel import mesh as tmesh
from isbfsar_tpu_torch.parallel.launch import run_ranks
from isbfsar_tpu_torch.train import trainer as ttr
from isbfsar_tpu_torch.train.synthetic import generate_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dim(spec: PartitionSpec, axis: str):
    """The dim a JAX spec splits over ``axis``, or None."""
    dims = [d for d, name in enumerate(tuple(spec)) if name == axis]
    return dims[0] if dims else None


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("shape", [(1920, 256), (256, 1920), (90, 180), (180, 90), (128,), (),
                                   (4099, 3), (16, 128), (64, 256), (256, 2048, 3, 3)])
def test_fsdp_spec_is_jax_rule(shape, n):
    assert tmesh.fsdp_spec(shape, n) == _dim(jmesh.fsdp_spec(shape, n), "dp")


def _jax_leaf(path, shape):
    """A torch (path, (out, in) shape) -> JAX's (path, kernel shape)."""
    last = {"weight": "kernel"}.get(path[-1], path[-1])
    return path[:-1] + (last,), tuple(reversed(shape)) if last == "kernel" else shape


TP_LEAVES = [
    (("sk_extractor", "fc1", "weight"), (180, 90)),
    (("sk_extractor", "fc1", "bias"), (180,)),
    (("sk_extractor", "fc2", "weight"), (256, 180)),
    (("sk_extractor", "fc2", "bias"), (256,)),
    (("transformer", "k_linear", "weight"), (128, 512)),
    (("transformer", "v_linear", "bias"), (128,)),
    (("transformer", "norm_k", "weight"), (128,)),
    (("discriminator", "reduce", "weight"), (16, 128)),
    (("discriminator", "fc1", "weight"), (256, 1920)),
    (("discriminator", "fc1", "bias"), (256,)),
    (("discriminator", "fc2", "weight"), (64, 256)),
    (("discriminator", "fc3", "weight"), (1, 64)),
    (("acc_grads", "sk_extractor", "fc2", "weight"), (256, 180)),
    (("acc_grads", "transformer", "k_linear", "bias"), (128,)),
    (("rgb_extractor", "post", "weight"), (256, 2048)),
    (("count",), ()),
]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("path,shape", TP_LEAVES, ids=[".".join(p) for p, _ in TP_LEAVES])
def test_tp_spec_is_jax_rule(path, shape, n):
    """On torch's (out, in) layout: JAX's kernel dim 0 (in) is torch dim 1."""
    jpath, jshape = _jax_leaf(path, shape)
    want = _dim(jmesh.tp_spec(jpath, jshape, n), "tp")
    if want is not None and jpath[-1] == "kernel":
        want = 1 - want
    assert tmesh.tp_spec(path, shape, n) == want


@pytest.mark.parametrize("key,ndim", [("support_set", 6), ("support_set", 4),
                                      ("target_set", 5), ("unknown_set", 3),
                                      ("support_classes", 2), ("target_class", 1)])
def test_sp_batch_spec_is_jax_rule(key, ndim):
    assert tmesh.sp_batch_spec(key, ndim) == tuple(jmesh.sp_batch_spec(key, ndim))


def test_tp_plan_pairs():
    """The plan over the skeleton TRXOS at tp 2: the column/row pairs."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    from isbfsar_tpu_torch.models.trx import TRXOS

    plan = tmesh.tp_plan(TRXOS(tc.ARConfig.for_input("skeleton")), 2)
    kinds = {k: type(v) for k, v in plan.items()}
    assert kinds == {"sk_extractor.fc1": ColwiseParallel, "sk_extractor.fc2": RowwiseParallel,
                     "transformer.k_linear": ColwiseParallel,
                     "transformer.v_linear": ColwiseParallel,
                     "discriminator.reduce": RowwiseParallel,
                     "discriminator.fc1": ColwiseParallel, "discriminator.fc2": RowwiseParallel}


def test_shard_batch_keeps_the_ranks_rows():
    """shard_batch / shard_batch_sp on a fake 2x2 mesh: the rank's rows
    and time slice, per sp_batch_spec."""
    import numpy as np

    class FakeMesh:
        mesh_dim_names = ("dp", "sp")

        def size(self, i):
            return 2

        def get_local_rank(self, axis):
            return {"dp": 1, "sp": 0}[axis]

    batch = {"support_set": {"sk": np.arange(2 * 3 * 4).reshape(2, 3, 4)},
             "target_set": {"sk": np.arange(8).reshape(2, 4)},
             "target_class": np.array([5, 7])}
    sp = tmesh.shard_batch_sp(batch, FakeMesh())
    np.testing.assert_array_equal(sp["support_set"]["sk"], batch["support_set"]["sk"][1:, :, :2])
    np.testing.assert_array_equal(sp["target_set"]["sk"], [[4, 5]])
    np.testing.assert_array_equal(sp["target_class"], [7])
    dp = tmesh.shard_batch(batch, FakeMesh())
    np.testing.assert_array_equal(dp["target_set"]["sk"], [[4, 5, 6, 7]])


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_mesh_needs_a_process_group(device):
    """No quiet CPU or one-device mesh: without a process group both raise."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tmesh.make_mesh(device=device)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tmesh.make_mesh_2d((1, 1), ("dp", "tp"), device)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, torn down after the test."""
    root = tempfile.mkdtemp()
    dist.init_process_group("gloo", store=dist.FileStore(f"{root}/store", 1), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kw,error", [
    (dict(param_sharding="zero9000"), "param_sharding"),
    (dict(param_sharding="tp"), "'tp' axis"),
    (dict(seq_axis="sp"), "not in mesh axes"),
    (dict(mesh_axes=("sp", "tp")), "no 'dp' axis"),
    (dict(param_sharding="fsdp", mesh_axes=()), "need a mesh"),
    (dict(seq_axis="sp", mesh_axes=()), "need a mesh")])
def test_trainer_refusals(one_rank_group, tmp_path, kw, error):
    """The JAX trainer's validation errors, on a mesh of one rank; a
    sharding asked for without a mesh is refused even with a group up."""
    axes = kw.pop("mesh_axes", None)
    mesh = (tmesh.make_mesh(device="cpu") if axes is None
            else None if not axes else tmesh.make_mesh_2d((1, 1), axes, "cpu"))
    with pytest.raises(ValueError, match=error):
        ttr.Trainer(tc.ARConfig.for_input("skeleton"), log_dir=str(tmp_path), use_wandb=False,
                    device="cpu", mesh=mesh, **kw)


def test_trainer_refuses_an_indivisible_time_axis():
    """seq_len 15 on a dp1 x sp2 mesh of two ranks: each rank refuses."""
    from isbfsar_tpu_torch.parallel import parity

    cfg = dataclasses.replace(parity._cfg("skeleton", 1), seq_len=15)
    with pytest.raises(RuntimeError, match="seq_len=15 not divisible by the 'sp' mesh axis"):
        run_ranks(parity._rank_step, 2, "cpu", 60, cfg, {}, "cpu", (1, 2), ("dp", "sp"),
                  "replicated", "sp")


def test_failing_and_hung_ranks_raise():
    """A rank's exception comes back with its traceback; a rank that never
    returns is killed at the deadline."""
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        run_ranks(operator.truediv, 2, "cpu", 60, 1, 0)
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 4"):
        run_ranks(time.sleep, 2, "cpu", 4, 60)
    assert time.monotonic() - t < 30


def _cli(*args, torchrun=False):
    env = {**os.environ, "PYTHONPATH": REPO}
    lead = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2"] if torchrun else [sys.executable])
    return subprocess.run(lead + ["-m", "isbfsar_tpu_torch.train.train_cli", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("args,why", [
    (["--param-sharding", "tp", "--tp-degree", "3"], "--tp-degree 3 does not divide 1 devices"),
    (["--sp-degree", "3"], "--sp-degree 3 does not divide 1 devices"),
    (["--param-sharding", "tp", "--sp-degree", "1"], "composes with replicated/fsdp")])
def test_cli_refuses_bad_degrees(tmp_path, args, why):
    proc = _cli("--data", str(tmp_path), "--device", "cpu", *args)
    assert proc.returncode == 2 and why in proc.stderr, proc.stderr


def test_cli_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2`` with --param-sharding fsdp on CPU
    ranks: one validation and one training epoch, one checkpoint (rank 0's)."""
    generate_dataset(str(tmp_path / "tree"), n_classes=30, clips_per_class=2, seed=0)
    proc = _cli("--data", str(tmp_path / "tree"), "--epochs", "2", "--n-task", "4",
                "--batch-size", "2", "--log-dir", str(tmp_path / "log"), "--device", "cpu",
                "--param-sharding", "fsdp", torchrun=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("done on cpu") == 2
    assert sorted(os.listdir(tmp_path / "log" / "checkpoints")) == ["1.json", "1.msgpack"]
