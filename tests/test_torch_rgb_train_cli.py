"""The port's train and eval CLIs in rgb on the CPU, as subprocesses, at
the smallest episode count and batch: ``train_cli --input-type rgb
--remat`` for 2 epochs (epoch 0 validates, epoch 1 trains and writes its
checkpoint, whose ``batch_stats`` moved off their init), ``eval_cli fsos
--input-type rgb`` on that checkpoint, and ``train_cli --resume`` from it.
The trees hold 64x64 PNG crops, which the loader resizes to 224."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from isbfsar_tpu_torch.train.synthetic import generate_dataset
from isbfsar_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_KEYS = {"params": None, "batch_stats": None, "opt_state": None}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A 30-class tree (the 80/20 split leaves 6 validation classes) and a
    5-class held-out tree, one clip a class."""
    base = tmp_path_factory.mktemp("rgb_cli")
    generate_dataset(str(base / "train"), n_classes=30, clips_per_class=1, with_images=True,
                     image_size=64, seed=0)
    generate_dataset(str(base / "held"), n_classes=5, clips_per_class=1, with_images=True,
                     image_size=64, seed=1)
    return base


def _run(module, *args):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", f"isbfsar_tpu_torch.train.{module}", *args,
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_rgb_train_and_eval_clis_with_remat(trees):
    log = trees / "log"
    small = ["--n-task", "1", "--batch-size", "1", "--log-dir", str(log)]
    proc = _run("train_cli", "--data", str(trees / "train"), "--input-type", "rgb", "--remat",
                "--epochs", "2", *small)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "24 train / 6 val" in proc.stdout and "done on cpu" in proc.stdout
    ckpt = tckpt.latest_checkpoint(str(log / "checkpoints"))
    assert ckpt.endswith("1.msgpack")
    stats = tckpt.load_checkpoint(ckpt, CKPT_KEYS)["batch_stats"]["rgb_extractor"]["ResNet_0"]
    assert len(stats) == 17  # the stem's BatchNorm and the 16 blocks
    assert not np.allclose(stats["bn1"]["var"].numpy(), 1.0)  # moved by the training step

    proc = _run("eval_cli", "fsos", "--input-type", "rgb", "--data", str(trees / "held"),
                "--checkpoint", ckpt, "--repeats", "1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"FSOS-ACC", "FS-ACC", "OS-ACC"}

    proc = _run("train_cli", "--data", str(trees / "train"), "--input-type", "rgb", "--epochs",
                "1", "--resume", ckpt, *small)
    assert proc.returncode == 0 and "resumed from" in proc.stdout, proc.stdout + proc.stderr
