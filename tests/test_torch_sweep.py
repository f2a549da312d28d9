"""The mutual-gaze sweep of the port (``train/sweep.py``) against the JAX
package's: the named grid, a missing dataset skipped, the ``only_best``
quirk (the reference runs only the first entry), the mean and ``np.var``
over folds, and the CLI with ``--device``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from isbfsar_tpu.train import sweep as jsweep
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.train import sweep as tsweep
from tests.test_torch_mutualgaze_train import write_watching_tree

torch.set_num_threads(2)

CFG = dataclasses.replace(tc.MutualGazeConfig(), crop_size=32, lr=1e-3)


def test_default_grid_names_match_jax():
    grid = tsweep.default_grid()
    assert [e.group for e in grid] == [e.group for e in jsweep.default_grid()] == [
        "RNET MARIA SMALL", "RNET MARIA BIG", "RNET MY SMALL", "RNET MY BIG",
        "MNET MARIA SMALL", "MNET MARIA BIG", "MNET MY SMALL", "MNET MY BIG"]
    for t, j in zip(grid, jsweep.default_grid(small="a", big="b")):
        assert t.config.backbone == j.config.backbone and t.augment == j.augment
    assert grid[0].config.backbone == "resnet50" and grid[4].config.backbone == "resnet18"
    assert grid[0].augment and not grid[2].augment
    assert [e.dataset for e in tsweep.default_grid("a", "b")[:2]] == ["a", "b"]


def test_sweep_runs_and_skips_missing(tmp_path):
    root = str(tmp_path / "sweeproot")
    write_watching_tree(os.path.join(root, "tiny"), n_per=2)
    os.makedirs(os.path.join(root, "empty"))
    grid = [tsweep.SweepEntry("A TINY", CFG, "tiny", augment=True),
            tsweep.SweepEntry("B MISSING", CFG, "absent_dataset", augment=False),
            tsweep.SweepEntry("C EMPTY", CFG, "empty")]
    summary = tsweep.run_sweep(root, grid=grid, n_epochs=1, batch_size=4,
                               log_dir=str(tmp_path / "log"), ckpt_dir=str(tmp_path / "ck"),
                               only_best=False, device="cpu")
    assert set(summary) == {"A TINY"}
    stats = summary["A TINY"]
    assert set(stats) == {f"{k}{v}" for k in ("accuracy", "precision", "recall", "f1")
                          for v in ("", "_var")}
    assert 0.0 <= stats["f1"] <= 1.0 and stats["f1_var"] >= 0.0
    assert os.listdir(tmp_path / "ck" / "A_TINY")
    logged = [json.loads(line) for line in open(tmp_path / "log" / "metrics.jsonl")]
    assert [r.get("reason") for r in logged if r.get("skipped")] == [
        "missing dataset absent_dataset", "no sessions under empty"]


def test_sweep_summary_is_mean_and_var_over_folds(tmp_path, monkeypatch):
    """The reference prints the mean and np.var (not the std) over folds."""
    folds = [{"accuracy": 0.5, "f1": 0.2}, {"accuracy": 1.0, "f1": 0.6}]
    monkeypatch.setattr(tsweep.MutualGazeTrainer, "cross_validate",
                        lambda self, *a, **k: folds)
    root = str(tmp_path / "root")
    os.makedirs(os.path.join(root, "d"))
    summary = tsweep.run_sweep(root, grid=[tsweep.SweepEntry("G", CFG, "d")],
                               log_dir=str(tmp_path / "log"), device="cpu")
    assert summary["G"]["accuracy"] == 0.75 and summary["G"]["accuracy_var"] == 0.0625
    assert summary["G"]["f1_var"] == pytest.approx(np.var([0.2, 0.6]))


def test_only_best_runs_first_entry(tmp_path):
    root = str(tmp_path / "sweeproot")
    write_watching_tree(os.path.join(root, "tiny"), n_per=2)
    grid = [tsweep.SweepEntry("FIRST", CFG, "tiny"), tsweep.SweepEntry("SECOND", CFG, "tiny")]
    summary = tsweep.run_sweep(root, grid=grid, n_epochs=1, batch_size=4,
                               log_dir=str(tmp_path / "log"), device="cpu")
    assert set(summary) == {"FIRST"}


def test_cli_runs_first_entry_on_the_cpu(tmp_path, capsys):
    root = str(tmp_path / "sweeproot")
    write_watching_tree(os.path.join(root, "small"), n_per=2, size=224)
    rc = tsweep.main([root, "--small", "small", "--big", "big", "--epochs", "1",
                      "--batch-size", "4", "--log-dir", str(tmp_path / "log"),
                      "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert list(summary) == ["RNET MARIA SMALL"]  # the first entry, a ResNet-50
    assert os.listdir(tmp_path / "ck" / "RNET_MARIA_SMALL")


def test_cli_without_a_card_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would train on it")
    assert tsweep.main([str(tmp_path), "--device", "cuda"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
