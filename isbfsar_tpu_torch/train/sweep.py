"""Mutual-gaze configuration sweep (port of ``isbfsar_tpu/train/sweep.py``).

The reference's named grid {RNET | MNET backbone} x {MARIA | MY
augmentation} x {SMALL | BIG dataset}, each point run through the
leave-one-session-out cross-validation of ``MutualGazeTrainer`` with
best-F1 checkpoints; per group the mean and ``np.var`` over folds. "MNET"
maps to ResNet-18, the augmentation axis toggles the online flip (MARIA
on, MY off). By default only the grid's first entry runs (the reference
ships with ``groups = groups[:1]``); a missing dataset is skipped with a
log line.

    python -m isbfsar_tpu_torch.train.sweep ROOT [--all] [--epochs N] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and exits 2 without a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from isbfsar_tpu_torch.configs import MutualGazeConfig
from isbfsar_tpu_torch.train.mutualgaze import MutualGazeTrainer
from isbfsar_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass(frozen=True)
class SweepEntry:
    """One named grid point."""

    group: str
    config: MutualGazeConfig
    dataset: str  # subdirectory name under the sweep root
    augment: bool = True  # online flip augmentation (the MARIA/MY axis)


def default_grid(small: str = "focus_dataset",
                 big: str = "focus_dataset_big_easy") -> List[SweepEntry]:
    """The reference's 8 named configurations in its order."""
    grid = []
    for model, mname in (("resnet50", "RNET"), ("resnet18", "MNET")):
        for aug, aname in (("maria", "MARIA"), ("my", "MY")):
            for dataset, dname in ((small, "SMALL"), (big, "BIG")):
                grid.append(SweepEntry(group=f"{mname} {aname} {dname}",
                                       config=MutualGazeConfig(backbone=model), dataset=dataset,
                                       augment=(aug == "maria")))
    return grid


def run_sweep(
    root: str,
    grid: Optional[Sequence[SweepEntry]] = None,
    n_epochs: int = 1,
    batch_size: int = 8,
    log_dir: str = "runs/mutualgaze_sweep",
    ckpt_dir: Optional[str] = None,
    only_best: bool = True,
    seed: int = 0,
    device: str = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Run the grid; returns {group: {metric: mean, metric_var: var}}.

    root: one subdirectory per dataset variant, each a session tree as
    ``WatchingDataset`` reads. only_best: run the first entry alone."""
    grid = list(grid if grid is not None else default_grid())
    if only_best:
        grid = grid[:1]
    logger = MetricsLogger(log_dir, project="mutual_gaze")
    summary: Dict[str, Dict[str, float]] = {}
    try:
        for entry in grid:
            data_root = os.path.join(root, entry.dataset)
            if not os.path.isdir(data_root):
                logger.log({"group": entry.group, "skipped": 1,
                            "reason": f"missing dataset {entry.dataset}"})
                continue
            trainer = MutualGazeTrainer(
                entry.config, seed=seed,
                log_dir=os.path.join(log_dir, entry.group.replace(" ", "_")), device=device)
            fold_ckpt = (os.path.join(ckpt_dir, entry.group.replace(" ", "_"))
                         if ckpt_dir else None)
            try:
                results = trainer.cross_validate(data_root, n_epochs=n_epochs,
                                                 batch_size=batch_size, ckpt_dir=fold_ckpt,
                                                 augment=entry.augment)
            finally:
                trainer.logger.close()
            if not results:  # the dataset directory holds no sessions
                logger.log({"group": entry.group, "skipped": 1,
                            "reason": f"no sessions under {entry.dataset}"})
                continue
            # mean and variance (np.var, as the reference prints) over folds
            stats: Dict[str, float] = {}
            for key in results[0]:
                vals = np.asarray([r[key] for r in results], np.float64)
                stats[key] = float(vals.mean())
                stats[f"{key}_var"] = float(vals.var())
            summary[entry.group] = stats
            logger.log({"group": entry.group, **stats})
    finally:
        logger.close()
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", help="directory of dataset variants")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--log-dir", default="runs/mutualgaze_sweep")
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--all", action="store_true",
                        help="run the full 8-config grid (default: first only)")
    parser.add_argument("--small", default="focus_dataset")
    parser.add_argument("--big", default="focus_dataset_big_easy")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"[sweep] --device {args.device}: no CUDA device is available (pass --device cpu "
              "to train on the CPU)", file=sys.stderr)
        return 2
    summary = run_sweep(args.root, grid=default_grid(args.small, args.big),
                        n_epochs=args.epochs, batch_size=args.batch_size, log_dir=args.log_dir,
                        ckpt_dir=args.ckpt_dir, only_best=not args.all, device=args.device)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
