"""Training entry point (port of ``isbfsar_tpu/train/train_cli.py``).

The dataset protocol: the 20 NTU-120 hold-out test classes (every 6th
class, A1, A7, ..., A115) are left out of training, and the remaining
classes split 80/20 into train/val in list order. Class ids resolve through
the JAX package's ``assets/nturgbd_classes.txt`` ("A{n}. name." lines),
read by path.

    python -m isbfsar_tpu_torch.train.train_cli --data <dataset_root> \\
        [--input-type skeleton|rgb|hybrid] [--remat] [--epochs 100] [--batch-size 32] \\
        [--device cuda|cpu] [--resume CKPT]

``--device`` defaults to ``cuda`` and fails without a card. ``--resume``
takes a checkpoint of either package, with ``batch_stats`` in rgb and
hybrid. ``--remat`` recomputes the rgb extractor per residual block in the
backward pass. The JAX package's ``fsdp``/``tp`` sharding and
``--sp-degree`` (several devices, ROADMAP A.17) are not ported and exit
with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Tuple

from isbfsar_tpu_torch.configs import ASSETS_DIR, ARConfig

NTU_TEST_IDS = [f"A{i}" for i in range(1, 116, 6)]  # A1, A7, ..., A115


def load_ntu_class_names(path: str = "") -> Dict[str, str]:
    """'A{n}. name.' lines -> {A{n}: sanitized_name}."""
    path = path or os.path.join(ASSETS_DIR, "nturgbd_classes.txt")
    mapping = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if "." not in line:
                continue
            index, name, *_ = line.split(".")
            name = name.strip().replace(" ", "_").replace("/", "-").replace("’", "")
            mapping[index.strip()] = name
    return mapping


def ntu_splits(all_classes: List[str]) -> Tuple[List[str], List[str], List[str]]:
    """(train, val, test) class-name lists per the reference protocol."""
    mapping = load_ntu_class_names()
    test_names = {mapping[i] for i in NTU_TEST_IDS if i in mapping}
    test = [c for c in all_classes if c in test_names]
    rest = [c for c in all_classes if c not in test_names]
    idx = int(len(rest) * 0.8)
    return rest[:idx], rest[idx:], test


def unported(args) -> str:
    """Why the options asked for cannot run in the port, or ''."""
    if args.param_sharding != "replicated":
        return (f"--param-sharding {args.param_sharding}: the port trains on one device; "
                "fsdp/tp become DDP/FSDP (ROADMAP A.17)")
    if args.sp_degree:
        return "--sp-degree: sequence parallelism is not ported (ROADMAP A.17)"
    return ""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True)
    parser.add_argument("--input-type", default="skeleton",
                        choices=["skeleton", "rgb", "hybrid"])
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--n-task", type=int, default=None)
    parser.add_argument("--log-dir", default="runs/trx")
    parser.add_argument("--resume", default=None,
                        help="msgpack checkpoint to resume, written by either package")
    parser.add_argument("--param-sharding", default="replicated",
                        choices=["replicated", "fsdp", "tp"],
                        help="only replicated is ported (one device)")
    parser.add_argument("--tp-degree", type=int, default=2,
                        help="tensor-parallel axis size under --param-sharding tp (not ported)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the rgb extractor per residual block in the backward "
                             "pass (less activation memory, one more forward)")
    parser.add_argument("--sp-degree", type=int, default=0,
                        help="sequence-parallel axis size (not ported)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)

    why = unported(args)
    if why:
        print(f"[train] {why}", file=sys.stderr)
        return 2
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"[train] --device {args.device}: no CUDA device is available (pass --device cpu "
              "to train on the CPU)", file=sys.stderr)
        return 2

    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, list_classes
    from isbfsar_tpu_torch.train.trainer import Trainer
    from isbfsar_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = ARConfig.for_input(args.input_type)
    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.n_task:
        overrides["n_task"] = args.n_task
    if args.remat:
        overrides["remat"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    train_classes, val_classes, test_classes = ntu_splits(list_classes(args.data))
    print(f"[train] classes: {len(train_classes)} train / {len(val_classes)} val / "
          f"{len(test_classes)} held-out test")

    common = dict(k=cfg.way, n_task=cfg.n_task, max_l=16, l=cfg.seq_len,
                  input_type=cfg.input_type)
    train_sampler = EpisodicSampler(args.data, seed=0, **common)
    valid_sampler = EpisodicSampler(args.data, seed=1, **common)
    train_sampler.all_classes = train_classes or train_sampler.all_classes
    valid_sampler.all_classes = val_classes or valid_sampler.all_classes

    trainer = Trainer(cfg, train_sampler, valid_sampler, log_dir=args.log_dir,
                      device=args.device)
    if args.resume:
        state = load_checkpoint(args.resume, {"params": None, "batch_stats": None,
                                              "opt_state": None})
        trainer.load_state(state)
        print(f"[train] resumed from {args.resume}")

    summary = trainer.fit(n_epochs=args.epochs)
    print(f"[train] done on {trainer.device}: {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
