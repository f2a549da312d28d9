"""End-to-end learning demo: episodic training + FSOS eval on synthetic data
(port of ``examples/train_fsos_demo.py``).

Generate an NTU-like synthetic dataset (class-distinct joint sinusoids),
train the TRX-OS episodic objective on 14 classes, evaluate the FSOS
protocol on 6 held-out classes, on the card unless ``--device`` says
otherwise:

    python -m isbfsar_tpu_torch.examples.train_fsos_demo [--epochs 30] [--out runs/fsos_demo]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time
from typing import Dict, Optional


def run_demo(out: str, epochs: int = 30, n_task: int = 64, batch_size: int = 16,
             fsos_repeats: int = 5, device: str = "cuda") -> Dict:
    """Train ``epochs`` epochs of ``n_task`` episodes and evaluate FSOS on
    the held-out classes; returns {"epochs": [each epoch's summary], "fsos":
    the FSOS summary, "train_s": the training wall}."""
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator
    from isbfsar_tpu_torch.train.fsos import evaluate_fsos, summarize
    from isbfsar_tpu_torch.train.synthetic import generate_dataset
    from isbfsar_tpu_torch.train.trainer import Trainer

    root = os.path.join(out, "data")
    os.makedirs(root, exist_ok=True)
    names = generate_dataset(root, n_classes=20, clips_per_class=6, n_frames=16, seed=3)
    print("dataset: 20 classes x 6 clips (14 train / 6 held out)")

    cfg = dataclasses.replace(
        ARConfig.for_input("skeleton"),
        n_task=n_task, batch_size=batch_size, eval_every_n_epoch=10_000,
        checkpoint_dir=os.path.join(out, "ckpt"),
    )
    sampler = EpisodicSampler(root, k=5, n_task=cfg.n_task, max_l=16, l=16, seed=1)
    sampler.all_classes = names[:14]

    trainer = Trainer(cfg, sampler, log_dir=os.path.join(out, "run"), use_wandb=False,
                      device=device)
    t0 = time.time()
    summaries = []
    for epoch in range(epochs):
        summary = trainer.run_epoch(
            epoch, batch_iterator(sampler, cfg.batch_size, seed=epoch), train=True
        )
        summaries.append(summary)
        if epoch % 5 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: fs_loss={summary['train/fs_loss']:.3f} "
                  f"fs_acc={summary['train/fs_accuracy']:.3f} "
                  f"os_acc={summary['train/os_accuracy']:.3f}")
    train_s = time.time() - t0
    print(f"trained {epochs} epochs in {train_s:.0f}s")

    test_root = os.path.join(out, "test")
    if os.path.isdir(test_root):
        shutil.rmtree(test_root)
    for c in names[14:]:
        shutil.copytree(os.path.join(root, c), os.path.join(test_root, c))
    results = evaluate_fsos(
        cfg, trainer.params, test_root, test_root,
        k=5, n_repeats=fsos_repeats, batch_size=6, n_test_classes=6, device=device,
    )
    fsos = summarize(results)
    print("FSOS on held-out classes:", fsos)
    return {"epochs": summaries, "fsos": fsos, "train_s": train_s}


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--out", default=os.path.join("runs", "fsos_demo"))
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)
    run_demo(args.out, args.epochs, device=args.device)


if __name__ == "__main__":
    main()
