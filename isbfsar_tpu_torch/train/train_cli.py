"""Training entry point (port of ``isbfsar_tpu/train/train_cli.py``).

The dataset protocol: the 20 NTU-120 hold-out test classes (every 6th
class, A1, A7, ..., A115) are left out of training, and the remaining
classes split 80/20 into train/val in list order. Class ids resolve through
the JAX package's ``assets/nturgbd_classes.txt`` ("A{n}. name." lines),
read by path.

    python -m isbfsar_tpu_torch.train.train_cli --data <dataset_root> \\
        [--input-type skeleton|rgb|hybrid] [--remat] [--epochs 100] [--batch-size 32] \\
        [--device cuda|cpu] [--resume CKPT] \\
        [--param-sharding replicated|fsdp|tp] [--tp-degree 2] [--sp-degree N]

    torchrun --nproc-per-node 4 -m isbfsar_tpu_torch.train.train_cli --data <root> \\
        --param-sharding fsdp

``--device`` defaults to ``cuda`` and fails without a card. ``--resume``
takes a checkpoint of either package, with ``batch_stats`` in rgb and
hybrid. ``--remat`` recomputes the rgb extractor per residual block in the
backward pass.

Under ``torchrun`` (its ``RANK``/``WORLD_SIZE`` environment) every rank
joins the process group (NCCL on the card, each rank on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and trains its share of
each batch over a mesh of all the ranks: ``dp`` with DDP, or with
``--param-sharding fsdp`` FSDP2; ``--param-sharding tp`` a dp x tp mesh of
``--tp-degree``; ``--sp-degree`` a dp x sp mesh with the clips' time axis
split (with replicated or fsdp parameters, not tp). A degree that does not
divide the ranks (or ``seq_len``) exits with an error. Without a launcher
the run is one device; a sharding option then makes a one-rank group, as
the JAX CLI's options run on a one-device mesh. Every rank reads the whole
batch from its own loader and keeps its rows; only rank 0 writes
checkpoints and the metrics file.
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


def init_group(device: str) -> str:
    """Join the launcher's process group (or make a one-rank one); returns
    this rank's device."""
    import datetime
    import tempfile

    import torch.distributed as dist

    cuda = device.startswith("cuda")
    backend = "nccl" if cuda else "gloo"
    timeout = datetime.timedelta(minutes=30)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="train_cli_"), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=timeout)
    if cuda:
        import torch

        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    return device


def build_mesh(args, cfg, device: str):
    """(mesh, seq_axis) for the options over the group's ranks, or an error string."""
    import torch.distributed as dist

    from isbfsar_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    n = dist.get_world_size()
    if args.param_sharding == "tp":
        if args.sp_degree:
            return "--sp-degree composes with replicated/fsdp param sharding, not tp"
        tp = args.tp_degree
        if n % tp:
            return f"--tp-degree {tp} does not divide {n} devices"
        print(f"[train] tensor-parallel mesh: dp{n // tp} x tp{tp}")
        return make_mesh_2d((n // tp, tp), ("dp", "tp"), device), None
    if args.sp_degree:
        sp = args.sp_degree
        if n % sp:
            return f"--sp-degree {sp} does not divide {n} devices"
        if cfg.seq_len % sp:
            return f"--sp-degree {sp} does not divide seq_len={cfg.seq_len}"
        print(f"[train] sequence-parallel mesh: dp{n // sp} x sp{sp}")
        return make_mesh_2d((n // sp, sp), ("dp", "sp"), device), "sp"
    return make_mesh(device=device), None


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
                        help="replicated = DDP over the ranks; fsdp = FSDP2 parameter and "
                             "optimizer-state sharding over dp; tp = tensor parallelism over a "
                             "dp x tp mesh (--tp-degree)")
    parser.add_argument("--tp-degree", type=int, default=2,
                        help="tensor-parallel axis size under --param-sharding tp")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the rgb extractor per residual block in the backward "
                             "pass (less activation memory, one more forward)")
    parser.add_argument("--sp-degree", type=int, default=0,
                        help="sequence-parallel axis size: each rank embeds L/sp frames of "
                             "every clip (rgb and hybrid)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)

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

    mesh, seq_axis, device = None, None, args.device
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if launched or args.param_sharding != "replicated" or args.sp_degree:
        device = init_group(args.device)
        built = build_mesh(args, cfg, device)
        if isinstance(built, str):
            print(f"[train] {built}", file=sys.stderr)
            return 2
        mesh, seq_axis = built

    train_classes, val_classes, test_classes = ntu_splits(list_classes(args.data))
    print(f"[train] classes: {len(train_classes)} train / {len(val_classes)} val / "
          f"{len(test_classes)} held-out test")

    common = dict(k=cfg.way, n_task=cfg.n_task, max_l=16, l=cfg.seq_len,
                  input_type=cfg.input_type)
    train_sampler = EpisodicSampler(args.data, seed=0, **common)
    valid_sampler = EpisodicSampler(args.data, seed=1, **common)
    train_sampler.all_classes = train_classes or train_sampler.all_classes
    valid_sampler.all_classes = val_classes or valid_sampler.all_classes

    trainer = Trainer(cfg, train_sampler, valid_sampler, log_dir=args.log_dir, device=device,
                      mesh=mesh, param_sharding=args.param_sharding, seq_axis=seq_axis)
    if args.resume:
        state = load_checkpoint(args.resume, {"params": None, "batch_stats": None,
                                              "opt_state": None})
        trainer.load_state(state)
        print(f"[train] resumed from {args.resume}")

    summary = trainer.fit(n_epochs=args.epochs)
    print(f"[train] done on {trainer.device}: {summary}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
