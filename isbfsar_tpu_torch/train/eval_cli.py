"""Evaluation CLI (port of ``isbfsar_tpu/train/eval_cli.py``):

    python -m isbfsar_tpu_torch.train.eval_cli fsos --data <queries> --exemplars <ex> \\
        --checkpoint runs/trx/checkpoints/29.msgpack [--repeats 10] [--calibrate <train tree>] \\
        [--plot fsos.png]
    python -m isbfsar_tpu_torch.train.eval_cli episodic --data <queries> --checkpoint ...
    python -m isbfsar_tpu_torch.train.eval_cli confusion --data <queries> --exemplars <ex> \\
        --checkpoint ... [--plot cm.png]

It reads a checkpoint of either package. ``--device`` defaults to ``cuda``
and fails without a card. ``--plot`` draws with matplotlib, which the card
machine lacks: plot on a host that has it.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_params(path: str):
    """The recognizer's Flax variables ``{"params": ...}`` from a trainer
    checkpoint ({params, batch_stats, opt_state}) of either package, with
    ``"batch_stats"`` where it holds an rgb or hybrid model's BatchNorm
    running averages."""
    from isbfsar_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(path, {"params": None, "batch_stats": None, "opt_state": None})
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    return variables


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["fsos", "episodic", "confusion"])
    parser.add_argument("--data", required=True)
    parser.add_argument("--exemplars", default=None)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--input-type", default="skeleton",
                        choices=["skeleton", "rgb", "hybrid"])
    parser.add_argument("--k", type=int, default=5)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--plot", default=None,
                        help="fsos and confusion modes: write the plot to this PNG (needs "
                             "matplotlib)")
    parser.add_argument("--os-threshold", type=float, default=0.5,
                        help="open-set decision threshold for fsos mode (the reference "
                             "protocol's 0.5; pass a calibrate_os_threshold result to score "
                             "at the calibrated gate)")
    parser.add_argument("--calibrate", default=None, metavar="TRAIN_TREE",
                        help="fsos mode: first calibrate the open-set threshold on this "
                             "training-class tree and report both thresholds' metrics")
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on (default cuda; no fallback to the CPU)")
    args = parser.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"[eval] --device {args.device}: no CUDA device is available (pass --device cpu "
              "to evaluate on the CPU)", file=sys.stderr)
        return 2

    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.dataloader import list_classes

    cfg = ARConfig.for_input(args.input_type)
    params = _load_params(args.checkpoint)
    exemplars = args.exemplars or args.data

    if args.mode == "fsos":
        from isbfsar_tpu_torch.train.fsos import (calibrate_os_threshold, evaluate_fsos,
                                                  metrics_at_threshold, summarize)

        results = evaluate_fsos(
            cfg, params, args.data, exemplars, k=args.k, n_repeats=args.repeats,
            batch_size=args.batch_size, n_test_classes=len(list_classes(exemplars)),
            os_threshold=args.os_threshold, collect_raw=bool(args.calibrate),
            device=args.device,
        )
        print(json.dumps(summarize(results)))
        if args.calibrate:
            calib = calibrate_os_threshold(
                cfg, params, args.calibrate, k=args.k,
                n_repeats=args.repeats, batch_size=args.batch_size, device=args.device,
            )
            print(json.dumps({"os_calibration": calib}))
            print(json.dumps({
                f"fsos@{calib['os_threshold']}": summarize(
                    metrics_at_threshold(results["_raw"], calib["os_threshold"]))
            }))
        if args.plot:
            from isbfsar_tpu_torch.train.evals import plot_fsos

            plot_fsos(results, args.plot)
    elif args.mode == "episodic":
        from isbfsar_tpu_torch.train.evals import episodic_test

        metrics = episodic_test(cfg, params, args.data, batch_size=args.batch_size,
                                device=args.device)
        print(json.dumps(metrics))
    else:
        from isbfsar_tpu_torch.train.evals import discriminator_confusion, plot_confusion

        classes = list_classes(exemplars)
        matrix = discriminator_confusion(cfg, params, args.data, exemplars, classes,
                                         device=args.device)
        print(json.dumps({"classes": classes, "matrix": matrix.tolist()}))
        if args.plot:
            plot_confusion(matrix, classes, args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
