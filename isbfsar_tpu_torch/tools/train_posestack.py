"""Train the pose stack (YOLOv4 + EfficientNetV2 + MetrabsHead) on synthetic
humanoid scenes and write the parameter tree as Flax msgpack, which the
port's estimator and the JAX package's both load (twin of
``tools/train_posestack.py``, with the same flags and ``--device``).

CI sizes (the default):
    python -m isbfsar_tpu_torch.tools.train_posestack --out pose_ci.msgpack --device cpu

Production sizes (YOLOv4 width 1.0 at 256, EfficientNetV2-L at a 256 crop,
480x640 frames), on the card:
    python -m isbfsar_tpu_torch.tools.train_posestack --production --steps-det 300 \
        --steps-pose 300 --batch 8 --out pose_prod.msgpack
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", help=".msgpack output path (needed unless --eval-only)")
    parser.add_argument("--production", action="store_true",
                        help="full-size nets (YOLOv4 width 1.0 @256, EfficientNetV2-L @256) "
                             "on 480x640 frames")
    parser.add_argument("--steps-det", type=int, default=700)
    parser.add_argument("--steps-pose", type=int, default=700)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=20)
    parser.add_argument("--lr-det", type=float, default=1e-3,
                        help="detector learning rate; about 1e-4 for a warm-started fine-tune")
    parser.add_argument("--lr-pose", type=float, default=1e-3)
    parser.add_argument("--empty-frac", type=float, default=0.12,
                        help="fraction of person-free training scenes")
    parser.add_argument("--pose-mode", choices=["motions", "diverse"], default="motions",
                        help="'diverse': random whole-space articulations and the action "
                             "library, for extraction-quality poses on unseen actions")
    parser.add_argument("--init", default=None,
                        help="warm-start from a previous run's .msgpack weights (the "
                             "optimizer restarts); use a new --seed for fresh scenes")
    parser.add_argument("--eval", type=int, default=0, metavar="N",
                        help="after training, score N fresh person scenes (and N*2//3 empty "
                             "ones) at the 0.3 gate and print one JSON line")
    parser.add_argument("--eval-only", action="store_true",
                        help="skip training; evaluate --init (needs --init and --eval)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the backbones' blocks in the backward pass (YOLO per "
                             "CSP stage, EfficientNetV2 per MBConv): less memory, same step")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_posestack: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    if args.eval_only and not (args.init and args.eval):
        print("train_posestack: --eval-only needs --init and --eval", file=sys.stderr)
        return 2
    if not args.eval_only and not args.out:
        print("train_posestack: --out is required", file=sys.stderr)
        return 2

    from isbfsar_tpu_torch.configs import CameraIntrinsics
    from isbfsar_tpu_torch.models.effnetv2 import V2_L, V2_TINY
    from isbfsar_tpu_torch.train.posestack import train_pose_params
    from isbfsar_tpu_torch.weights import msgpack_dumps, msgpack_restore

    if args.production:
        kw = dict(frame_hw=(480, 640), intrinsics=CameraIntrinsics(), yolo_width=1.0,
                  yolo_input_size=256, crop_size=256, stages=V2_L)
    else:
        kw = dict(frame_hw=(240, 320),
                  intrinsics=CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0,
                                              width=320, height=240),
                  yolo_width=0.25, yolo_input_size=128, crop_size=128, stages=V2_TINY)

    init_params = None
    if args.init:
        with open(args.init, "rb") as f:
            init_params = msgpack_restore(f.read())
        print(f"[train_posestack] warm-starting from {args.init}")

    if args.eval_only:
        params = init_params
    else:
        t0 = time.time()
        params = train_pose_params(
            n_steps_det=args.steps_det, n_steps_pose=args.steps_pose, batch_size=args.batch,
            seed=args.seed, log_every=args.log_every, init_params=init_params,
            empty_frac=args.empty_frac, pose_mode=args.pose_mode, remat=args.remat,
            lr_det=args.lr_det, lr_pose=args.lr_pose, device=args.device, **kw)
        print(f"[train_posestack] trained in {time.time() - t0:.0f}s")
        with open(args.out, "wb") as f:
            f.write(msgpack_dumps(params))
        print(f"[train_posestack] wrote {args.out}")

    if args.eval:
        from isbfsar_tpu_torch.configs import HPEConfig
        from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
        from isbfsar_tpu_torch.train.posestack import evaluate_pose_stack

        hpe_cfg = HPEConfig(yolo_input_size=kw["yolo_input_size"], crop_size=kw["crop_size"],
                            yolo_thresh=0.3)
        est = HumanPoseEstimator(hpe_cfg, kw["intrinsics"], params=params,
                                 backbone_stages=kw["stages"], frame_shape=kw["frame_hw"],
                                 yolo_width=kw["yolo_width"], device=args.device)
        metrics = evaluate_pose_stack(est, kw["frame_hw"], kw["intrinsics"],
                                      n_scenes=args.eval, n_empty=max(args.eval * 2 // 3, 1))
        print("[train_posestack:eval] " + json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
