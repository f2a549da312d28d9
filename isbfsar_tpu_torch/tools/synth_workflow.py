"""The offline action-recognition workflow end to end on the port (twin of
``tools/synth_workflow.py``):

    render action clips -> extract skeletons with the trained pose stack
    -> train TRXOS episodically -> FSOS-evaluate on disjoint held-out classes

The recognizer trains on ``ACTION_TRAIN_CLASSES`` and is FSOS-evaluated
k-way on ``ACTION_TEST_CLASSES``, classes it has never seen, with a
separately rendered exemplar library as the support source. Extraction
runs the estimator with ``skeleton=None`` (the trees store 122 joints) at
the reference's 0.3 detector gate, and smooths each clip with the offline
One-Euro filter. The clip library is PNG frames rendered by the port
(``train/posestack.py``), not ``mp4v`` videos: the receipts of the two
tools differ by that codec's loss, so the two are held to each other stage
by stage on the same frames.

Rendering and extraction resume by file existence, so ``workdir`` keeps a
``manifest.json`` with a fingerprint of the pose weights and every render
and extraction setting, and a run refuses a workdir built under another
configuration, or one with artifacts and no manifest.

CI size (the default: the ``pose-diverse-256`` bundle at 240x320):

    python -m isbfsar_tpu_torch.tools.synth_workflow --workdir runs/synthwf [--device cpu]

``--production`` (the full pose stack on 480x640 frames) needs the 351 MB
``pose-prod-256`` base, and refuses when it is not present.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

ARTIFACT_DIRS = ("videos_train", "videos_test_queries", "videos_test_exemplars", "tree_train",
                 "tree_test_q", "tree_test_ex")


def workflow_fingerprint(pose_params, **render_extract_cfg) -> str:
    """A digest of the pose weights (the bytes of the port's converted state
    dicts, in order) and every render and extraction knob."""
    import torch

    from isbfsar_tpu_torch.weights import convert_pose_stack

    h = hashlib.sha256()
    for _, sd in sorted(convert_pose_stack(pose_params).items()):
        for key in sorted(sd):
            h.update(sd[key].detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    h.update(repr(sorted(render_extract_cfg.items())).encode())
    return h.hexdigest()[:16]


def render_video_library(root: str, classes: Sequence[str], clips_per_class: int, n_frames: int,
                         frame_hw: Tuple[int, int], intrinsics, seed: int = 0,
                         z_range: Tuple[float, float] = (2.0, 3.2)) -> None:
    """Write ``root/<class>/<i>/{0..n_frames-1}.png`` clips with a random
    phase, yaw, depth, lateral offset and cycle count each. A clip whose
    last frame exists is kept; its draws are made all the same, so a rerun
    keeps the generator's stream."""
    from isbfsar_tpu_torch.train.posestack import render_motion_clip
    from isbfsar_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    for ci, cls in enumerate(classes):
        for k in range(clips_per_class):
            phase = float(rng.uniform(0, 2 * np.pi))
            yaw = float(rng.uniform(-0.6, 0.6))
            z = float(rng.uniform(*z_range))
            x = float(rng.uniform(-0.25, 0.25)) * z
            cycles = float(rng.uniform(1.2, 2.2))
            clip_dir = os.path.join(root, cls, str(k))
            if os.path.exists(os.path.join(clip_dir, f"{n_frames - 1}.png")):
                continue
            frames, _ = render_motion_clip(
                cls, n_frames=n_frames, frame_hw=frame_hw, intrinsics=intrinsics,
                center=(x, 0.15, z), yaw=yaw, cycles=cycles, seed=seed * 1000 + ci * 100 + k,
                phase=phase)
            os.makedirs(clip_dir, exist_ok=True)
            for i, f in enumerate(frames):
                write_png(os.path.join(clip_dir, f"{i}.png"), f)


def _check_manifest(workdir: str, fp: str) -> None:
    """Refuse a workdir built under another configuration, or one holding
    artifacts without a manifest; write the manifest of a fresh one."""
    manifest = os.path.join(workdir, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            prior = json.load(f).get("fingerprint")
        if prior != fp:
            raise ValueError(
                f"workdir {workdir} was built under a different configuration (manifest "
                f"fingerprint {prior} != {fp}): its resumable renders/extractions would silently "
                f"poison this run — use a fresh --workdir (or delete this one)")
    elif any(os.path.isdir(os.path.join(workdir, d)) for d in ARTIFACT_DIRS):
        raise ValueError(
            f"workdir {workdir} contains render/extraction artifacts but no manifest.json "
            f"(not built by this tool) — use a fresh --workdir, or delete it to re-render")
    else:
        with open(manifest, "w") as f:
            json.dump({"fingerprint": fp}, f)


def run_workflow(
    pose_params,
    workdir: Optional[str],
    frame_hw: Tuple[int, int],
    intrinsics,
    yolo_width: float = 0.25,
    yolo_input_size: int = 128,
    crop_size: int = 256,
    backbone_stages=None,
    train_classes: Optional[Sequence[str]] = None,
    test_classes: Optional[Sequence[str]] = None,
    clips_per_class: int = 6,
    exemplar_clips: int = 2,
    n_frames: int = 16,
    seq_len: int = 8,
    way: int = 5,
    n_epochs: int = 25,
    n_task: int = 160,
    batch_size: int = 8,
    fsos_repeats: int = 5,
    z_range: Tuple[float, float] = (1.8, 2.4),
    smooth: bool = True,
    seed: int = 0,
    log: bool = True,
    device: str = "cuda",
) -> Dict:
    """The chain; returns the receipt (counts, the last epoch's training
    accuracies, the FSOS results at 0.5 and at the threshold calibrated on
    the training classes, and each stage's wall seconds). Rendering and
    extraction resume in ``workdir``; training and evaluation always run."""
    from isbfsar_tpu_torch.configs import ARConfig, HPEConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.tools.extract_dataset import extract_tree
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator
    from isbfsar_tpu_torch.train.fsos import (calibrate_os_threshold, evaluate_fsos,
                                              metrics_at_threshold, summarize)
    from isbfsar_tpu_torch.train.posestack import ACTION_TEST_CLASSES, ACTION_TRAIN_CLASSES
    from isbfsar_tpu_torch.train.trainer import Trainer

    train_classes = list(train_classes or ACTION_TRAIN_CLASSES)
    test_classes = list(test_classes or ACTION_TEST_CLASSES)
    t0 = time.time()

    def say(msg):
        if log:
            print(f"[synth_workflow] {msg}", flush=True)

    fp = workflow_fingerprint(
        pose_params, frame_hw=tuple(frame_hw), intrinsics=repr(intrinsics),
        yolo_width=yolo_width, yolo_input_size=yolo_input_size, crop_size=crop_size,
        stages=repr(backbone_stages), train_classes=tuple(train_classes),
        test_classes=tuple(test_classes), clips_per_class=clips_per_class,
        exemplar_clips=exemplar_clips, n_frames=n_frames, z_range=tuple(z_range), seed=seed,
        **({"smooth": True} if smooth else {}))
    if workdir is None:
        workdir = os.path.join("runs", f"synthwf_{fp}")
        say(f"workdir (fingerprint-keyed): {workdir}")
    os.makedirs(workdir, exist_ok=True)
    _check_manifest(workdir, fp)

    # 1. the clip libraries: train, test queries, test exemplars
    vids = {"train": os.path.join(workdir, "videos_train"),
            "test_q": os.path.join(workdir, "videos_test_queries"),
            "test_ex": os.path.join(workdir, "videos_test_exemplars")}
    render_video_library(vids["train"], train_classes, clips_per_class, n_frames, frame_hw,
                         intrinsics, seed=seed, z_range=z_range)
    render_video_library(vids["test_q"], test_classes, clips_per_class, n_frames, frame_hw,
                         intrinsics, seed=seed + 1, z_range=z_range)
    render_video_library(vids["test_ex"], test_classes, exemplar_clips, n_frames, frame_hw,
                         intrinsics, seed=seed + 2, z_range=z_range)
    t_render = time.time()
    say(f"rendered {len(train_classes)}+{len(test_classes)} classes in {t_render - t0:.0f}s")

    # 2. skeleton trees from the trained stack at the 0.3 gate, 122 joints
    estimator = HumanPoseEstimator(
        HPEConfig(yolo_input_size=yolo_input_size, crop_size=crop_size, yolo_thresh=0.3,
                  skeleton=None),
        intrinsics, params=pose_params, backbone_stages=backbone_stages or V2_TINY,
        frame_shape=frame_hw, yolo_width=yolo_width, device=device)
    trees = {k: os.path.join(workdir, f"tree_{k}") for k in vids}
    n_skipped = 0
    for k in vids:
        extract_tree(estimator, vids[k], trees[k], n_frames=n_frames, smooth=smooth)
        for cls in os.listdir(trees[k]):
            n_skipped += sum(e.startswith(".skip_") for e in os.listdir(os.path.join(trees[k], cls)))
    t_extract = time.time()
    say(f"extracted trees in {t_extract - t_render:.0f}s ({n_skipped} clips skipped by the 0.3 "
        f"gate)")

    # 3. episodic TRX training on the train-class tree
    cfg = dataclasses.replace(ARConfig.for_input("skeleton"), way=way, seq_len=seq_len,
                              batch_size=batch_size, n_task=n_task, n_epochs=n_epochs,
                              eval_every_n_epoch=10_000)
    trainer = Trainer(cfg, log_dir=os.path.join(workdir, "run"), use_wandb=False, device=device)
    last = {}
    for epoch in range(n_epochs):
        sampler = EpisodicSampler(trees["train"], k=way, n_task=n_task, max_l=n_frames,
                                  l=seq_len, seed=seed + 100 + epoch)
        last = trainer.run_epoch(epoch, batch_iterator(sampler, batch_size, shuffle=False,
                                                       drop_last=True), train=True)
        say(f"epoch {epoch}: fs_loss {last['train/fs_loss']:.3f} "
            f"fs_acc {last['train/fs_accuracy']:.2f} os_acc {last['train/os_accuracy']:.2f}")
    t_train = time.time()

    # 4. FSOS on the held-out classes; the open-set threshold is calibrated
    # on the train tree and reported beside the 0.5 protocol, not instead
    params = trainer.params
    calib = calibrate_os_threshold(cfg, params, trees["train"], k=way, n_repeats=fsos_repeats,
                                   batch_size=batch_size, seed=seed, device=device)
    say(f"os-threshold calibration (train classes): {json.dumps(calib)}")
    results = evaluate_fsos(cfg, params, trees["test_q"], trees["test_ex"], k=way,
                            n_repeats=fsos_repeats, batch_size=batch_size, seed=seed,
                            collect_raw=True, device=device)
    results_cal = metrics_at_threshold(results["_raw"], calib["os_threshold"])
    t_eval = time.time()

    receipt = {
        "train_classes": len(train_classes),
        "test_classes": len(test_classes),
        "clips_per_class": clips_per_class,
        "exemplar_clips": exemplar_clips,
        "fingerprint": fp,
        "skipped_clips": n_skipped,
        "smooth": smooth,
        "way": way,
        "seq_len": seq_len,
        "epochs": n_epochs,
        "train_fs_acc": round(last.get("train/fs_accuracy", -1.0), 3),
        "train_os_acc": round(last.get("train/os_accuracy", -1.0), 3),
        "fsos": {k: round(float(np.mean(v)), 3) for k, v in results.items()
                 if not k.startswith("_")},
        "fsos_std": {k: round(float(np.std(v)), 3) for k, v in results.items()
                     if not k.startswith("_")},
        "os_calibration": calib,
        "fsos_calibrated": {k: round(float(np.mean(v)), 3) for k, v in results_cal.items()},
        "wall_s": {
            "render": round(t_render - t0, 1),
            "extract": round(t_extract - t_render, 1),
            "train": round(t_train - t_extract, 1),
            "fsos_eval": round(t_eval - t_train, 1),
        },
    }
    say("summary " + json.dumps(summarize(results)))
    say(f"summary@calibrated-os({calib['os_threshold']}) " + json.dumps(summarize(results_cal)))
    return receipt


def main(argv=None) -> int:
    from isbfsar_tpu_torch import weights
    from isbfsar_tpu_torch.configs import CameraIntrinsics

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", default=None,
                        help="artifact dir (renders and trees resume in it; a manifest refuses "
                             "a resume under a changed config). Default: runs/synthwf_<digest>")
    parser.add_argument("--production", action="store_true",
                        help="the full pose stack on 480x640 frames (needs the pose-prod-256 base)")
    parser.add_argument("--pose-params", default=None, help="trained pose-stack .msgpack; "
                        "default: the pose-diverse-256 bundle (CI) or pose-prod-256 with its "
                        "calibration delta (--production)")
    parser.add_argument("--crop-size", type=int, default=None,
                        help="pose crop; must match the crop the pose params were trained at "
                             "(default 256)")
    parser.add_argument("--clips", type=int, default=6)
    parser.add_argument("--n-frames", type=int, default=16)
    parser.add_argument("--seq-len", type=int, default=8)
    parser.add_argument("--way", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=25)
    parser.add_argument("--n-task", type=int, default=160)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--smooth", action=argparse.BooleanOptionalAction, default=True,
                        help="offline One-Euro smoothing of the extracted poses (default on)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("synth_workflow: no CUDA device (pass --device cpu)", file=sys.stderr)
            return 2

    if args.production:
        from isbfsar_tpu_torch.models.effnetv2 import V2_L
        from isbfsar_tpu_torch.train.posestack import (ACTION_EXTRA_CLASSES,
                                                       ACTION_TRAIN_CLASSES)

        kw = dict(frame_hw=(480, 640), intrinsics=CameraIntrinsics(), yolo_width=1.0,
                  yolo_input_size=256, crop_size=256, backbone_stages=V2_L,
                  train_classes=ACTION_TRAIN_CLASSES + ACTION_EXTRA_CLASSES)
    else:
        from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS

        kw = dict(frame_hw=CI_FRAME_HW, intrinsics=CI_INTRINSICS, yolo_width=0.25,
                  yolo_input_size=128, crop_size=256)
    if args.crop_size:
        kw["crop_size"] = args.crop_size

    if args.pose_params:
        with open(args.pose_params, "rb") as f:
            pose_params = weights.msgpack_restore(f.read())
    elif args.production:
        base = weights.bundle_path("pose-prod-256")
        if not os.path.exists(base):
            print(f"synth_workflow: --production needs the pose-prod-256 base ({base}), which is "
                  f"not present; pass --pose-params or run at CI size", file=sys.stderr)
            return 2
        pose_params = weights.load_calibrated("pose-prod-256")
    else:
        pose_params = weights.load_bundle("pose-diverse-256")

    receipt = run_workflow(
        pose_params, args.workdir, clips_per_class=args.clips, n_frames=args.n_frames,
        seq_len=args.seq_len, way=args.way, n_epochs=args.epochs, n_task=args.n_task,
        batch_size=args.batch, fsos_repeats=args.repeats, smooth=args.smooth, seed=args.seed,
        device=args.device, **kw)
    print("[synth_workflow:receipt] " + json.dumps(receipt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
