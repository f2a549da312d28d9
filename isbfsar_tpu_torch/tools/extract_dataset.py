"""Dataset extraction: run the pose estimator over action clips to emit
training clips (twin of ``tools/extract_dataset.py``).

Per input clip: pick ``n_frames`` uniformly, estimate each picked frame's
pose, keep it root-relative, reuse the previous good pose when a frame
fails, pad the tail with the last pose, and optionally smooth the sequence
with the offline One-Euro filter. A clip is a sequence of BGR frames: a
directory of PNG frames (``0.png``, ``1.png``, ...) or one ``.npy`` stack
(T, H, W, 3) uint8, since the card machine has no cv2 to read a video.

Output tree: ``out_root/<class>/<clip_idx>/{i}.npy`` (+ ``{i}.png`` 224x224
crops with ``--with-images``), the layout ``train/dataloader.py`` reads.
Resumable: each processed clip leaves a clip dir named by its index, or a
``.skip_<idx>`` marker when no frame had a usable pose; a clip dir counts
only when its last ``.npy`` (and, with images, its last ``.png``) exists,
and stray entries are ignored.

    python -m isbfsar_tpu_torch.tools.extract_dataset --frames ROOT --out TREE \
        [--n-frames 16] [--with-images] [--checkpoint POSE.msgpack] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from isbfsar_tpu_torch.ops.image import resize_linear_u8
from isbfsar_tpu_torch.ops.smooth import one_euro
from isbfsar_tpu_torch.utils.png import read_png, write_png

CROP_SIZE = 224


def load_clip_frames(path: str) -> List[np.ndarray]:
    """A clip's BGR frames: a ``.npy`` stack, or a directory of PNG frames
    in the order of their integer names."""
    if path.endswith(".npy"):
        return list(np.load(path))
    names = sorted((n for n in os.listdir(path) if n.endswith(".png") and n[:-4].isdigit()),
                   key=lambda n: int(n[:-4]))
    return [read_png(os.path.join(path, n)) for n in names]


def extract_clip(estimator, frames: Sequence[np.ndarray], n_frames: int, with_images: bool,
                 smooth: bool = False) -> Optional[Tuple[list, list]]:
    """(poses, crops): ``n_frames`` root-relative poses (J, 3) and, with
    images, 224x224 BGR crops around the person; None when the clip is
    empty or its first picked frame has no usable pose."""
    total = len(frames)
    if total <= 0:
        return None
    picks = set(np.linspace(0, total - 1, n_frames).astype(int).tolist())
    poses, crops = [], []
    last_pose, last_crop = None, None
    for i, frame in enumerate(frames):
        if i not in picks:
            continue
        res = estimator.estimate(frame)
        if res is not None:
            last_pose = res["pose"] - res["pose"][0]
            if with_images:
                x1, x2, y1, y2 = res["bbox"]
                xm, ym = (x1 + x2) // 2, (y1 + y2) // 2
                half = max(xm - x1, ym - y1, 1)
                crop = frame[max(ym - half, 0): ym + half, max(xm - half, 0): xm + half]
                last_crop = resize_linear_u8(crop, CROP_SIZE, CROP_SIZE)
        # a frame without a pose reuses the last good one
        if last_pose is None:
            return None
        poses.append(last_pose)
        if with_images:
            crops.append(last_crop)
    if len(poses) < n_frames:
        poses += [poses[-1]] * (n_frames - len(poses))
        if with_images:
            crops += [crops[-1]] * (n_frames - len(crops))
    if smooth:
        poses = list(one_euro(np.stack(poses)))
    return poses, crops


def _done(out_class: str, n_frames: int, with_images: bool) -> set:
    """The clip indices of a class already processed: ``.skip_<idx>``
    markers and clip dirs whose last frame (npy, and png with images) exists."""
    done = set()
    for entry in os.listdir(out_class):
        if entry.startswith(".skip_") and entry[6:].isdigit():
            done.add(int(entry[6:]))
        elif entry.isdigit():
            last = os.path.join(out_class, entry, f"{n_frames - 1}")
            if os.path.exists(last + ".npy") and (not with_images or os.path.exists(last + ".png")):
                done.add(int(entry))
    return done


def extract_tree(estimator, frames_root: str, out_root: str, n_frames: int = 16,
                 with_images: bool = False, smooth: bool = False) -> List[str]:
    """Walk ``frames_root/<class>/<clip>`` and write the training tree;
    returns the clip dirs written by this call."""
    written = []
    for class_name in sorted(os.listdir(frames_root)):
        class_dir = os.path.join(frames_root, class_name)
        if not os.path.isdir(class_dir):
            continue
        out_class = os.path.join(out_root, class_name)
        os.makedirs(out_class, exist_ok=True)
        done = _done(out_class, n_frames, with_images)
        for idx, clip in enumerate(sorted(os.listdir(class_dir))):
            if idx in done:
                continue
            result = extract_clip(estimator, load_clip_frames(os.path.join(class_dir, clip)),
                                  n_frames, with_images, smooth=smooth)
            if result is None:
                print(f"[extract] SKIP {class_name}/{clip} (no usable pose)")
                open(os.path.join(out_class, f".skip_{idx}"), "w").close()
                continue
            poses, crops = result
            clip_dir = os.path.join(out_class, str(idx))
            os.makedirs(clip_dir, exist_ok=True)
            for i, pose in enumerate(poses):
                np.save(os.path.join(clip_dir, f"{i}.npy"), pose.astype(np.float32))
                if with_images:
                    write_png(os.path.join(clip_dir, f"{i}.png"), crops[i])
            print(f"[extract] {class_name}/{clip} -> {clip_dir}")
            written.append(clip_dir)
    return written


def main(argv=None) -> int:
    import dataclasses

    from isbfsar_tpu_torch import weights
    from isbfsar_tpu_torch.configs import CameraIntrinsics, HPEConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", required=True, help="root with <class>/<clip> frame clips")
    parser.add_argument("--out", required=True)
    parser.add_argument("--n-frames", type=int, default=16)
    parser.add_argument("--with-images", action="store_true")
    parser.add_argument("--smooth", action=argparse.BooleanOptionalAction, default=True,
                        help="offline One-Euro smoothing of each clip's poses (default on)")
    parser.add_argument("--checkpoint", default=None, help="pose-stack params msgpack")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("extract_dataset: no CUDA device (pass --device cpu)", file=sys.stderr)
            return 2
    params = None
    if args.checkpoint:
        with open(args.checkpoint, "rb") as f:
            params = weights.msgpack_restore(f.read())
    # skeleton=None: the tree stores the full (122, 3) pose; the loader
    # selects the 30-joint skeleton
    estimator = HumanPoseEstimator(dataclasses.replace(HPEConfig(), skeleton=None),
                                   CameraIntrinsics(), params=params, device=args.device)
    extract_tree(estimator, args.frames, args.out, args.n_frames, args.with_images,
                 smooth=args.smooth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
