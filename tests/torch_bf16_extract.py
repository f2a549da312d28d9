"""The readings behind the bf16 extraction limit of
``tests/test_torch_synth_workflow.py``: the workflow's estimator
(``EXTRACT_KW`` there, in bf16) in the port and in the JAX package on the
CPU, over the workflow's CI clip library (``render_video_library`` of the
train and query classes, 2 clips a class of 16 frames, seeds 0 and 1).

For each frame JAX's bf16 finds a person on, it prints the largest joint
difference of

- JAX bf16 and the port's bf16 against JAX float32 (what bf16 costs each);
- the port's bf16 against JAX's bf16, with the port's own box and with
  JAX's bf16 box handed to the port's crop (what the box accounts for).

Run: ``JAX_PLATFORMS=cpu python -m tests.torch_bf16_extract`` (about a
minute on 8 threads; the clips go to a temporary directory).
"""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.train.posestack import CI_INTRINSICS as JAX_CI_INTRINSICS
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.tools.extract_dataset import load_clip_frames
from isbfsar_tpu_torch.tools.synth_workflow import render_video_library
from isbfsar_tpu_torch.train.posestack import (ACTION_TEST_CLASSES, ACTION_TRAIN_CLASSES,
                                               CI_FRAME_HW, CI_INTRINSICS)

KW = dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.3, skeleton=None)


def clip_library(root: str) -> dict:
    clips = {}
    for tag, classes, seed in (("train", ACTION_TRAIN_CLASSES, 0),
                               ("test_q", ACTION_TEST_CLASSES, 1)):
        render_video_library(os.path.join(root, tag), classes, 2, 16, CI_FRAME_HW, CI_INTRINSICS,
                             seed=seed)
        for cls in sorted(os.listdir(os.path.join(root, tag))):
            for k in sorted(os.listdir(os.path.join(root, tag, cls))):
                clips[(tag, cls, k)] = load_clip_frames(os.path.join(root, tag, cls, k))
    return clips


def main() -> None:
    torch.set_num_threads(8)
    params = pretrained.load("pose-diverse-256")
    jax_est = {dtype: JaxEstimator(jc.HPEConfig(**KW, compute_dtype=dtype), JAX_CI_INTRINSICS,
                                   params=params, backbone_stages=JAX_V2_TINY,
                                   frame_shape=CI_FRAME_HW, yolo_width=0.25)
               for dtype in ("float32", "bfloat16")}
    ours = HumanPoseEstimator(tc.HPEConfig(**KW, compute_dtype="bfloat16"), CI_INTRINSICS,
                              params=params, backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW,
                              yolo_width=0.25, device="cpu")
    detect = ours._detect
    rows = []
    with tempfile.TemporaryDirectory() as root:
        clips = clip_library(root)
    for key, frames in clips.items():
        run = lambda est, f: [np.asarray(v) for v in est._estimate_jit(est.params, jnp.asarray(f))]
        ref32 = [run(jax_est["float32"], f) for f in frames]
        ref16 = [run(jax_est["bfloat16"], f) for f in frames]
        jax_box = torch.from_numpy(np.stack([r[1] for r in ref16]).astype(np.int32))

        def given_box(nets, frames, yolo_in=None, stages=None):
            _, conf, found = detect(nets, frames, yolo_in, stages)
            return (jax_box[:, 0], jax_box[:, 2], jax_box[:, 1], jax_box[:, 3]), conf, found

        batch = torch.from_numpy(np.stack(frames).astype(np.float32))
        with torch.no_grad():
            pose, bbox = [t.numpy() for t in ours._estimate_impl(ours.nets, batch)[:2]]
            ours._detect = given_box
            forced = ours._estimate_impl(ours.nets, batch)[0].numpy()
            ours._detect = detect
        for i, (r32, r16) in enumerate(zip(ref32, ref16)):
            if not r16[3]:
                continue
            rows.append((key, i, np.abs(r16[0] - r32[0]).max(), np.abs(pose[i] - r32[0]).max(),
                         np.abs(pose[i] - r16[0]).max(), np.abs(forced[i] - r16[0]).max(),
                         np.array_equal(bbox[i], r16[1])))
    jax_err, port_err, apart, apart_forced, same_box = (np.array(c) for c in list(zip(*rows))[2:])
    print(f"{len(rows)} frames with a person in {len(clips)} clips")
    print(f"bf16 against JAX float32: JAX largest {jax_err.max():.4g} m, mean {jax_err.mean():.4g}; "
          f"port largest {port_err.max():.4g} m ({port_err.max() / jax_err.max():.3f} of JAX's), "
          f"mean {port_err.mean():.4g} ({port_err.mean() / jax_err.mean():.3f} of JAX's)")
    print(f"port bf16 against JAX bf16: largest {apart.max():.4g} m, median "
          f"{np.median(apart):.4g}; the box equal on {int(same_box.sum())} frames (largest "
          f"{apart[same_box].max():.4g} m there); with JAX's box given to the port: largest "
          f"{apart_forced.max():.4g} m")
    worst = max(rows, key=lambda r: r[4])
    print(f"largest: {worst[0]} frame {worst[1]}: {worst[4]:.4g} m with the port's box, "
          f"{worst[5]:.4g} m with JAX's")


if __name__ == "__main__":
    main()
