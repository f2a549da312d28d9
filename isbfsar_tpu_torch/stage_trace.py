"""Where the batched step departs from the per-frame step on one GPU.

    python3 -m isbfsar_tpu_torch.stage_trace [--batch 8] [--cudnn-deterministic]

The trained CI stack (``profile_slice.build_ci``: pose-ci-motions and
focus-ci, float32, 240x320) runs the same ``--batch`` frames (smoke and
face frames) eagerly once as one batch and once frame by frame. Stage by
stage (fused input, raw YOLO outputs, box, homography, crop, trunk
features, head logits, 2D decode, absolute 3D, pose, the skeleton
embedding, then the focus stages: the face detector's input and scores,
the face box, the landmark crop and landmarks, the head pose, the gaze
warp, crop and pitch/yaw, and last the TRX logits), it prints the largest
absolute difference between the two and names the first stage that
differs. The last line is a JSON object of the same readings.
``--cudnn-deterministic`` sets ``torch.backends.cudnn.deterministic``
first, to see whether cuDNN's deterministic algorithms remove the
difference. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from isbfsar_tpu_torch.profile_slice import build_ci, ci_frames


@torch.inference_mode()
def trace(pipe, frames: np.ndarray) -> dict:
    """One batch of frames -> {stage: tensor with a leading batch axis}."""
    bgr, yolo_in = pipe._decode_frame(torch.from_numpy(frames).to(pipe.device))
    nets = pipe._params()
    stages = {"bgr": bgr}
    pose = pipe.hpe._estimate_impl(nets["hpe"], bgr, yolo_in, stages)[0]
    rel = pose - pose[:, :1]
    stages["features"] = nets["ar"].embed_frame(rel.reshape(rel.shape[0], -1))
    if pipe.with_focus:
        pipe.focus._forward_impl(nets["focus"], bgr, stages)
    return stages


@torch.inference_mode()
def trx_logits(pipe, windows: torch.Tensor) -> torch.Tensor:
    """(b, L, D) feature windows -> (b, way) TRX logits against the support set."""
    s_k, s_v = pipe._support_kv
    b = windows.shape[0]
    return pipe._params()["ar"].match_features(
        windows, pipe._support_mask.expand(b, -1), s_k.expand(b, *s_k.shape),
        s_v.expand(b, *s_v.shape))["logits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cudnn-deterministic", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_trace: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.deterministic = args.cudnn_deterministic
    pipe = build_ci("cuda", cuda_graphs=False)
    frames = np.stack(ci_frames(args.batch, faces=True))
    batched = trace(pipe, frames)
    single = [trace(pipe, frames[i:i + 1]) for i in range(args.batch)]
    one = {key: torch.cat([s[key] for s in single]) for key in batched}
    # windows of the batched features, one per frame, each rolled by its index
    feats = batched["features"]
    ring = feats[torch.arange(pipe.config.ar.seq_len, device=feats.device) % feats.shape[0]]
    windows = torch.stack([ring.roll(i, 0) for i in range(args.batch)])
    batched["trx_logits"] = trx_logits(pipe, windows)
    one["trx_logits"] = torch.cat([trx_logits(pipe, windows[i:i + 1]) for i in range(args.batch)])
    diffs = {}
    for key, value in batched.items():
        d = (value.double() - one[key].double()).abs()
        diffs[key] = float(d.max()) if d.numel() else 0.0
        print(f"[stage] {key:11s} max|B={args.batch} - B=1| {diffs[key]:.3g} "
              f"(max|value| {float(value.double().abs().max()):.3g})", flush=True)
    first = next((k for k, v in diffs.items() if v > 0), None)
    print(f"[stage] first stage that differs: {first}; {torch.cuda.get_device_name(0)}")
    print(json.dumps({"batch": args.batch, "cudnn_deterministic": args.cudnn_deterministic,
                      "first": first, "max_abs_diff": diffs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
