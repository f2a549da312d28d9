"""The demo filmstrip: the trained pipeline doing its job (port of
``tools/demo_tracking.py``).

Two rendered humanoid action clips are tracked by the bundled
``pose-ci-motions`` pose stack at the reference's 0.3 confidence gate,
after the fused pipeline (``with_focus=False``) LEARNED both actions from
separately rendered clips through the live acquisition (reference
main.py:243-319). Each clip's strip shows the predicted bbox (red), the
projected 30-joint skeleton (green bones) and the metric distance, and is
captioned with the live recognition's majority vote.

    python -m isbfsar_tpu_torch.tools.demo_tracking [--device cpu] \\
        [--out runs/demo_tracking.png] [--gui-out runs/demo_gui.png]

The work splits in two. :func:`build_demo`, :func:`learn` and :func:`track`
run the pipeline on ``device`` (the card by default; I420 frames, so each
step launches the fused I420 kernel) and return numpy results.
:func:`render_filmstrip` and :func:`render_gui` draw them on the host with
cv2 (``putText``'s fonts and ``LINE_AA`` have no numpy twin in
``utils/draw.py``) and, for the GUI panel, matplotlib; the card machine
has neither, so there they raise ``ImportError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

N_STRIP = 6  # frames shown per clip
SCALE = 2  # upscale factor for readability (CI frames are 320x240)
LEARN = (("wave", 0.0), ("squat", 0.0))  # (motion, phase), rendered with seed 11
RECOGNIZE = (("wave", 0.9, 21), ("squat", 0.4, 22))  # (motion, phase, seed)


def build_demo(device="cuda", input_format: str = "i420", ar_params=None,
               dtype: str = "bfloat16"):
    """The CI pose stack (pose-ci-motions: V2_TINY, YOLO width 0.25 at 128,
    crop 128, 240x320, gate 0.3) and a recognizer (random from seed 0, or
    the Flax variables ``ar_params``) in a started ``FusedPipeline`` without
    focus. ``dtype`` is the pose stack's compute type and the fused trunks'
    storage type (bf16 for both, as in JAX's demo)."""
    from isbfsar_tpu_torch import weights
    from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
    from isbfsar_tpu_torch.configs import ARConfig, HPEConfig, MainConfig, PipelineConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.pipeline import FusedPipeline
    from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS

    hw, intr = CI_FRAME_HW, CI_INTRINSICS
    hpe_cfg = HPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.3,
                        compute_dtype=dtype)
    hpe = HumanPoseEstimator(hpe_cfg, intr, params=weights.load_bundle("pose-ci-motions"),
                             backbone_stages=V2_TINY, frame_shape=hw, yolo_width=0.25,
                             device=device)
    ar_cfg = ARConfig.for_input("skeleton")
    ar = ActionRecognizer(ar_cfg, params=ar_params, device=device)
    cfg = PipelineConfig(
        main=dataclasses.replace(MainConfig.for_input("skeleton"),
                                 cam_width=hw[1], cam_height=hw[0]),
        intrinsics=intr, hpe=hpe_cfg, ar=ar_cfg, param_dtype=dtype,
    )
    pipe = FusedPipeline(cfg, hpe=hpe, ar=ar, with_focus=False, input_format=input_format,
                         device=device)
    pipe.start()
    return pipe


def _frame_in(pipe, frame: np.ndarray) -> np.ndarray:
    from isbfsar_tpu_torch.ops.image import bgr_to_i420

    return bgr_to_i420(frame) if pipe.input_format == "i420" else frame


def _clip(pipe, motion: str, n_frames: int, phase: float, seed: int) -> list:
    from isbfsar_tpu_torch.train.posestack import render_motion_clip

    frames, _ = render_motion_clip(motion, n_frames=n_frames, frame_hw=pipe.hpe.frame_shape,
                                   intrinsics=pipe.config.intrinsics, seed=seed, phase=phase)
    return frames


def learn(pipe, verbose: bool = True) -> None:
    """Teach the recognizer each of LEARN from a rendered clip: the first
    seq_len frames with a pose become the class's support clip."""
    L = pipe.config.ar.seq_len
    for motion, phase in LEARN:
        if verbose:
            print(f"[demo] learning {motion!r} from a rendered clip...")
        poses = []
        for f in _clip(pipe, motion, 2 * L, phase, 11):
            out = pipe.step(_frame_in(pipe, f))
            if out["pose_ok"] > 0:
                poses.append(out["pose"].reshape(-1))
        if len(poses) < L:
            raise RuntimeError(f"tracker lost the {motion} clip")
        pipe.ar.train({"flag": motion, "data": {"poses": np.stack(poses[:L]).astype(np.float32)},
                       "requires_focus": False})
    pipe.start()  # refresh support K/V


@torch.inference_mode()
def estimate_frame(hpe, frame: np.ndarray):
    """The estimator's (pose, bbox, conf, found, visible) of one BGR frame,
    as numpy: what the filmstrip draws."""
    from isbfsar_tpu_torch.utils.transfer import to_device

    outs = hpe._estimate_impl(hpe.nets, to_device(frame, hpe.device)[None])
    return tuple(o[0].float().cpu().numpy() for o in outs)


def track(pipe, n_strip: int = N_STRIP, verbose: bool = True) -> List[Dict]:
    """Recognize fresh clips of each RECOGNIZE motion on a fresh stream.
    Per clip: the recognized label of every frame (the best action, None
    before the window fills), the majority ``pred`` and its share
    ``score``, and the ``cells`` the strip shows, (frame, estimate)."""
    L = pipe.config.ar.seq_len
    clips = []
    for motion, phase, seed in RECOGNIZE:
        frames = _clip(pipe, motion, 2 * L + 4, phase, seed)
        pipe._assign(_state=pipe.init_state())
        labels, cells = [], []
        keep = set(np.linspace(4, len(frames) - 1, n_strip).astype(int))
        for i, f in enumerate(frames):
            actions = pipe.decode(pipe.step(_frame_in(pipe, f))).get("actions")
            labels.append(max(actions, key=actions.get) if actions else None)
            if i in keep:
                cells.append((f, estimate_frame(pipe.hpe, f)))
        votes = [v for v in labels if v is not None]
        pred = max(set(votes), key=votes.count) if votes else "(none)"
        score = votes.count(pred) / max(len(votes), 1)
        if verbose:
            print(f"[demo] {motion}: recognized {pred} ({len(votes)} votes)")
        clips.append({"motion": motion, "labels": labels, "pred": pred, "score": score,
                      "votes": len(votes), "cells": cells})
    return clips


def project(points_m: np.ndarray, k: np.ndarray) -> np.ndarray:
    """(N, 3) camera-space meters -> (N, 2) pixel coords."""
    z = np.maximum(points_m[:, 2:3], 1e-6)
    uv = points_m[:, :2] / z
    return uv * np.asarray([k[0, 0], k[1, 1]]) + np.asarray([k[0, 2], k[1, 2]])


def annotate(frame, est_out, k, edges, scale=SCALE):
    """Upscale + draw prediction overlays on one BGR frame."""
    import cv2

    from isbfsar_tpu_torch.train.posestack import BOX_SIZE_M

    img = cv2.resize(frame, (frame.shape[1] * scale, frame.shape[0] * scale),
                     interpolation=cv2.INTER_NEAREST)
    pose, bbox, conf, found, visible = est_out
    if not (bool(found) and bool(visible)):
        cv2.putText(img, "no detection", (8, 22), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (0, 0, 255), 1, cv2.LINE_AA)
        return img
    x1, x2, y1, y2 = (np.asarray(bbox, float) * scale).astype(int)
    cv2.rectangle(img, (x1, y1), (x2, y2), (0, 0, 255), 1)
    pose_m = np.asarray(pose, float) * BOX_SIZE_M
    uv = (project(pose_m, k) * scale).astype(int)
    for a, b in edges:
        cv2.line(img, tuple(uv[a]), tuple(uv[b]), (0, 200, 0), 1, cv2.LINE_AA)
    for u, v in uv:
        cv2.circle(img, (int(u), int(v)), 2, (0, 255, 255), -1)
    dist = float(np.linalg.norm(pose_m[0]))
    cv2.putText(img, f"conf {float(conf):.2f}  z {dist:.2f} m", (8, 22),
                cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1,
                cv2.LINE_AA)
    return img


def caption_bar(width: int, text: str):
    import cv2

    bar = np.full((30, width, 3), 32, np.uint8)
    cv2.putText(bar, text, (8, 21), cv2.FONT_HERSHEY_SIMPLEX, 0.55,
                (80, 255, 80), 1, cv2.LINE_AA)
    return bar


def render_filmstrip(pipe, clips: List[Dict]) -> np.ndarray:
    """The BGR panel: one captioned strip of annotated frames per clip."""
    from isbfsar_tpu_torch.utils.skeleton import get_skeleton

    k = pipe.config.intrinsics.matrix()
    edges = get_skeleton("smpl+head_30").edges
    strips = []
    for clip in clips:
        strip = np.concatenate([annotate(f, est, k, edges) for f, est in clip["cells"]], axis=1)
        bar = caption_bar(strip.shape[1],
                          f"clip: {clip['motion']}   recognized: {clip['pred']} "
                          f"({clip['score']:.0%} of fired frames)   "
                          f"yolo_thresh=0.3, bundled pretrained weights")
        strips.append(np.concatenate([bar, strip], axis=0))
    return np.concatenate(strips, axis=0)


def gui_elements(pipe) -> Dict:
    """The service surface's view: a fresh wave clip through the live
    ``Orchestrator`` (double-buffered fused path); the last frame's elements."""
    from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator

    orch = Orchestrator(config=pipe.config, ar=pipe.ar, fused=pipe)
    pipe._assign(_state=pipe.init_state())
    elements: Dict = {}
    for i, f in enumerate(_clip(pipe, "wave", pipe.config.ar.seq_len + 6, 0.5, 33)):
        log = "Action wave learned successfully!" if i == 0 else None
        elements = orch.get_frame(img=f, log=log)
    return elements


def render_gui(elements: Dict) -> np.ndarray:
    """The interactive 2x2 panel rendered offscreen (Agg): (h, w, 3) RGB."""
    from isbfsar_tpu_torch.runtime.visualizer import GUIVisualizer

    return GUIVisualizer(backend="Agg").render(elements)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join("runs", "demo_tracking.png"))
    parser.add_argument("--device", default="cuda",
                        help="torch device to track on (default cuda; no fallback to the CPU)")
    parser.add_argument("--gui-out", default=None,
                        help="also render one recognizing frame through the live Orchestrator "
                             "+ GUIVisualizer 2x2 panel (offscreen) to this path")
    args = parser.parse_args(argv)

    import cv2

    pipe = build_demo(args.device)
    learn(pipe)
    panel = render_filmstrip(pipe, track(pipe))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cv2.imwrite(args.out, panel)
    print(f"[demo] wrote {args.out} ({panel.shape[1]}x{panel.shape[0]})")
    if args.gui_out:
        img = render_gui(gui_elements(pipe))
        os.makedirs(os.path.dirname(os.path.abspath(args.gui_out)), exist_ok=True)
        cv2.imwrite(args.gui_out, img[..., ::-1])  # RGB -> BGR for imwrite
        print(f"[demo] wrote {args.gui_out} ({img.shape[1]}x{img.shape[0]})")


if __name__ == "__main__":
    main()
