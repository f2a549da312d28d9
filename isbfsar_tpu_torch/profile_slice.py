"""The full-width slice and the trained CI stack on one GPU, and where the time goes.

    python3 -m isbfsar_tpu_torch.profile_slice [--steps 5] [--trace PATH]
    python3 -m isbfsar_tpu_torch.profile_slice --trainers [--steps 2]

``build_slice`` is the slice that ``chip_smoke.py`` drives and this module
profiles: 640x480 I420, YOLOv4 @ 256, EfficientNetV2-L @ 256 crop, bf16,
the 0.3 detector gate, two random support actions, and with focus on
(``FocusConfig()``: gaze crop 224, bf16) the trained ``focus-ci`` nets.
Its detector is the calibrated production one (the ``pose-prod-256-calib``
bundle entry, which holds the YOLO branch alone); EfficientNetV2-L and the
MeTRAbs head are random from a seed, because the 351 MB ``pose-prod-256``
base does not fit the card machine's copy of the repo. A missing bundle
file raises. ``input_type`` picks the mode (``PipelineConfig.for_input``):
rgb runs the detector alone (``just_box``) and the ResNet-50 RGB extractor
at 224 in float32, hybrid the whole pose stack and the ResNet-50; the
bundle holds no rgb recognizer, so the ResNet-50 is random from the seed.
``build_ci`` is the trained CI operating point (``pose-ci-motions``, and
``focus-ci`` at ``CI_FOCUS_CFG`` with focus on) at 240x320 in float32
(rgb and hybrid: the ResNet-50 at a 64 crop), and ``ci_frames`` the smoke
frames at its size, with the committed face frames when asked.

Run as a script, it warms the slice up on the smoke and face frames, then
profiles ``FusedPipeline.step`` over ``--steps`` frames and one
``stream_batched`` batch of 16 with ``torch.profiler``, with CUDA graphs
and eagerly, with focus on and then off, then the graph step in rgb and
hybrid. For each window it prints the host wall time per frame, the device
kernel time per frame, the device busy share (kernel time over wall time),
the kernel launches per frame and the kernels that take the most device
time; for rgb and hybrid also the device ms per frame of the crop with its
whitening and of the ResNet-50, each a CUDA graph of its own, at B=1 and
B=16. With ``--trainers`` it profiles the synthetic pose trainers instead,
at the production sizes of ``tools/train_posestack.py --production``
(batch 8 on 480x640 frames): ``--steps`` warmed-up train steps of
``YoloTrainer`` (width 1.0 at 256) and of ``HeatmapTrainer``
(EfficientNetV2-L, a 256 crop), each step's device time, kernels and top
kernels, beside the host sampler's time for a batch. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.configs import (ARConfig, CameraIntrinsics, FocusConfig, HPEConfig,
                                       MainConfig, PipelineConfig)
from isbfsar_tpu_torch.focus.detector import FocusDetector
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.kernel_bench import graph_ms
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.ops.image import (IMAGENET_SCALE, IMAGENET_SHIFT, ar_rgb_preprocess,
                                         bgr_to_i420, center_square_crop_resize, i420_to_bgr,
                                         resize_area)
from isbfsar_tpu_torch.pipeline import FusedPipeline

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
SMOKE_FRAMES = os.path.join(ASSETS, "smoke_frames.npz")
FOCUS_FRAMES = os.path.join(ASSETS, "focus_frames.npz")


def smoke_frames() -> list:
    """Four rendered 640x480 I420 frames of the ``wave`` clip (README.md
    says how they were made), on which the calibrated detector fires."""
    with np.load(SMOKE_FRAMES) as f:
        return list(f["i420"])


def focus_frames(height: int = 480) -> dict:
    """Five rendered faces (README.md says how they were made): close
    (area 0.12) and far (0.02), head yaw 0 and 1.0, and one close face
    looking off camera, as I420 frames at 480x640 (``height=480``) or at
    the CI stack's 240x320 (``height=240``), with their true landmarks in
    pixels. Returns {"i420": list, "landmarks": (5, 6, 2) float32}."""
    with np.load(FOCUS_FRAMES) as f:
        return {"i420": list(f[f"i420_{height}"]), "landmarks": f[f"landmarks_{height}"]}


def slice_frames() -> list:
    """The smoke frames and the 480x640 face frames, interleaved: the pose
    detector fires on the former, the face detector on the latter."""
    smoke, faces = smoke_frames(), focus_frames(480)["i420"]
    return [f for pair in zip(smoke, faces) for f in pair] + faces[len(smoke):]


def random_clip(ar_config: ARConfig, rng: np.random.Generator) -> dict:
    """One random support clip in the modalities of ``ar_config``'s input
    type: normal poses, and crops of uniform random pixels whitened as the
    pipeline whitens its crops."""
    seq, data = ar_config.seq_len, {}
    if ar_config.input_type in ("skeleton", "hybrid"):
        data["poses"] = rng.normal(size=(seq, 90)).astype(np.float32)
    if ar_config.input_type in ("rgb", "hybrid"):
        px = rng.integers(0, 256, (seq, ar_config.rgb_size, ar_config.rgb_size, 3))
        data["imgs"] = (px.astype(np.float32) / np.float32(255.0) * np.float32(IMAGENET_SCALE)
                        + np.float32(IMAGENET_SHIFT)).astype(np.float32)
    return data


def train_support(pipe: FusedPipeline, seed: int = 0) -> None:
    """Two random support actions, as bench.py trains them, then a fresh stream."""
    rng = np.random.default_rng(seed)
    for i in range(2):
        pipe.ar.train({"flag": f"action_{i}", "data": random_clip(pipe.config.ar, rng),
                       "requires_focus": False})
    pipe.start()


def build_slice(seed: int = 0, cuda_graphs: bool = True, with_focus: bool = True,
                input_type: str = "skeleton", hpe_overrides: Optional[dict] = None
                ) -> FusedPipeline:
    """The full-width slice on the card (see the module docstring);
    ``hpe_overrides`` replaces ``HPEConfig`` fields, e.g. ``{"num_aug": 5}``
    for test-time augmentation inside the graphed step."""
    config = PipelineConfig.for_input(input_type)
    config = dataclasses.replace(config, hpe=dataclasses.replace(config.hpe, **(hpe_overrides or {})))
    hpe = HumanPoseEstimator(config.hpe, config.intrinsics, seed=seed)
    delta = weights.load_bundle("pose-prod-256-calib")
    hpe.nets["yolo"].load_state_dict(weights.convert_variables(delta["yolo"]), strict=True)
    focus = FocusDetector(config.focus, config.intrinsics, params=weights.load_bundle("focus-ci")
                          ) if with_focus else None
    pipe = FusedPipeline(config, hpe=hpe, focus=focus, with_focus=with_focus,
                         cuda_graphs=cuda_graphs)
    train_support(pipe)
    return pipe


def twin(pipe: FusedPipeline, cuda_graphs: bool, with_focus=None) -> FusedPipeline:
    """A second pipeline on the same nets and support set, eager or with
    graphs, with focus as ``pipe`` has it unless ``with_focus`` says."""
    with_focus = pipe.with_focus if with_focus is None else with_focus
    other = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, focus=pipe.focus,
                          with_focus=with_focus, device=str(pipe.device), cuda_graphs=cuda_graphs)
    other.start()
    return other


CI_SHAPE = (240, 320)
CI_INTRINSICS = CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0, width=320, height=240)
# the focus nets' CI operating point: the same nets, a 64 crop, float32
CI_FOCUS_CFG = dataclasses.replace(FocusConfig(), gaze_image_size=64, compute_dtype="float32")
CI_RGB_SIZE = 64  # the recognizer's RGB crop at the CI operating point


def ci_frames(n: int = 18, faces: bool = False) -> list:
    """The smoke frames at the CI stack's 240x320, cycled to ``n``: decoded,
    INTER_AREA-halved (a 640x480 render at fx=384 is a 320x240 render at
    fx=192) and re-encoded. ``faces=True`` interleaves the 240x320 face
    frames with them before cycling."""
    out = []
    for yuv in smoke_frames():
        bgr = resize_area(i420_to_bgr(torch.from_numpy(yuv), 480), *CI_SHAPE)
        out.append(bgr_to_i420(torch.round(bgr).to(torch.uint8).numpy()))
    if faces:
        face = focus_frames(240)["i420"]
        out = [f for pair in zip(out, face) for f in pair] + face[len(out):]
    return [out[i % len(out)] for i in range(n)]


def build_ci(device: str = "cuda", cuda_graphs=None, params=None, with_focus: bool = True,
             focus_params=None, input_type: str = "skeleton",
             hpe_overrides: Optional[dict] = None) -> FusedPipeline:
    """The trained CI operating point (pose-ci-motions: V2_TINY, YOLO width
    0.25 at 128, crop 128, 240x320, float32, gate 0.3) with two random
    support actions; with focus, ``focus-ci`` at ``CI_FOCUS_CFG``. rgb and
    hybrid add the ResNet-50 at a 64 crop (``CI_RGB_SIZE``); rgb runs the
    detector alone. ``hpe_overrides`` replaces ``HPEConfig`` fields."""
    h, w = CI_SHAPE
    hcfg = HPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.3, compute_dtype="float32",
                     just_box=input_type == "rgb", **(hpe_overrides or {}))
    intr = CI_INTRINSICS
    main = dataclasses.replace(MainConfig.for_input(input_type), cam_width=w, cam_height=h)
    ar = ARConfig.for_input(input_type, rgb_size=CI_RGB_SIZE)
    cfg = PipelineConfig(main=main, intrinsics=intr, hpe=hcfg, ar=ar, focus=CI_FOCUS_CFG,
                         param_dtype="float32")
    hpe = HumanPoseEstimator(hcfg, intr, params=params or weights.load_bundle("pose-ci-motions"),
                             backbone_stages=V2_TINY, frame_shape=CI_SHAPE, yolo_width=0.25,
                             device=device)
    focus = FocusDetector(CI_FOCUS_CFG, intr, params=focus_params or weights.load_bundle("focus-ci"),
                          frame_shape=CI_SHAPE, device=device) if with_focus else None
    pipe = FusedPipeline(cfg, hpe=hpe, ar=ActionRecognizer(cfg.ar, seed=1, device=device),
                         focus=focus, with_focus=with_focus, device=device,
                         cuda_graphs=cuda_graphs)
    train_support(pipe)
    return pipe


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _report(name: str, prof, wall_s: float, n_frames: int, top: int = 12, unit: str = "frame"):
    """Prints the window's numbers and top kernels; returns (device ms per
    ``unit``, kernels per ``unit``)."""
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device time")
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    print(f"[{name}] wall {wall_s / n_frames * 1e3:.3f} ms/{unit}, device "
          f"{busy_us / n_frames / 1e3:.3f} ms/{unit}, busy share {busy_us / 1e6 / wall_s:.3f}, "
          f"{len(events) / n_frames:.0f} kernels/{unit}")
    for kname, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{name}]   {us / busy_us * 100:5.1f}%  {us / n_frames / 1e3:8.4f} ms/{unit}  "
              f"x{count / n_frames:.0f}  {kname[:110]}")
    return busy_us / n_frames / 1e3, len(events) / n_frames


def profile_steps(name: str, pipe: FusedPipeline, frames: list, steps: int, top: int = 12,
                  trace: str = ""):
    """``torch.profiler`` over ``steps`` synchronous steps of a warmed-up
    pipeline; returns (device ms per frame, kernels per frame)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for f in frames[:steps]:
            pipe.step(f)
        wall = time.perf_counter() - t
    if trace:
        prof.export_chrome_trace(trace)
    return _report(f"{name} step B=1", prof, wall, steps, top)


def _profile(name: str, pipe: FusedPipeline, frames: list, steps: int, trace: str = "") -> None:
    for f in frames[:3]:  # warm-up; with graphs, also the B=1 and B=16 captures
        pipe.step(f)
    list(pipe.stream_batched(frames, 16))
    profile_steps(name, pipe, frames, steps, trace=trace)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        list(pipe.stream_batched(frames, 16))
        wall = time.perf_counter() - t
    _report(f"{name} stream_batched B=16", prof, wall, 16)


def rgb_stage_ms(pipe: FusedPipeline, frames: list) -> dict:
    """Device ms per frame of the rgb feature's two stages on ``frames``'
    first detections, each a CUDA graph of its own, at B=1 and B=16: the
    crop with its whitening (``crop``) and the ResNet-50 RGB extractor with
    its projection (``resnet50``)."""
    size = pipe.config.ar.rgb_size
    extractor = pipe.ar.model.rgb_extractor
    out = {}
    with torch.inference_mode():
        for b in (1, 16):
            batch = torch.from_numpy(np.stack([frames[i % len(frames)] for i in range(b)])).cuda()
            decoded, yolo_in = pipe._decode_frame(batch)
            (x1, y1, x2, y2), _, _ = pipe.hpe._detect(pipe._params()["hpe"], decoded, yolo_in)
            crop = lambda: ar_rgb_preprocess(center_square_crop_resize(decoded, (x1, y1, x2, y2),
                                                                       size))
            crops = crop()
            out[f"crop B={b}"] = graph_ms(crop) / b
            out[f"resnet50 B={b}"] = graph_ms(lambda: extractor(crops), reps=4) / b
    return out


def profile_trainers(steps: int = 2, batch: int = 8) -> None:
    """``torch.profiler`` over ``steps`` warmed-up train steps of each
    full-width pose trainer, batch ``batch`` on 480x640 frames, with the
    host sampler's time per batch."""
    from isbfsar_tpu_torch.models.effnetv2 import V2_L
    from isbfsar_tpu_torch.train import posestack as ps

    hw, intr = ps.PROD_FRAME_HW, CameraIntrinsics()
    norm = np.asarray([hw[1], hw[0], hw[1], hw[0]], np.float32)
    for name, make_trainer, make_batch in (
            ("YoloTrainer width 1.0 @256", lambda: ps.YoloTrainer(width=1.0, input_size=256),
             lambda s: ps.detector_batch(s, batch, 256, norm, 0.12)),
            ("HeatmapTrainer V2_L crop 256",
             lambda: ps.HeatmapTrainer(intr, crop_size=256, stages=V2_L, huber_beta=0.02),
             lambda s: ps.pose_batch(s, batch, 0.08))):
        trainer, sampler = make_trainer(), ps.SyntheticHumanSampler(hw, intr, seed=0)
        t = time.perf_counter()
        batches = [make_batch(sampler) for _ in range(steps + 1)]
        sample_ms = (time.perf_counter() - t) / (steps + 1) * 1e3
        trainer.train_step(batches[0])  # warm-up: cuDNN's algorithm choice, allocations
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for b in batches[1:]:
                trainer.train_step(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        _report(f"{name}, batch {batch}", prof, wall, steps, unit="step")
        print(f"[{name}, batch {batch}] host sampler {sample_ms:.1f} ms/batch")
        del trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write a Chrome trace of the graphs' step window here")
    ap.add_argument("--trainers", action="store_true",
                    help="profile the full-width synthetic pose trainers instead of the slice")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    if args.trainers:
        profile_trainers(args.steps)
        print(f"[profile] {torch.cuda.get_device_name(0)}")
        return 0
    pipe = build_slice()
    clip = slice_frames()
    frames = [clip[i % len(clip)] for i in range(16)]
    _profile("graphs", pipe, frames, args.steps, args.trace)
    _profile("eager", twin(pipe, cuda_graphs=False), frames, args.steps)
    _profile("graphs, focus off", twin(pipe, cuda_graphs=True, with_focus=False), frames,
             args.steps)
    for input_type in ("rgb", "hybrid"):
        pipe = build_slice(input_type=input_type)
        for f in frames[:3]:
            pipe.step(f)
        list(pipe.stream_batched(frames, 16))
        profile_steps(f"{input_type}, graphs", pipe, frames, args.steps)
        stages = rgb_stage_ms(pipe, frames)
        print(f"[{input_type}] device ms per frame, CUDA graphs: "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    print(f"[profile] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
