"""The full-width slice on one GPU, and where its time goes.

    python3 -m isbfsar_tpu_torch.profile_slice [--steps 5] [--trace PATH]

``build_slice`` is the slice that ``chip_smoke.py`` drives and this module
profiles: 640x480 I420, YOLOv4 @ 256, EfficientNetV2-L @ 256 crop, bf16,
the 0.3 detector gate, two random support actions. Its detector is the
calibrated production one (the ``pose-prod-256-calib`` bundle entry, which
holds the YOLO branch alone); EfficientNetV2-L and the MeTRAbs head are
random from a seed, because the 351 MB ``pose-prod-256`` base does not fit
the card machine's copy of the repo. A missing bundle file raises.

Run as a script, it warms the slice up on the smoke frames, then profiles
``FusedPipeline.step`` over ``--steps`` frames and one ``stream_batched``
batch of 16 with ``torch.profiler``. For each window it prints the host
wall time per frame, the device kernel time per frame, the device busy
share (kernel time over wall time), the kernel launches per frame and the
kernels that take the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.configs import PipelineConfig
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.pipeline import FusedPipeline

SMOKE_FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                            "smoke_frames.npz")


def smoke_frames() -> list:
    """Four rendered 640x480 I420 frames of the ``wave`` clip (README.md
    says how they were made), on which the calibrated detector fires."""
    with np.load(SMOKE_FRAMES) as f:
        return list(f["i420"])


def train_support(pipe: FusedPipeline, seed: int = 0) -> None:
    """Two random support actions, as bench.py trains them, then a fresh stream."""
    rng = np.random.default_rng(seed)
    for i in range(2):
        pipe.ar.train({"flag": f"action_{i}",
                       "data": {"poses": rng.normal(size=(pipe.config.ar.seq_len, 90)).astype(np.float32)},
                       "requires_focus": False})
    pipe.start()


def build_slice(seed: int = 0) -> FusedPipeline:
    """The full-width slice on the card (see the module docstring)."""
    config = PipelineConfig()
    hpe = HumanPoseEstimator(config.hpe, config.intrinsics, seed=seed)
    delta = weights.load_bundle("pose-prod-256-calib")
    hpe.nets["yolo"].load_state_dict(weights.convert_variables(delta["yolo"]), strict=True)
    pipe = FusedPipeline(config, hpe=hpe)
    train_support(pipe)
    return pipe


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _report(name: str, prof, wall_s: float, n_frames: int, top: int = 12) -> None:
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device time")
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    print(f"[{name}] wall {wall_s / n_frames * 1e3:.3f} ms/frame, device {busy_us / n_frames / 1e3:.3f} "
          f"ms/frame, busy share {busy_us / 1e6 / wall_s:.3f}, {len(events) / n_frames:.0f} "
          f"kernels/frame")
    for kname, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{name}]   {us / busy_us * 100:5.1f}%  {us / n_frames / 1e3:8.4f} ms/frame  "
              f"x{count / n_frames:.0f}  {kname[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write a Chrome trace of the step window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    pipe = build_slice()
    clip = smoke_frames()
    frames = [clip[i % len(clip)] for i in range(16)]
    for f in frames[:3]:
        pipe.step(f)
    list(pipe.stream_batched(frames, 16))
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for f in frames[:args.steps]:
            pipe.step(f)
        wall = time.perf_counter() - t
    _report("step B=1", prof, wall, args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        list(pipe.stream_batched(frames, 16))
        wall = time.perf_counter() - t
    _report("stream_batched B=16", prof, wall, 16)
    print(f"[profile] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
