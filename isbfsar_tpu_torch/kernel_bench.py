"""Times of the port's CUDA kernels on one GPU.

    python3 -m isbfsar_tpu_torch.kernel_bench [--parent DIR] [--bands 4,2,1]

The fused I420 kernel: at B=16 and at B=1, 480x640 frames, S=256, it prints two times per launch:
``graph``, the device time, from CUDA events around replays of a CUDA graph
of ``REPS`` launches; and ``loop``, CUDA events around a Python loop of
launches, which the host's launch rate bounds when a launch is short.
With ``--parent DIR`` (an unpacked earlier tree of this repository;
repeatable), it builds that tree's kernel too and times the versions in
turns: the parents, this tree, this tree, the parents in reverse. ``--bands`` also times this tree's kernel with
each listed band height G forced (the plan's choice is the default).

The head-pose kernel: at B=1, 8 and 16 on random face landmarks
(:func:`face_landmarks`), its graph time, the plain version's time from a
synchronised host loop (``torch.linalg.svd`` waits for the host, so no
graph holds it), its bound (:func:`head_pose_bound`) and its largest
differences from the plain version. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

from isbfsar_tpu_torch.configs import CameraIntrinsics
from isbfsar_tpu_torch.focus import geometry
from isbfsar_tpu_torch.ops import fused_input, head_pose

REPS = 20  # launches per graph
FP64_OPS_PER_S = 34e12  # H100 SXM, float64 outside the tensor cores (NVIDIA data sheet)


def graph_ms(fn, reps: int = REPS, replays: int = 10) -> float:
    """Device ms per call of ``fn``: a CUDA graph of ``reps`` calls, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def loop_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """ms per call of ``fn`` from CUDA events around a host loop of calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def face_landmarks(n: int, rng: np.random.Generator, intrinsics=None,
                   noise_px: float = 1.0) -> np.ndarray:
    """(n, 6, 2) float32 pixel landmarks of the canonical face under random
    head rotations (up to 0.8 rad about each axis), 0.3-2 m away inside the
    view, projected through ``intrinsics`` with Gaussian pixel noise."""
    k = (intrinsics or CameraIntrinsics()).matrix().astype(np.float64)
    out = np.empty((n, 6, 2), np.float32)
    for i in range(n):
        ax, ay, az = rng.uniform(-0.8, 0.8, 3)
        rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
        ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
        rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
        z = rng.uniform(0.3, 2.0)
        pos = np.array([rng.uniform(-0.3, 0.3) * z, rng.uniform(-0.2, 0.2) * z, z])
        proj = (geometry.CANONICAL_FACE_3D @ (rz @ ry @ rx).T + pos) @ k.T
        out[i] = proj[:, :2] / proj[:, 2:] + rng.normal(0.0, noise_px, (6, 2))
    return out


def launch_ms() -> float:
    """Device ms of the smallest kernel (a one-element add) back to back in
    a CUDA graph: what a launch costs the stream."""
    tiny = torch.zeros(1, device="cuda")
    return graph_ms(lambda: tiny.add_(1.0))


def head_pose_bound(landmarks: torch.Tensor, k: torch.Tensor, launch: float,
                    iters: int = 40) -> float:
    """The least time of a head-pose launch on these landmarks: the launch,
    plus the float64 operations the source does for them (its Jacobi sweeps
    depend on the data, so a launch reports them) over the card's float64
    rate."""
    sweeps = torch.zeros(landmarks.shape[0], dtype=torch.int32, device=landmarks.device)
    head_pose.head_pose_from_landmarks(landmarks, k, iters=iters, sweeps=sweeps)
    ops = head_pose.operations(landmarks.shape[0], iters, int(sweeps.sum()))
    return launch + ops / FP64_OPS_PER_S * 1e3


def head_pose_errors(landmarks: torch.Tensor, k: torch.Tensor):
    """(max |rot - plain|, max |center - plain| over max(1 m, |plain center|))
    of the kernel against its plain version on the same card."""
    rot, center = head_pose.head_pose_from_landmarks(landmarks, k)
    ref_rot, ref_center = geometry.head_pose_from_landmarks(landmarks, k)
    err_rot = float((rot - ref_rot).abs().max())
    scale = ref_center.norm(dim=-1, keepdim=True).clamp(min=1.0)
    err_center = float(((center - ref_center).abs() / scale).max())
    return err_rot, err_center


def load_parent(tree: str):
    """The fused_input module of an unpacked earlier tree, building into that tree."""
    path = os.path.join(tree, "isbfsar_tpu_torch", "ops", "fused_input.py")
    name = "parent_" + os.path.basename(os.path.normpath(tree))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="an unpacked earlier tree to time beside this one (repeatable)")
    ap.add_argument("--bands", default="", help="band heights G to force, e.g. 4,2,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    versions = [(tree, load_parent(tree)) for tree in args.parent] + [("this tree", fused_input)]
    rng = np.random.default_rng(0)
    h, w, s = 480, 640, 256
    for b in (16, 1):
        yuv = torch.from_numpy(rng.integers(0, 256, (b, h * 3 // 2, w), np.uint8)).cuda()
        ref_bgr, ref_yolo = fused_input.fused_i420_reference(yuv, h, s)
        order = versions + versions[::-1] if len(versions) > 1 else versions * 2
        for name, mod in order:
            bgr, yolo = mod.fused_i420_inputs(yuv, h, s)
            err = max(float((bgr - ref_bgr).abs().max()), float((yolo - ref_yolo).abs().max()))
            fn = lambda: mod.fused_i420_inputs(yuv, h, s)  # noqa: E731
            print(f"[kernel_bench] B={b} {h}x{w} S={s} {name:10s}: graph {graph_ms(fn):.5f} ms, "
                  f"loop {loop_ms(fn):.5f} ms, max|err| {err:.3g}", flush=True)
    for g in [int(v) for v in args.bands.split(",") if v]:
        fused_input.BANDS = (g,)
        fused_input.choose_plan.cache_clear()
        fused_input._device_tables.cache_clear()
        for b in (16, 1):
            yuv = torch.from_numpy(rng.integers(0, 256, (b, h * 3 // 2, w), np.uint8)).cuda()
            fn = lambda: fused_input.fused_i420_inputs(yuv, h, s)  # noqa: E731
            print(f"[kernel_bench] B={b} {h}x{w} S={s} G={g}: graph {graph_ms(fn):.5f} ms, "
                  f"loop {loop_ms(fn):.5f} ms", flush=True)
    k = torch.from_numpy(CameraIntrinsics().matrix()).cuda()
    launch = launch_ms()
    for b in (1, 8, 16):
        lms = torch.from_numpy(face_landmarks(b, rng)).cuda()
        fn = lambda: head_pose.head_pose_from_landmarks(lms, k)  # noqa: E731
        plain = lambda: geometry.head_pose_from_landmarks(lms, k)  # noqa: E731
        err_rot, err_center = head_pose_errors(lms, k)
        print(f"[kernel_bench] head pose B={b}: graph {graph_ms(fn):.5f} ms, plain (host loop, "
              f"synchronised) {loop_ms(plain, reps=5):.4f} ms, bound {head_pose_bound(lms, k, launch):.5f} "
              f"ms (launch {launch:.5f} ms), max|err| rot {err_rot:.3g} center {err_center:.3g}",
              flush=True)
    print(f"[kernel_bench] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
