"""Times of the port's CUDA kernels on one GPU.

    python3 -m isbfsar_tpu_torch.kernel_bench [--parent DIR] [--bands 4,2,1]

The fused I420 kernel: at B=16 and at B=1, 480x640 frames, S=256, it prints two times per launch:
``graph``, the device time, from CUDA events around replays of a CUDA graph
of ``REPS`` launches; and ``loop``, CUDA events around a Python loop of
launches, which the host's launch rate bounds when a launch is short.
With ``--parent DIR`` (an unpacked earlier tree of this repository, or of
its ``isbfsar_tpu_torch`` package alone; repeatable), it builds that tree's
kernels from that tree's sources into that tree's ``build/`` and times the
versions in turns: the parents, this tree, this tree, the parents in
reverse. ``--bands`` also times this tree's kernel with each listed band
height G forced (the plan's choice is the default).

The focus-geometry kernel (``ops/head_pose.py``): at B=1, 8 and 16 on
random face landmarks (:func:`face_landmarks`) and on the committed face
frames' landmarks at both sizes, its graph time, the plain version's time
from a synchronised host loop (``torch.linalg.svd`` waits for the host, so
no graph holds it), its bound (:func:`head_pose_bound`), its Newton steps
and its largest differences from the plain version. With ``--parent``,
the same inputs through a parent's head-pose kernel, alone and followed by
the plain geometry the focus step ran after it (``rotmat_to_rotvec``,
``normalization_camera`` and the head rotation in the normalized camera),
both as CUDA graphs, in the same turns. Needs a CUDA device.
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


def head_pose_bound(landmarks: torch.Tensor, k: torch.Tensor, launch: float, out_size: int = 224,
                    iters: int = 40) -> float:
    """The least time of a focus-geometry launch on these landmarks: the
    launch, plus the float64 operations the source does for them (its
    Newton steps depend on the data, so a launch reports them) over the
    card's float64 rate."""
    steps = newton_steps(landmarks, k, out_size, iters)
    ops = head_pose.operations(landmarks.shape[0], iters, int(steps[:, 0].sum()))
    return launch + ops / FP64_OPS_PER_S * 1e3


def newton_steps(landmarks: torch.Tensor, k: torch.Tensor, out_size: int = 224,
                 iters: int = 40) -> torch.Tensor:
    """(B, 2) int32 on the host: each frame's Newton steps over all
    iterations, and the most one iteration took."""
    steps = torch.zeros((landmarks.shape[0], 2), dtype=torch.int32, device=landmarks.device)
    head_pose.focus_geometry(landmarks, k, out_size=out_size, iters=iters, steps=steps)
    return steps.cpu()


# The focus-geometry kernel (float64 inside) against its plain version
# (float32, cuSOLVER's SVD) on the card: the rotation, the center over its
# distance (at least 1 m), the rotation vectors, the warp as the frame
# pixels the crop's corners go to, and the normalizing rotation. An H100
# read up to 3.6e-6, 1.2e-6, 3.4e-6, 8.9e-5 px and 1.2e-7 over the inputs
# of kernel_bench.py and chip_smoke.py; a host build of the kernel reads
# 1.5e-6, 6.6e-7, 1.8e-6, 9.9e-5 px and 1.2e-7 against the plain version
# on the CPU (tests/test_torch_head_pose_host.py). The limits are a few
# times that; rotation and center as since the kernel was written.
TOL_HEAD = {"rot": 1e-5, "center": 5e-6, "rotvec": 1e-5, "warp": 5e-4, "r_norm": 1e-6,
            "head_rot2d": 1e-5}


def geometry_errors(got, want, out_size: int) -> dict:
    """Largest difference per field of two ``FocusGeometry`` results: the
    center over max(1 m, its distance), the warp as the frame pixels it
    sends the corners of the ``out_size`` crop to, the rest absolute."""
    corners = torch.tensor([[0.0, out_size, 0.0, out_size], [0.0, 0.0, out_size, out_size],
                            [1.0, 1.0, 1.0, 1.0]], dtype=torch.float64)
    err = {}
    for name, a, b in zip(want._fields, got, want, strict=True):
        a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
        if name == "warp":
            a, b = a @ corners, b @ corners
            a, b = a[..., :2, :] / a[..., 2:, :], b[..., :2, :] / b[..., 2:, :]
        d = (a - b).abs()
        if name == "center":
            d = d / b.norm(dim=-1, keepdim=True).clamp(min=1.0)
        err[name] = float(d.max()) if d.numel() else 0.0
    return err


def head_pose_errors(landmarks: torch.Tensor, k: torch.Tensor, out_size: int = 224) -> dict:
    """:func:`geometry_errors` of the kernel against its plain version on
    the same card."""
    got = head_pose.focus_geometry(landmarks, k, out_size=out_size)
    want = head_pose.focus_geometry_reference(landmarks, k, out_size=out_size)
    return geometry_errors(got, want, out_size)


def load_parent(tree: str, module: str = "fused_input"):
    """Module ``ops/<module>.py`` of an unpacked earlier tree, its kernels
    built from that tree's ``csrc/`` into that tree's ``build/``."""
    tag = "parent_" + os.path.basename(os.path.normpath(tree))

    def load(name: str):
        path = os.path.join(tree, "isbfsar_tpu_torch", "ops", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"{tag}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    mod = load(module)
    mod._build = load("build")  # the parent's own sources and build directory
    return mod


def face_cases(rng: np.random.Generator):
    """(name, landmarks, intrinsics, gaze crop size) on the card: random
    faces at B=1, 8 and 16 (480-line camera, 224 crop), and the committed
    face frames at 480 lines (224 crop) and 240 lines (the CI camera, 64)."""
    from isbfsar_tpu_torch.profile_slice import CI_INTRINSICS, focus_frames

    k = torch.from_numpy(CameraIntrinsics().matrix()).cuda()
    cases = [(f"B={b} random faces", torch.from_numpy(face_landmarks(b, rng)).cuda(), k, 224)
             for b in (1, 8, 16)]
    for height, intr, size in ((480, CameraIntrinsics(), 224), (240, CI_INTRINSICS, 64)):
        lms = torch.from_numpy(focus_frames(height)["landmarks"]).cuda()
        cases.append((f"B={lms.shape[0]} {height}-line face frames", lms,
                      torch.from_numpy(intr.matrix()).cuda(), size))
    return cases


def parent_geometry(parent, lms: torch.Tensor, k: torch.Tensor, size: int, nd: float = 0.6):
    """A parent's head-pose kernel and then the plain geometry the focus
    step ran after it, as ``FocusGeometry``."""
    rot, center = parent.head_pose_from_landmarks(lms, k, nd)
    return head_pose.geometry_of_pose(rot, center, k, nd, size)


def bench_head_pose(parents, rng: np.random.Generator) -> None:
    launch = launch_ms()
    for name, lms, k, size in face_cases(rng):
        err = head_pose_errors(lms, k, size)
        steps = newton_steps(lms, k, size)
        plain = lambda: head_pose.focus_geometry_reference(lms, k, out_size=size)  # noqa: E731
        per_iteration = float(steps[:, 0].float().mean()) / 40
        print(f"[kernel_bench] focus geometry {name}, crop {size}: bound "
              f"{head_pose_bound(lms, k, launch, size):.5f} ms (launch {launch:.5f} ms), plain "
              f"(host loop, synchronised) {loop_ms(plain, reps=5):.4f} ms, Newton steps "
              f"{per_iteration:.2f} per iteration (most {int(steps[:, 1].max())}), max|err| "
              + " ".join(f"{f} {v:.3g}" for f, v in err.items()), flush=True)
        versions = [(f"this tree: {'focus_geometry':35s}",
                     lambda: head_pose.focus_geometry(lms, k, 0.6, 0.6, size))]
        for tree, mod in parents:
            versions = [(f"{tree}: {'head_pose_from_landmarks':35s}",
                         lambda mod=mod: mod.head_pose_from_landmarks(lms, k, 0.6)),
                        (f"{tree}: {'head_pose_from_landmarks + geometry':35s}",
                         lambda mod=mod: parent_geometry(mod, lms, k, size))] + versions
        order = versions + versions[::-1]
        for label, fn in order:
            print(f"[kernel_bench] focus geometry {name}: {label} graph {graph_ms(fn):.5f} ms",
                  flush=True)
        for tree, mod in parents:
            perr = geometry_errors(parent_geometry(mod, lms, k, size),
                                   head_pose.focus_geometry(lms, k, 0.6, 0.6, size), size)
            print(f"[kernel_bench] focus geometry {name}: {tree} against this tree, max|diff| "
                  + " ".join(f"{f} {v:.3g}" for f, v in perr.items()), flush=True)


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
    bench_head_pose([(tree, load_parent(tree, "head_pose")) for tree in args.parent], rng)
    print(f"[kernel_bench] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
