"""Times of the fused I420 kernel on one GPU.

    python3 -m isbfsar_tpu_torch.kernel_bench [--parent DIR] [--bands 4,2,1]

At B=16 and at B=1, 480x640 frames, S=256, it prints two times per launch:
``graph``, the device time, from CUDA events around replays of a CUDA graph
of ``REPS`` launches; and ``loop``, CUDA events around a Python loop of
launches, which the host's launch rate bounds when a launch is short.
With ``--parent DIR`` (an unpacked earlier tree of this repository;
repeatable), it builds that tree's kernel too and times the versions in
turns: the parents, this tree, this tree, the parents in reverse. ``--bands`` also times this tree's kernel with
each listed band height G forced (the plan's choice is the default).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

from isbfsar_tpu_torch.ops import fused_input

REPS = 20  # launches per graph


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
    print(f"[kernel_bench] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
