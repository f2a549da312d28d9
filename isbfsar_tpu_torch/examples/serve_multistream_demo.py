"""Multi-stream mesh serving demo: S cameras on one program, composable
way-sharding for big support sets (port of
``examples/serve_multistream_demo.py``).

    python -m isbfsar_tpu_torch.examples.serve_multistream_demo [--ranks 2] \\
        [--way-devices 2] [--device cpu] [--ci-size]

With ``--ranks N`` the demo starts a process group of N ranks
(``parallel/launch.py::run_ranks``: NCCL on the cards, one card a rank;
gloo for ``--device cpu``) and serves over ``MultiStreamPipeline(mesh=...)``:
the streams split over the mesh's ``dp`` axis, and with ``--way-devices``
the support classes also split over a second ``way`` axis. Without it, one
process serves every stream. The pipeline runs focus off, on I420 frames
(each step launches the fused I420 kernel on the card), at the production
model sizes with random weights; ``--ci-size`` takes the CI operating point
instead (pose-ci-motions at 120x160, float32), which the CPU runs in
seconds. Action scores appear once a stream's window holds seq_len (16)
frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

CI_SHAPE = (120, 160)
RANKS_TIMEOUT_S = 900.0  # what the ranks may take in all (--ranks > 1)


def build_pipe(way: int = 16, device: str = "cuda", ci_size: bool = False):
    """The focus-off FusedPipeline with ``way`` support slots and five random
    actions learned."""
    from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
    from isbfsar_tpu_torch.configs import (ARConfig, CameraIntrinsics, HPEConfig, MainConfig,
                                           PipelineConfig)
    from isbfsar_tpu_torch.pipeline import FusedPipeline

    ar_cfg = dataclasses.replace(ARConfig.for_input("skeleton"), way=way)
    ar = ActionRecognizer(ar_cfg, device=device)
    rng = np.random.default_rng(0)
    for i in range(min(5, way)):
        ar.train({
            "flag": f"action_{i}",
            "data": {"poses": rng.normal(size=(ar_cfg.seq_len, 90)).astype(np.float32)},
            "requires_focus": False,
        })
    if not ci_size:
        cfg = dataclasses.replace(
            PipelineConfig(), ar=ar_cfg,
            hpe=dataclasses.replace(PipelineConfig().hpe, yolo_thresh=0.0),
        )
        return FusedPipeline(cfg, ar=ar, with_focus=False, device=device)

    from isbfsar_tpu_torch import weights
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY

    h, w = CI_SHAPE
    intr = CameraIntrinsics(width=w, height=h)
    hpe_cfg = HPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.0,
                        compute_dtype="float32")
    cfg = PipelineConfig(main=MainConfig(cam_width=w, cam_height=h), intrinsics=intr,
                         hpe=hpe_cfg, ar=ar_cfg, param_dtype="float32")
    hpe = HumanPoseEstimator(hpe_cfg, intr, params=weights.load_bundle("pose-ci-motions"),
                             backbone_stages=V2_TINY, frame_shape=CI_SHAPE, yolo_width=0.25,
                             device=device)
    return FusedPipeline(cfg, hpe=hpe, ar=ar, with_focus=False, device=device)


def run_demo(streams: int = 0, way_devices: int = 1, way: int = 16, frames: int = 32,
             device: str = "cuda", ci_size: bool = False) -> Dict:
    """Serve ``frames`` ticks of synthetic camera frames to the streams.
    Inside a process group the streams split over a mesh of its ranks (and
    the classes over ``way_devices`` of them); outside one, this process
    serves them all. Returns {"n_streams", "mesh", "seconds", "elements":
    the last tick's decoded elements per stream}."""
    import torch
    import torch.distributed as dist

    from isbfsar_tpu_torch.ops.image import bgr_to_i420
    from isbfsar_tpu_torch.runtime.source import SyntheticSource
    from isbfsar_tpu_torch.serving import MultiStreamPipeline

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    if torch.device(device).type == "cuda" and dist.is_initialized():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    pipe = build_pipe(way, device, ci_size)
    if dist.is_initialized():
        from isbfsar_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

        if way_devices > 1:
            mesh = make_mesh_2d((n_dev // way_devices, way_devices), device=device)
            n_streams = streams or (n_dev // way_devices)
            multi = MultiStreamPipeline(n_streams=n_streams, mesh=mesh, pipe=pipe, way_axis="way")
            layout = (f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}: {n_streams} "
                      f"streams on dp, {pipe.config.ar.way} classes sharded over {way_devices} "
                      "way-devices")
        else:
            mesh = make_mesh(device=device)
            n_streams = streams or n_dev
            multi = MultiStreamPipeline(n_streams=n_streams, mesh=mesh, pipe=pipe)
            layout = (f"1D mesh ({n_dev} ranks): {n_streams} streams sharded, support "
                      "replicated")
    else:
        if way_devices > 1:
            raise ValueError("--way-devices needs a process group: pass --ranks")
        mesh, n_streams = None, streams or 1
        multi = MultiStreamPipeline(n_streams=n_streams, pipe=pipe)
        layout = f"no mesh: {n_streams} streams in one process"
    print(f"devices: {n_dev} x {device}; {layout}")

    multi.start()
    h, w = pipe.hpe.frame_shape
    sources = [SyntheticSource(w, h) for _ in range(n_streams)]
    to_input = bgr_to_i420 if pipe.input_format == "i420" else (lambda f: f)
    t0 = time.time()
    outs: List = []
    for _ in range(frames):
        outs = multi.step(np.stack([to_input(s.read()[1]) for s in sources]))
    dt = time.time() - t0
    print(f"{frames} steps x {n_streams} streams in {dt:.1f}s "
          f"-> {frames * n_streams / dt:.1f} stream-frames/s")
    elements = [multi.decode(out) for out in outs]
    for i, el in enumerate(elements):
        print(f"stream {i}: actions={ {k: round(v, 3) for k, v in el.get('actions', {}).items()} }")
    return {"n_streams": n_streams, "mesh": mesh is not None, "seconds": dt,
            "elements": elements}


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--streams", type=int, default=0,
                        help="0 = one stream per dp-device (always valid)")
    parser.add_argument("--way-devices", type=int, default=1,
                        help=">1 also shards the support classes over a "
                        "second mesh axis (way must divide evenly)")
    parser.add_argument("--way", type=int, default=16)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--ranks", type=int, default=1,
                        help=">1 serves from a process group of this many ranks (one card "
                        "each on cuda, gloo processes on cpu)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no fallback to the CPU)")
    parser.add_argument("--ci-size", action="store_true",
                        help="the CI operating point (pose-ci-motions, 120x160, float32)")
    args = parser.parse_args(argv)
    kw = dict(streams=args.streams, way_devices=args.way_devices, way=args.way,
              frames=args.frames, device=args.device, ci_size=args.ci_size)
    if args.ranks > 1:
        # by its module's name: under ``python -m`` this module is __main__,
        # which the ranks cannot unpickle a function from
        from isbfsar_tpu_torch.examples.serve_multistream_demo import run_demo_kw as rank_fn
        from isbfsar_tpu_torch.parallel.launch import run_ranks

        out = run_ranks(rank_fn, args.ranks, args.device, RANKS_TIMEOUT_S, kw)[0]
        print(f"rank 0 of {args.ranks}: {args.frames} steps x {out['n_streams']} streams in "
              f"{out['seconds']:.1f}s")
        for i, el in enumerate(out["elements"]):
            print(f"stream {i}: actions="
                  f"{ {k: round(v, 3) for k, v in el.get('actions', {}).items()} }")
    else:
        run_demo(**kw)


def run_demo_kw(kw: Dict) -> Dict:
    """:func:`run_demo` on keyword arguments, for ``run_ranks``."""
    return run_demo(**kw)


if __name__ == "__main__":
    main()
