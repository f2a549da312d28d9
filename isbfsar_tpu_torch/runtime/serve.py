"""Compute-side service entry point of the port (the reference's main.py role;
port of ``isbfsar_tpu/runtime/serve.py``).

Run the queue hub, then this service, then a source:

    python -m isbfsar_tpu_torch.runtime.ipc                  # the broker
    python -m isbfsar_tpu_torch.runtime.serve --fused        # owns the card
    python -c 'from isbfsar_tpu_torch.runtime.source import SyntheticSource, run_source; run_source(SyntheticSource())'

Topology kept from the reference: source (camera and UI) <-> hub (TCP
queues) <-> this process (all compute). ``--device`` picks the card
(``cuda``, the default) or the CPU; a card that is asked for and missing
is an error, never a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Optional

import torch

from isbfsar_tpu_torch.configs import PipelineConfig
from isbfsar_tpu_torch.runtime.ipc import DEFAULT_PORT, QueueClient
from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="isbfsar serving process (PyTorch port)")
    parser.add_argument("--hub", default="localhost",
                        help="TCP hub host, or 'shm' for the same-host native shared-memory "
                             "transport (no hub process; runtime/shm_transport.py)")
    parser.add_argument("--hub-port", type=int, default=DEFAULT_PORT, help="TCP hub port")
    parser.add_argument("--input-type", default="skeleton",
                        choices=["skeleton", "rgb", "hybrid"],
                        help="rgb and hybrid add the ResNet-50 RGB extractor (random "
                             "weights: the bundle has no rgb recognizer) and run on the "
                             "module path only")
    parser.add_argument("--save-dir", default="saved")
    parser.add_argument("--yolo-thresh", type=float, default=None,
                        help="override the person-confidence gate (e.g. 0.0 for "
                             "random-weight smoke runs)")
    parser.add_argument("--fused", action="store_true",
                        help="run the CUDA-graphed fused pipeline on the frame path")
    parser.add_argument("--transport", choices=["i420", "bgr"], default="i420",
                        help="fused path frame format on the card: i420 halves the upload "
                             "(encoded on the host, decoded by the fused kernel)")
    parser.add_argument("--no-overlap", action="store_true",
                        help="fused path: synchronous per-frame stepping (lowest latency); "
                             "the default dispatches frame i while decoding frame i-1")
    parser.add_argument("--weights", default="auto", choices=["auto", "pretrained", "random"],
                        help="pose-stack weights: 'pretrained' loads the bundled production "
                             "fit (pose-prod-256 with its calibration delta), 'random' keeps "
                             "a fresh init (pair with --yolo-thresh 0.0), 'auto' loads the "
                             "bundle when present")
    parser.add_argument("--param-dtype", default="bfloat16", choices=["float32", "bfloat16"],
                        help="fused path storage type of the conv trunks' weights")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the nets run; the CPU only when asked for")
    return parser.parse_args(argv)


def load_pose_stack(weights: str, gate: float) -> Optional[Any]:
    """The bundled pose stack for ``--weights``, or None for random init.
    'auto' falls back to random init when the bundle or its base file is
    absent; 'pretrained' raises then."""
    if weights == "random":
        return None
    from isbfsar_tpu_torch import weights as bundles

    try:
        params = bundles.load_calibrated("pose-prod-256")
    except (KeyError, FileNotFoundError):
        if weights == "pretrained":
            raise
        print("[isbfsar-tpu] pose stack: bundle absent -> random init "
              "(pass --yolo-thresh 0.0 for smoke runs)", flush=True)
        return None
    print(f"[isbfsar-tpu] pose stack: bundled pose-prod-256 + calib delta (gate {gate})",
          flush=True)
    return params


def build(args: argparse.Namespace, in_q=None, out_q=None) -> Orchestrator:
    """The orchestrator ``args`` describe, on its queues, warmed up."""
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator

    if args.fused and args.input_type != "skeleton":
        raise ValueError("--fused requires skeleton mode")
    config = dataclasses.replace(PipelineConfig.for_input(args.input_type),
                                 param_dtype=args.param_dtype)
    if args.yolo_thresh is not None:
        config = dataclasses.replace(
            config, hpe=dataclasses.replace(config.hpe, yolo_thresh=args.yolo_thresh))
    cam_shape = (config.main.cam_height, config.main.cam_width)
    params = load_pose_stack(args.weights, config.hpe.yolo_thresh)
    hpe = HumanPoseEstimator(config.hpe, config.intrinsics, params=params, frame_shape=cam_shape,
                             device=args.device)
    fused = None
    if args.fused:
        from isbfsar_tpu_torch.pipeline import FusedPipeline

        fused = FusedPipeline(config, hpe=hpe, with_focus=True, input_format=args.transport,
                              device=args.device)
    orch = Orchestrator(config, in_queue=in_q, out_queue=out_q, hpe=hpe,
                        save_dir=args.save_dir, fused=fused,
                        fused_overlap=not args.no_overlap, device=args.device)
    print("[isbfsar-tpu] warming up...", flush=True)
    if fused is not None:
        fused.warmup()
    else:
        orch.hpe.warmup()
        orch.focus.warmup()
    return orch


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[isbfsar-tpu] --device cuda: no CUDA device is available (pass --device cpu "
              "to serve on the CPU)", file=sys.stderr)
        return 2
    if args.hub == "shm":
        from isbfsar_tpu_torch.runtime.shm_transport import serve_queues

        config = PipelineConfig.for_input(args.input_type)
        in_q, out_q = serve_queues((config.main.cam_height, config.main.cam_width, 3),
                                   rgb_size=config.ar.rgb_size)
    else:
        client = QueueClient(args.hub, args.hub_port)
        in_q = client.get_queue("source_human")
        out_q = client.get_queue("human_sink")
    orch = build(args, in_q, out_q)
    from isbfsar_tpu_torch.pipeline import KERNELS

    for kernel in KERNELS:
        kernel.launches = 0
    print(f"[isbfsar-tpu] serving on {args.device}", flush=True)
    orch.run()
    counts = {kernel.__name__: kernel.launches for kernel in KERNELS}
    print(f"[isbfsar-tpu] stopped; kernel launches while serving: {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
