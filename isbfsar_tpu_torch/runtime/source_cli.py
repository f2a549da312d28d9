"""Host-side CLI: camera/synthetic frames in, console visualization out
(port of ``isbfsar_tpu/runtime/source_cli.py``).

The reference's source.py equivalent, with an interactive stdin command
thread replacing the VisPy keyboard console (commands: add <name> [-focus],
remove <name>, save, load, debug, quit). Its arguments are JAX's, plus
``--hub-port``, which the port's ``serve`` has too. It runs no model: it
pushes frames to the queue hub and shows what the service
(``runtime/serve.py``) answers, so it needs no card.

    python -m isbfsar_tpu_torch.runtime.ipc &
    python -m isbfsar_tpu_torch.runtime.serve --fused &
    python -m isbfsar_tpu_torch.runtime.source_cli --source synthetic
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.runtime.ipc import DEFAULT_PORT


def _stdin_commands():
    """Non-blocking stdin command iterator ('' when no pending command)."""
    pending: "queue.Queue[str]" = queue.Queue()

    def reader():
        for line in sys.stdin:
            pending.put(line.strip())

    threading.Thread(target=reader, daemon=True).start()
    while True:
        try:
            yield pending.get_nowait()
        except queue.Empty:
            yield ""


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hub", default="localhost",
                        help="TCP hub host, or 'shm' for the same-host "
                             "native shared-memory transport")
    parser.add_argument("--hub-port", type=int, default=DEFAULT_PORT,
                        help="TCP hub port (as runtime/serve.py's)")
    parser.add_argument("--source", default="synthetic",
                        choices=["synthetic", "video", "webcam", "realsense",
                                 "humanoid"])
    parser.add_argument("--path", default=None, help="video file for --source video")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--gui", action="store_true",
                        help="interactive 2x2 panel (reference VisPy GUI); "
                             "commands typed into the window")
    parser.add_argument("--os-threshold", type=float,
                        default=ARConfig().os_threshold,
                        help="open-set accept gate for the green action "
                             "label (reference 0.66; use the workflow "
                             "receipt's calibrated os_threshold — "
                             "train/fsos.py::calibrate_os_threshold)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from isbfsar_tpu_torch.runtime.source import make_source, run_source
    from isbfsar_tpu_torch.runtime.visualizer import ConsoleVisualizer

    args = parse_args(argv)
    if args.gui:
        from isbfsar_tpu_torch.runtime.visualizer import GUIVisualizer

        visualizer = GUIVisualizer(os_threshold=args.os_threshold)
        command_stream = visualizer.commands()
    else:
        visualizer = ConsoleVisualizer()
        command_stream = _stdin_commands()

    kw = {"path": args.path} if args.source == "video" else {}
    source = make_source(args.source, **kw)
    n = run_source(
        source,
        hub_host=args.hub,
        hub_port=args.hub_port,
        visualizer=visualizer,
        command_stream=command_stream,
        max_frames=args.max_frames,
    )
    print(f"[isbfsar-tpu] source done after {n} frames")


if __name__ == "__main__":
    main()
