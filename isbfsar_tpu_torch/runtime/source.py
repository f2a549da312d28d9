"""Host I/O: frame sources + the host-side loop feeding the queue hub
(port of ``isbfsar_tpu/runtime/source.py``).

Rebuild of the reference's host process (reference source.py:20-54,
utils/input.py:5-59): read the camera at capture rate, forward
``{rgb, msg}`` dicts to the compute process through the named queue, pipe
results to the visualizer. Camera hardware is optional — every source
implements ``read() -> (ok, frame)`` and the loop is identical.

Sources:
- :class:`SyntheticSource` — procedurally animated frames (a moving bright
  blob on a gradient), for tests/benchmarks with zero hardware.
- :class:`VideoSource` — a video file via OpenCV.
- :class:`WebcamSource` — cv2.VideoCapture(index).
- :class:`RealSenseSource` — RealSense D435i when pyrealsense2 exists
  (reference utils/input.py contract: 640x480 BGR8 + depth).
- :class:`HumanoidSource` — rendered humanoid motion clips
  (``train/posestack.py``), which a trained detector fires on.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np


class SyntheticSource:
    """Deterministic procedural frames: gradient + moving square 'person'."""

    def __init__(self, width: int = 640, height: int = 480, fps: float = 60.0):
        self.width, self.height, self.fps = width, height, fps
        self._i = 0
        gx = np.linspace(0, 255, width, dtype=np.float32)[None, :]
        gy = np.linspace(0, 255, height, dtype=np.float32)[:, None]
        self._base = np.stack(
            [gx + 0 * gy, 0 * gx + gy, 0.5 * (gx + gy)], axis=-1
        ).astype(np.uint8)

    def read(self) -> Tuple[bool, np.ndarray]:
        frame = self._base.copy()
        cx = int((0.3 + 0.4 * np.sin(self._i / 30.0)) * self.width)
        cy = self.height // 2
        w, h = self.width // 8, self.height // 3
        frame[max(cy - h, 0): cy + h, max(cx - w, 0): cx + w] = 230
        self._i += 1
        return True, frame

    def intrinsics(self):
        from isbfsar_tpu_torch.configs import CameraIntrinsics

        return CameraIntrinsics(width=self.width, height=self.height)

    def stop(self) -> None:
        pass


class VideoSource:
    def __init__(self, path: str):
        import cv2

        self._cap = cv2.VideoCapture(path)

    def read(self):
        return self._cap.read()

    def stop(self) -> None:
        self._cap.release()


class WebcamSource:
    def __init__(self, index: int = 0, width: int = 640, height: int = 480):
        import cv2

        self._cap = cv2.VideoCapture(index)
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)

    def read(self):
        return self._cap.read()

    def stop(self) -> None:
        self._cap.release()


class RealSenseSource:
    """RealSense D435i wrapper (reference utils/input.py:5-59 contract)."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 60):
        import pyrealsense2 as rs  # optional hardware dependency

        self._rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, width, height, rs.format.bgr8, fps)
        cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
        self.profile = self.pipeline.start(cfg)

    def read(self):
        frames = self.pipeline.wait_for_frames()
        color = frames.get_color_frame()
        if not color:
            return False, None
        return True, np.asanyarray(color.get_data())

    def intrinsics(self):
        from isbfsar_tpu_torch.configs import CameraIntrinsics

        intr = (
            self.profile.get_stream(self._rs.stream.color)
            .as_video_stream_profile()
            .get_intrinsics()
        )
        return CameraIntrinsics(
            fx=intr.fx, fy=intr.fy, ppx=intr.ppx, ppy=intr.ppy,
            width=intr.width, height=intr.height,
        )

    def stop(self) -> None:
        self.pipeline.stop()


class HumanoidSource:
    """Rendered humanoid demo stream: a camera-free source the trained pose
    stack detects at the 0.3 gate (SyntheticSource's moving square does not
    clear a trained detector). Cycles through rendered motion clips of 32
    frames over two cycles; the motion changes every ``frames_per_motion``
    frames, so a live drive acquires distinct actions."""

    def __init__(self, width: int = 640, height: int = 480,
                 motions=("wave", "squat", "walk"),
                 frames_per_motion: int = 160, fps: float = 30.0):
        from isbfsar_tpu_torch.configs import CameraIntrinsics
        from isbfsar_tpu_torch.train.posestack import render_motion_clip

        self.width, self.height, self.fps = width, height, fps
        self._intr = CameraIntrinsics(width=width, height=height)
        self._clips = []
        for m in motions:
            frames, _ = render_motion_clip(
                m, n_frames=32, frame_hw=(height, width),
                intrinsics=self._intr, cycles=2.0)
            self._clips.append(frames)
        self._fpm = frames_per_motion
        self._i = 0

    def read(self) -> Tuple[bool, np.ndarray]:
        clip = self._clips[(self._i // self._fpm) % len(self._clips)]
        frame = clip[self._i % len(clip)]
        self._i += 1
        return True, frame

    def intrinsics(self):
        return self._intr

    def stop(self) -> None:
        pass


def make_source(kind: str, **kw):
    return {
        "synthetic": SyntheticSource,
        "video": VideoSource,
        "webcam": WebcamSource,
        "realsense": RealSenseSource,
        "humanoid": HumanoidSource,
    }[kind](**kw)


def run_source(
    source,
    hub_host: str = "localhost",
    visualizer=None,
    command_stream=None,
    max_frames: Optional[int] = None,
    hub_port: Optional[int] = None,
) -> int:
    """Host loop (reference source.py:43-54): push frames + commands, drain results.

    command_stream: optional iterator yielding command strings ('' = none).
    hub_host: TCP hub host, or "shm" for the same-host native
    shared-memory transport (runtime/shm_transport.py) — channels open
    lazily on the first frame (their slot layout needs the frame shape).
    Returns the number of frames pushed.
    """
    to_compute = from_compute = None
    if hub_host != "shm":
        from isbfsar_tpu_torch.runtime.ipc import DEFAULT_PORT, QueueClient

        client = QueueClient(hub_host, hub_port or DEFAULT_PORT)
        to_compute = client.get_queue("source_human")
        from_compute = client.get_queue("human_sink")

    n = 0
    while max_frames is None or n < max_frames:
        ok, frame = source.read()
        if not ok:
            break
        if to_compute is None:
            from isbfsar_tpu_torch.runtime.shm_transport import source_queues

            to_compute, from_compute = source_queues(frame.shape)
        msg = next(command_stream, "") if command_stream is not None else ""
        to_compute.put({"rgb": frame, "msg": msg})
        n += 1
        if msg in ("close", "exit", "quit", "q"):
            # the compute loop exits without replying (reference main.py:152)
            break
        elements = from_compute.get()
        if "ACK" in elements:
            # add-command handshake: the ACK replaces this cycle's elements
            # (reference source keeps looping and feeds the acquisition
            # frames; a second blocking get here would deadlock — the
            # compute side is already waiting for the next frame).
            continue
        if visualizer is not None:
            visualizer.show(elements)
    source.stop()
    return n
