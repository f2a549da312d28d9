"""Pipeline orchestrator — the live frame loop and command protocol (port of
``isbfsar_tpu/runtime/orchestrator.py``).

One process owns the card. On the module path the frame is uploaded once
and shared by the pose estimator and the focus detector, both enqueued
before either is read (``estimate_async``), then joined in the reference's
order: hpe -> AR -> focus. On the fused path (``fused=FusedPipeline``) the
frame runs through the CUDA-graphed step instead.

Contracts kept:
- per-frame ``elements`` dict: img, bbox, pose, edges, distance, actions,
  is_true, requires_focus, focus, face_bbox, fps, log;
- command protocol: add <name> [-focus] (ACK **before** acquisition or the
  host UI deadlocks), remove, save, load, debug, close/exit/quit/q;
- learn_command: 3 s countdown, ``window_size`` good frames paced over
  ``acquisition_time`` seconds;
- 10-frame moving-average FPS.

In rgb and hybrid modes the module path crops the person on the host
(:func:`preprocess_ar_crop`: numpy and ``ops/image.py::resize_linear_u8``,
the twin of the JAX path's ``cv2.resize``) and feeds the whitened crop to
the recognizer and to ``elements["img_preprocessed"]``, which an ``add``
acquisition collects. That crop differs on purpose from the fused step's
device gather, as the two JAX crops differ.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np

from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.configs import PipelineConfig
from isbfsar_tpu_torch.focus.detector import FocusDetector
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.ops.image import (IMAGENET_SCALE, IMAGENET_SHIFT, bgr_to_i420,
                                         resize_linear_u8)
from isbfsar_tpu_torch.utils.transfer import to_device

QUIT = ("close", "exit", "quit", "q")


def preprocess_ar_crop(img: np.ndarray, bbox, out: int = 224) -> np.ndarray:
    """Square crop around the box (x1, x2, y1, y2) of a uint8 BGR frame ->
    (out, out, 3) whitened float32. The slice is cut at the frame's edges,
    so there it is not square, and the bilinear resize scales x and y apart."""
    x1, x2, y1, y2 = bbox
    xm, ym = int((x1 + x2) / 2), int((y1 + y2) / 2)
    half = max(xm - x1, ym - y1, 1)
    crop = img[max(ym - half, 0): ym + half, max(xm - half, 0): xm + half]
    crop = resize_linear_u8(crop, out, out).astype(np.float32) / np.float32(255.0)
    return (crop * np.asarray(IMAGENET_SCALE, np.float32)
            + np.asarray(IMAGENET_SHIFT, np.float32))


class Orchestrator:
    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        in_queue=None,
        out_queue=None,
        hpe: Optional[HumanPoseEstimator] = None,
        focus: Optional[FocusDetector] = None,
        ar: Optional[ActionRecognizer] = None,
        save_dir: str = "saved",
        clock=time.time,
        fused=None,
        fused_overlap: bool = True,
        device: str = "cuda",
    ):
        """fused: optional FusedPipeline; when given, the frame path runs its
        step (one upload and one packed host copy per frame) instead of the
        module path, with the same command protocol (support-set edits
        refresh its cached K/V).

        fused_overlap: double-buffer the fused path (default): each call
        dispatches frame i and decodes frame i-1, so the card computes frame
        i while the host reads frame i-1's packed vector. One frame of
        latency; the first call after start or a support edit returns a
        priming frame (img and empty actions, no pose). False steps each
        frame synchronously.

        device: where the module path's default nets live (the fused
        pipeline and injected modules bring their own)."""
        self.config = config or PipelineConfig()
        self.input_type = self.config.main.input_type
        self.window_size = self.config.main.window_size
        self.acquisition_time = self.config.main.acquisition_time
        self.skeleton_scale = self.config.main.skeleton_scale
        self.save_dir = save_dir
        self.clock = clock

        self.fused = fused
        self.fused_overlap = fused_overlap
        self._fused_pending = None  # (img, token) awaiting decode
        self._fused_batch_pending = None  # (imgs, token, start) for overlapped batches
        if fused is not None:
            self.hpe, self.focus, self.ar = fused.hpe, fused.focus, fused.ar
            fused.start()
        else:
            cam_shape = (self.config.main.cam_height, self.config.main.cam_width)
            self.hpe = hpe or HumanPoseEstimator(self.config.hpe, self.config.intrinsics,
                                                 frame_shape=cam_shape, device=device)
            self.focus = focus or FocusDetector(self.config.focus, self.config.intrinsics,
                                                frame_shape=cam_shape, device=device)
            self.ar = ar or ActionRecognizer(self.config.ar, device=device)

        self._in_queue = in_queue
        self._out_queue = out_queue

        self.fps_window = []
        self.edges = None

    # ------------------------------------------------------------ frame path

    def get_frame(self, img: Optional[np.ndarray] = None, log: Optional[str] = None) -> Dict[str, Any]:
        start = self.clock()
        elements: Dict[str, Any] = {}
        ar_input: Dict[str, np.ndarray] = {}

        if img is None:
            img = self._in_queue.get()["rgb"]
        elements["img"] = img

        if self.fused is not None:
            # halve the upload: planar I420 encoded on the host
            frame = bgr_to_i420(img) if self.fused.input_format == "i420" else img
            if not self.fused_overlap:
                elements.update(self.fused.decode(self.fused.step(frame)))
                return self._finish_frame(elements, start, log)
            # double-buffered: enqueue frame i, decode frame i-1 while the
            # card computes frame i
            token = self.fused.dispatch(frame)
            prev = self._fused_pending
            self._fused_pending = (img, token)
            if prev is None:
                # pipeline priming: the elements contract with no detection yet
                elements.update(actions={}, is_true=0, requires_focus={})
                return self._finish_frame(elements, start, log)
            prev_img, prev_token = prev
            elements["img"] = prev_img
            elements.update(self.fused.decode(self.fused.fetch(prev_token)))
            return self._finish_frame(elements, start, log)

        # fan-out: one upload shared by both modules, both enqueued, then joined
        frame_dev = to_device(img, self.hpe.device)
        hpe_token = self.hpe.estimate_async(frame_dev)
        focus_token = self.focus.estimate_async(frame_dev)

        hpe_res = self.hpe.estimate_collect(hpe_token)
        if self.input_type in ("hybrid", "rgb") and hpe_res is not None:
            elements["bbox"] = hpe_res["bbox"]
            crop = preprocess_ar_crop(img, hpe_res["bbox"], out=self.config.ar.rgb_size)
            ar_input["rgb"] = crop
            elements["img_preprocessed"] = crop
        if self.input_type in ("hybrid", "skeleton") and hpe_res is not None:
            pose, edges, bbox = hpe_res["pose"], hpe_res["edges"], hpe_res["bbox"]
            if self.edges is None:
                self.edges = edges
            if pose is not None:
                elements["distance"] = float(np.linalg.norm(pose[0])) * 2.5
                pose = pose - pose[0]
                elements["pose"] = pose
                ar_input["sk"] = pose.reshape(-1)
            elements["edges"] = edges
            if bbox is not None:
                elements["bbox"] = bbox

        actions, is_true, requires_focus = self.ar.inference(ar_input)
        elements["actions"] = actions
        elements["is_true"] = is_true
        elements["requires_focus"] = requires_focus

        focus_res = self.focus.estimate_collect(focus_token)
        if focus_res is not None:
            focus_flag, face = focus_res
            elements["focus"] = focus_flag
            elements["face_bbox"] = face.bbox.reshape(-1)

        return self._finish_frame(elements, start, log)

    def get_frame_batch(self, imgs, log: Optional[str] = None, overlap: bool = False):
        """Micro-batched fused serve: B frames -> B elements dicts through one
        step (one upload, one packed host copy for the batch). Each distinct
        B is its own CUDA graph: pick one B and keep it.

        overlap=False: synchronous, the returned elements are this call's
        frames. overlap=True: dispatch this batch and return the previous
        batch's elements, paired with the previous batch's imgs ([] on the
        first call)."""
        if self.fused is None:
            raise ValueError("get_frame_batch requires fused mode")
        start = self.clock()
        frames = imgs
        if self.fused.input_format == "i420":
            frames = [bgr_to_i420(i) for i in imgs]
        token = self.fused.dispatch_batch(np.stack(frames))

        if overlap:
            prev = self._fused_batch_pending
            self._fused_batch_pending = (list(imgs), token, start)
            if prev is None:
                return []
            imgs, token, start = prev

        rows = token.numpy()
        per_frame = max((self.clock() - start) / max(len(imgs), 1), 1e-9)
        out = []
        for img, row in zip(imgs, rows):
            elements = {"img": img}
            elements.update(self.fused.decode(self.fused.layout.unpack(row)))
            out.append(self._publish(elements, per_frame, log))
        return out

    def _publish(self, elements, frame_seconds: float, log):
        """The finishing contract of every frame path: moving-average FPS over
        the last 10 frames, the log line, the out queue."""
        self.fps_window.append(1.0 / max(frame_seconds, 1e-9))
        self.fps_window = self.fps_window[-10:]
        elements["fps"] = sum(self.fps_window) / len(self.fps_window)
        if log is not None:
            elements["log"] = log
        if self._out_queue is not None:
            self._out_queue.put(elements)
        return elements

    def _finish_frame(self, elements, start, log):
        return self._publish(elements, self.clock() - start, log)

    def _refresh_support(self) -> None:
        """Rebuild the fused pipeline's cached support K/V after edits."""
        if self.fused is not None:
            # a pending frame or batch was matched against the old support
            # set: drop it, the next call primes the pipeline again
            self._fused_pending = None
            self._fused_batch_pending = None
            self.fused.start()

    # -------------------------------------------------------------- commands

    def run(self) -> None:
        """Main loop: pull {rgb, msg} dicts, route commands."""
        while True:
            log = None
            data = self._in_queue.get()
            msg = data.get("msg", "")
            if msg:
                parts = msg.strip().split()
                cmd = parts[0]
                if cmd in QUIT:
                    break
                elif cmd == "add" and len(parts) > 1:
                    # the ACK must precede acquisition or the host blocks
                    self._out_queue.put({"ACK": True})
                    log = self.learn_command(parts[1:])
                    data = self._in_queue.get()
                elif cmd == "remove" and len(parts) > 1:
                    log = self.forget_command(parts[1])
                elif cmd == "save":
                    log = self.save()
                elif cmd == "load":
                    log = self.load()
                elif cmd == "debug":
                    self.debug()
                else:
                    log = "Not a valid command!"
            self.get_frame(img=data["rgb"], log=log)

    def learn_command(self, flag) -> str:
        """Acquire a new action clip and insert it: a 3 s countdown, then
        ``window_size`` frames paced over ``acquisition_time``: frames with
        a pose (skeleton, hybrid) or every frame (rgb, whose frames must
        each hold a crop, as in the JAX package)."""
        requires_focus = "-focus" in flag
        flag = flag[0]

        deadline = self.clock() + 3
        while self.clock() < deadline:
            self.get_frame(log="WAIT...")
        self.get_frame(log="GO!")

        data = []
        off_time = self.acquisition_time / self.window_size
        while len(data) < self.window_size:
            start = self.clock()
            res = self.get_frame(
                log="{:.2f}%".format((len(data) / (self.window_size - 1)) * 100)
            )
            good = (self.input_type in ("skeleton", "hybrid")
                    and res.get("pose") is not None) or self.input_type == "rgb"
            if good:
                sample = {}
                if self.input_type in ("skeleton", "hybrid"):
                    sample["poses"] = res["pose"].reshape(-1)
                if self.input_type in ("rgb", "hybrid"):
                    sample["imgs"] = res["img_preprocessed"]
                data.append(sample)
            while self.clock() - start < off_time:  # pacing
                time.sleep(0.001)

        inp = {"flag": flag, "data": {}, "requires_focus": requires_focus}
        for key in data[0]:
            inp["data"][key] = np.stack([s[key] for s in data])
        self.ar.train(inp)
        self._refresh_support()
        return "Action " + flag + " learned successfully!"

    def forget_command(self, flag: str) -> str:
        if self.ar.remove(flag):
            self._refresh_support()
            return f"Action {flag} removed"
        return f"Action {flag} is not in the support set"

    def save(self) -> str:
        path = self.ar.save_support_set(self.save_dir)
        return "Classes saved successfully in " + os.path.join(path, "support_set.npz")

    def load(self) -> str:
        n = self.ar.load_support_set(self.save_dir)
        self._refresh_support()
        return f"Loaded {n} classes"

    def debug(self) -> Dict[str, Any]:
        """Support-set summary, headless: the raw arrays for a frontend to render."""
        return {
            "classes": self.ar._live_classes(),
            "requires_focus": dict(self.ar.requires_focus),
            "support_data": {k: v.copy() for k, v in self.ar.support_data.items()},
            "mask": self.ar.support_mask.copy(),
        }
