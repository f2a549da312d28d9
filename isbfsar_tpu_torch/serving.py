"""Multi-stream serving: S independent camera streams on one card (port of
``isbfsar_tpu/serving.py``).

Every stream shares the nets and the support set (one support-set edit
updates all streams); each has its own feature window, ring fill count
and One-Euro filter (none in rgb mode, whose state carries an empty
``smooth``). The JAX package shards the stream axis over a device
mesh; on one GPU the stream axis is a batch axis of one step: the nets run
on the S*B frames at once and the recurrences run per stream
(``FusedPipeline._step_batch_impl`` with a state of leading axis S). On the
card each (S, B) is one CUDA graph over this object's static buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.configs import PipelineConfig
from isbfsar_tpu_torch.pipeline import FusedPipeline, _StaticSteps, _StepGraph
from isbfsar_tpu_torch.utils.transfer import HostCopy


class MultiStreamPipeline(_StaticSteps):
    """S independent streams of the fused pipeline, in its input type."""

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        n_streams: int = 8,
        pipe: Optional[FusedPipeline] = None,
        with_focus: bool = True,
        input_format: str = "bgr",
        device: str = "cuda",
    ):
        """pipe: the FusedPipeline whose nets, support set and input format
        the streams share (built from the other arguments when None); its
        ``cuda_graphs`` decides whether the streams' steps are graphed."""
        self.pipe = pipe or FusedPipeline(config, with_focus=with_focus,
                                          input_format=input_format, device=device)
        self.n_streams = n_streams
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._state = None  # StreamState with a leading stream axis
        self._support_kv = None
        self._support_mask = None

    # ------------------------------------------------------------- lifecycle

    def _support(self) -> Dict[str, Any]:
        """Copies of the pipe's support K/V and mask, as of its last start()."""
        s_k, s_v = self.pipe._support_kv
        return {"_support_kv": (s_k.clone(), s_v.clone()),
                "_support_mask": self.pipe._support_mask.clone()}

    @torch.inference_mode()
    def start(self) -> None:
        """Fresh states for every stream and the support set's K/V."""
        self.pipe.start()
        self._assign(_state=self.pipe.init_state(lead=(self.n_streams,)), **self._support())

    @torch.inference_mode()
    def refresh_support(self) -> None:
        """Take the recognizer's support set after an edit (``ar.train`` /
        ``remove`` / ``load_support_set`` do not reach the streams on their
        own). The streams' states are kept: only the match target changes."""
        if self._support_mask is None:
            raise RuntimeError("refresh_support before start")
        self.pipe.start()
        self._assign(**self._support())

    # ------------------------------------------------------------- stepping

    def _enqueue(self, frames: np.ndarray) -> torch.Tensor:
        """(S, B, *frame_shape) -> (S, B, size) rows; each (S, B) its own graph."""
        if frames.shape[0] != self.n_streams:
            raise ValueError(f"want frames for {self.n_streams} streams, got {frames.shape[0]}")
        return super()._enqueue(frames, frames.shape[:2])

    @torch.inference_mode()
    def dispatch(self, frames: np.ndarray) -> HostCopy:
        """Enqueue one (S, *frame_shape) tick; the token's rows are the streams'."""
        return HostCopy(self._enqueue(np.asarray(frames)[:, None])[:, 0])

    def fetch(self, token: HostCopy) -> List[Dict[str, np.ndarray]]:
        """One host copy for all S streams' packed vectors."""
        return [self.pipe.layout.unpack(row) for row in token.numpy()]

    def step(self, frames: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """frames: (S, *frame_shape), one frame per stream, synchronous."""
        return self.fetch(self.dispatch(frames))

    def stream(self, ticks) -> Iterator[List[Dict[str, np.ndarray]]]:
        """Double-buffered: tick i is enqueued before tick i-1 is read."""
        pending = None
        for frames in ticks:
            token = self.dispatch(frames)
            if pending is not None:
                yield self.fetch(pending)
            pending = token
        if pending is not None:
            yield self.fetch(pending)

    @torch.inference_mode()
    def dispatch_batch(self, frames: np.ndarray) -> HostCopy:
        """Enqueue (S, B, *frame_shape): B consecutive frames per stream in
        one step; the token holds (S, B, size) rows."""
        return HostCopy(self._enqueue(np.asarray(frames)))

    def stream_batched(self, ticks, batch_size: int = 8) -> Iterator[List[Dict[str, np.ndarray]]]:
        """Micro-batched and double-buffered: ``batch_size`` ticks make one
        (S, B) step. Yields per-tick lists of S output dicts, as ``stream``;
        a partial tail runs as single-tick steps."""
        buf: list = []
        pending = None

        def drain(token):
            rows = token.numpy()  # (S, B, size)
            for b in range(rows.shape[1]):
                yield [self.pipe.layout.unpack(rows[s, b]) for s in range(rows.shape[0])]

        for frames in ticks:
            buf.append(frames)
            if len(buf) == batch_size:
                token = self.dispatch_batch(np.stack(buf, axis=1))
                buf = []
                if pending is not None:
                    yield from drain(pending)
                pending = token
        if pending is not None:
            yield from drain(pending)
        for frames in buf:
            yield self.step(frames)

    def decode(self, outputs: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return self.pipe.decode(outputs)
