"""Multi-stream serving: S independent camera streams on one card (port of
``isbfsar_tpu/serving.py``).

Every stream shares the nets and the support set (one support-set edit
updates all streams); each has its own feature window, ring fill count
and One-Euro filter (none in rgb mode, whose state carries an empty
``smooth``). On one device the stream axis is a batch axis of one step:
the nets run on the S*B frames at once and the recurrences run per stream
(``FusedPipeline._step_batch_impl`` with a state of leading axis S). On the
card each (S, B) is one CUDA graph over this object's static buffers.

Over a ``mesh`` (``parallel/mesh.py``, one rank per device, as JAX's
stream axis sharded over ``dp``) each dp rank steps its n_streams/dp
streams on its own device, keeping its rows of every full (S, ...) tick it
is given, and the packed rows of all S streams are all-gathered over dp
once per dispatch, so ``fetch`` returns every stream's outputs on every
rank, JAX's single-controller view. ``way_axis`` names a second mesh axis
over which the support set's classes are split: each rank of it embeds
and holds way/n classes' features and K/V (the shared pipe's whole-set
K/V is never built), and its step writes each window's logits over them and
the open-set decision of its best class into a buffer; after the step (a
graph replay on the card) one all-gather over ``way_axis`` carries them,
and the winning class's owner's decision and the softmax over all the
logits are written into the packed rows. The graph keeps the local step,
and the gather and that tail run after it, eagerly, on the graphed step's
output (gloo cannot be captured).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

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
        mesh=None,
        way_axis: Optional[str] = None,
    ):
        """pipe: the FusedPipeline whose nets, support set and input format
        the streams share (built from the other arguments when None); its
        ``cuda_graphs`` decides whether the streams' steps are graphed.
        mesh: a DeviceMesh with a ``dp`` axis over which the streams split
        (None: all on this device); way_axis: a second axis of it over which
        the support set's classes split."""
        self.pipe = pipe or FusedPipeline(config, with_focus=with_focus,
                                          input_format=input_format, device=device)
        self.n_streams = n_streams
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._state = None  # StreamState with a leading stream axis
        self._support_kv = None
        self._support_mask = None
        self.mesh = mesh
        self.streams = slice(0, n_streams)  # this rank's streams
        self._dp_group = self._way_group = None
        if mesh is None and way_axis is not None:
            raise ValueError("way_axis needs a mesh that has that axis")
        if mesh is not None:
            axes = tuple(mesh.mesh_dim_names)
            if "dp" not in axes or (way_axis is not None and way_axis not in axes):
                raise ValueError(f"mesh axes {axes} lack 'dp' or way_axis={way_axis!r}")
            dp = mesh.size(axes.index("dp"))
            if n_streams % dp:
                raise ValueError(f"n_streams ({n_streams}) must be a multiple of the mesh's "
                                 f"dp extent ({dp})")
            lo = mesh.get_local_rank("dp") * (n_streams // dp)
            self.streams = slice(lo, lo + n_streams // dp)
            self._dp_group, self._dp = mesh.get_group("dp"), dp
        if way_axis is not None:
            n_way, way = mesh.size(axes.index(way_axis)), self.pipe.config.ar.way
            if way % n_way:
                raise ValueError(f"way ({way}) must be a multiple of the mesh's {way_axis} "
                                 f"extent ({n_way}); pad ARConfig.way (masked slots are free)")
            self._way_group, self._n_way, self._per = mesh.get_group(way_axis), n_way, way // n_way
            lo = mesh.get_local_rank(way_axis) * self._per
            self.classes = slice(lo, lo + self._per)
            self._way_rows: Dict[int, torch.Tensor] = {}  # per window count: logits, decision

    @property
    def _match(self):
        """The step's match hook (a bound method made on each read: storing
        one would make a reference cycle that keeps graphs alive)."""
        return self._local_match if self._way_group is not None else None

    # ------------------------------------------------------------- lifecycle

    def _support(self) -> Dict[str, Any]:
        """The support K/V of the recognizer's current support set and its
        whole mask: copies of the pipe's after its start(), or under
        way_axis this rank's classes alone, embedded here."""
        pipe = self.pipe
        if self._way_group is None:
            pipe.start()
            s_k, s_v = pipe._support_kv
            return {"_support_kv": (s_k.clone(), s_v.clone()),
                    "_support_mask": pipe._support_mask.clone()}
        pipe._params()
        ar, cfg = pipe.ar, pipe.config.ar
        if ar.support_mask.any():
            features = ar.embed_support(self.classes)
        else:
            features = torch.zeros((self._per, cfg.seq_len, cfg.trans_linear_in_dim),
                                   device=pipe.device)
        s_k, s_v = ar.model.support_kv(features[None])
        return {"_support_kv": (s_k[0], s_v[0]),
                "_support_mask": torch.from_numpy(ar.support_mask.copy()).to(pipe.device)}

    @torch.inference_mode()
    def start(self) -> None:
        """Fresh states for this rank's streams and the support set's K/V."""
        n = self.streams.stop - self.streams.start
        self._assign(_state=self.pipe.init_state(lead=(n,)), **self._support())

    # ------------------------------------------------------ way sharding

    def _local_match(self, model, windows, support_mask, s_k, s_v):
        """The step's match under way_axis: each window's logits over this
        rank's classes and its best class's decision, into a buffer that
        :meth:`_finish_match` gathers; placeholders for the packed fields."""
        n = windows.shape[0]
        mask = support_mask[self.classes]
        out = model.match_features(windows, mask.expand(n, -1), s_k.expand(n, *s_k.shape),
                                   s_v.expand(n, *s_v.shape))
        rows = torch.cat([out["logits"], out["is_true"][:, :1].to(out["logits"].dtype)], dim=1)
        buf = self._way_rows.get(n)
        if buf is None:  # made on the shape's first, eager step, before any capture
            buf = self._way_rows[n] = torch.empty_like(rows)
        buf.copy_(rows)
        return (torch.zeros((n, self.pipe.config.ar.way), device=windows.device),
                torch.zeros((n,), device=windows.device))

    def _finish_match(self, packed: torch.Tensor) -> None:
        """Gather every class's logits over way_axis, and write the softmax
        and the winning class's owner's decision into the packed rows."""
        flat = packed.reshape(-1, packed.shape[-1])
        rows = self._way_rows[flat.shape[0]]
        parts = [torch.empty_like(rows) for _ in range(self._n_way)]
        dist.all_gather(parts, rows.contiguous(), group=self._way_group)
        parts = torch.stack(parts)  # (n_way, n, per + 1)
        logits = parts[..., :-1].permute(1, 0, 2).reshape(flat.shape[0], -1)
        owner = logits.argmax(dim=1) // self._per
        decision = parts[owner, torch.arange(flat.shape[0], device=flat.device), -1]
        start, end, _ = self.pipe.layout.specs["probs"]
        flat[:, start:end] = torch.softmax(logits, dim=-1)
        start, end, _ = self.pipe.layout.specs["is_true"]
        flat[:, start:end] = decision[:, None].to(flat.dtype)

    @torch.inference_mode()
    def refresh_support(self) -> None:
        """Take the recognizer's support set after an edit (``ar.train`` /
        ``remove`` / ``load_support_set`` do not reach the streams on their
        own). The streams' states are kept: only the match target changes."""
        if self._support_mask is None:
            raise RuntimeError("refresh_support before start")
        self._assign(**self._support())

    # ------------------------------------------------------------- stepping

    def _enqueue(self, frames: np.ndarray) -> torch.Tensor:
        """(S, B, *frame_shape) -> (S, B, size) rows; each (S, B) its own graph.
        Over a mesh this rank steps its streams' rows and gathers the rest."""
        if frames.shape[0] != self.n_streams:
            raise ValueError(f"want frames for {self.n_streams} streams, got {frames.shape[0]}")
        local = frames[self.streams]
        packed = super()._enqueue(local, local.shape[:2])
        if self._way_group is not None:
            self._finish_match(packed)
        if self._dp_group is None:
            return packed
        parts = [torch.empty_like(packed) for _ in range(self._dp)]
        dist.all_gather(parts, packed.contiguous(), group=self._dp_group)
        return torch.cat(parts)

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
