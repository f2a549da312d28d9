"""FusedPipeline in the three input modes, with focus, I420 or BGR input
(port of ``isbfsar_tpu/pipeline.py``).

Per frame:

    I420 decode + YOLO input (the CUDA kernel of ops/fused_input.py; BGR
    frames skip the decode and take the plain YOLO input, as in JAX) ->
    YOLO -> person pick -> virtual camera -> crop warp -> backbone ->
    heatmap head -> soft-argmax -> absolute reconstruction -> joint
    mapping -> root-centering -> One-Euro smoothing -> skeleton embed ->
    feature-ring push -> TRX match vs the cached support K/V ->
    softmax scores + open-set decision;
    focus on the unrounded float BGR frame (focus/detector.py: face
    detection, landmarks, head pose and the normalization camera by the
    CUDA kernel of ops/head_pose.py, the normalized crop, gaze) -> one
    packed float32 vector.

rgb and hybrid embed each frame with the ResNet-50 RGB extractor on a
square crop around the person box (``ops/image.py``: a gather from the
unrounded float BGR frame, then whitening), inside the same step; hybrid
concatenates it with the skeleton embedding. rgb with ``hpe.just_box``
(``PipelineConfig.for_input("rgb")``) runs the detector alone: no pose
(zeros in the packed vector, none published by ``decode``), a frame is
good when a person is found, and there is no smoothing.

The JAX package runs one frame in ``_step_impl`` and vmaps it in
``_step_batch_impl``; here ``_step_batch_impl`` does both, a per-frame step
being a batch of one. The recurrent parts (smoothing and the feature
ring) run frame by frame inside the batch, as the JAX scans do, so a
batched step equals the sequence of per-frame steps. A state with a
leading stream axis S (``init_state(lead=(S,))``) makes the same step run
S independent streams (``serving.MultiStreamPipeline``): the nets see the
S*B frames as one batch, and the recurrences run per stream.

The reference compiles the step into one program (``jax.jit``). Here, on
the card, each batch size's step is a CUDA graph: the frames, the
recurrent state, the support K/V and the support mask live in static
device buffers; the first step of a batch size runs eagerly (the warm-up,
which also builds the kernel's tables), then the step is captured, and
every later step copies its frames in through a pinned host buffer and
replays the graph, which writes the new state back into the state
buffers. ``start()`` copies a new support set and a fresh state into the
same buffers, so the graphs stay valid. ``cuda_graphs=False`` runs every
step eagerly instead, the oracle the graphs are held against; on the CPU
there are no graphs, and ``cuda_graphs=True`` runs the static-buffer step
eagerly.

``dispatch`` returns a :class:`~isbfsar_tpu_torch.utils.transfer.HostCopy`
token: the packed rows' copy to pinned host memory is enqueued right after
the step (straight from the graph's static output: stream order puts it
before the next replay), and ``fetch`` waits for that copy alone, so a
caller that dispatches frame i and then fetches frame i-1 does not wait
for frame i.

The convolutions and matmuls must run in full float32 where the JAX code
does (``Precision.HIGHEST``), so the constructor turns TF32 off for
matmuls and cuDNN convolutions. It is process-wide PyTorch state.

``with_focus=True`` is the default, as in the JAX package; the focus nets
keep their float32 weights whatever ``param_dtype`` says, as there.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.configs import PipelineConfig
from isbfsar_tpu_torch.focus.detector import FocusDetector
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.layers import BatchNorm, pin_float32_matmul
from isbfsar_tpu_torch.ops.fused_input import fused_i420_inputs
from isbfsar_tpu_torch.ops.head_pose import focus_geometry
from isbfsar_tpu_torch.ops.image import (ar_rgb_preprocess, center_square_crop_resize,
                                         yolo_preprocess)
from isbfsar_tpu_torch.ops.smooth import one_euro_gated_state, one_euro_gated_step
from isbfsar_tpu_torch.utils.transfer import HostCopy, to_device


class StreamState(NamedTuple):
    """Device-resident recurrent state threaded through the step."""

    window: torch.Tensor  # ([S,] seq_len, trans_linear_in_dim) per-frame feature ring
    n_valid: torch.Tensor  # ([S],) int32 — filled frames in the window
    smooth: Any = ()  # One-Euro state dict when ARConfig.smooth_poses, outside rgb mode


class _Layout:
    """Field -> slice map for the packed output vector."""

    def __init__(self, fields: Dict[str, Tuple[int, ...]]):
        self.specs = {}
        offset = 0
        for name, shape in fields.items():
            size = int(np.prod(shape)) if shape else 1
            self.specs[name] = (offset, offset + size, shape)
            offset += size
        self.size = offset

    def pack(self, values: Dict[str, torch.Tensor], batch: int) -> torch.Tensor:
        """Per-frame fields with a leading batch axis -> (batch, size) float32."""
        return torch.cat([values[name].to(torch.float32).reshape(batch, -1)
                          for name in self.specs], dim=1)

    def unpack(self, vec: np.ndarray) -> Dict[str, np.ndarray]:
        out = {}
        for name, (start, end, shape) in self.specs.items():
            v = vec[start:end]
            out[name] = v.reshape(shape) if shape else v[0]
        return out


# the hand kernels' wrappers, whose launch counts graph replays add to
KERNELS = (fused_i420_inputs, focus_geometry)

# the packed focus fields in the JAX order: (the detector output each holds, shape)
FOCUS_FIELDS = {
    "f_found": ("found", ()),
    "f_score": ("score", ()),
    "f_bbox": ("bbox", (4,)),
    "f_landmarks": ("landmarks", (6, 2)),
    "f_head_position": ("head_position", (3,)),
    "f_head_rotvec": ("head_rotvec", (3,)),
    "f_norm_head_rot2d": ("normalized_head_rot2d", (2,)),
    "f_gaze": ("gaze_vector", (3,)),
    "f_norm_gaze": ("normalized_gaze_vector", (3,)),
}


def _is_trunk(name: str) -> bool:
    """The weights ``PipelineConfig.param_dtype`` applies to: every float
    parameter of the YOLO and EfficientNetV2 trunks except the YOLO box
    outputs ``head*_out`` (BatchNorm statistics are buffers, not parameters)."""
    return not any(p.startswith("head") and p.endswith("_out") for p in name.split("."))


def _cast_trunk_params(nets: Dict[str, torch.nn.Module], dtype: torch.dtype):
    """Copies of the HPE nets with trunk weights stored in ``dtype``; the
    MetrABS head stays float32 (``isbfsar_tpu/pipeline.py:81-112``).
    BatchNorm scale and bias are rounded to ``dtype`` as in JAX but kept in
    float32 storage, the type ``F.batch_norm`` takes beside bf16 inputs."""
    out = dict(nets)
    for key in ("yolo", "bbone"):
        net = copy.deepcopy(nets[key])
        for mod_name, mod in net.named_modules():
            for name, p in mod.named_parameters(recurse=False):
                if _is_trunk(f"{mod_name}.{name}"):
                    p.data = p.data.to(dtype)
                    if isinstance(mod, BatchNorm):
                        p.data = p.data.to(torch.float32)
        out[key] = net
    return out


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class _StaticSteps:
    """The host side of a step over recurrent state and a support set: the
    object's ``_state``, ``_support_kv`` and ``_support_mask`` through
    ``pipe._step_batch_impl`` with ``pipe``'s nets. Eager, or with
    ``pipe.cuda_graphs`` one CUDA graph per input shape over static buffers,
    which ``_assign`` fills in place once they exist (the graphs hold their
    addresses)."""

    pipe: "FusedPipeline"
    _graphs: Dict[Any, "_StepGraph"]
    _state: Optional[StreamState]
    _support_kv: Any
    _support_mask: Optional[torch.Tensor]
    # the step's match of the windows against the support set, where it is
    # not the whole set on this device (serving.py, the way-sharded one)
    _match = None

    @torch.inference_mode()
    def _assign(self, **fresh) -> None:
        """Set the named buffers, in place once the static buffers exist."""
        static = self.pipe.cuda_graphs and self._support_mask is not None
        for name, value in fresh.items():
            if static:
                for dst, src in zip(_tensors(getattr(self, name)), _tensors(value), strict=True):
                    dst.copy_(src)
            else:
                setattr(self, name, value)

    @torch.inference_mode()
    def _enqueue(self, frames: np.ndarray, key) -> torch.Tensor:
        """Frames (with the state's leading stream axis, if any) -> packed
        rows on the device; ``key`` names the input shape's graph."""
        frames = np.asarray(frames, np.uint8)
        pipe = self.pipe
        if pipe.cuda_graphs:
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = _StepGraph(pipe.device, frames.shape)
            return graph.run(frames, self._graph_body)
        packed, self._state = pipe._step_batch_impl(
            pipe._device_params, to_device(frames, pipe.device), self._support_kv, self._state,
            self._support_mask, self._match)
        return packed

    def _graph_body(self, frames: torch.Tensor) -> torch.Tensor:
        """The step over the static buffers: writes the new state into them."""
        packed, new = self.pipe._step_batch_impl(self.pipe._device_params, frames,
                                                 self._support_kv, self._state,
                                                 self._support_mask, self._match)
        for dst, src in zip(_tensors(self._state), _tensors(new), strict=True):
            dst.copy_(src)
        return packed


class FusedPipeline(_StaticSteps):
    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        hpe: Optional[HumanPoseEstimator] = None,
        ar: Optional[ActionRecognizer] = None,
        focus: Optional[FocusDetector] = None,
        with_focus: bool = True,
        input_format: str = "i420",
        device: str = "cuda",
        cuda_graphs: Optional[bool] = None,
    ):
        """input_format: "i420" ((H*3/2, W) uint8 planar YUV, decoded on the
        card by the fused kernel) or "bgr" ((H, W, 3) uint8).
        cuda_graphs: replay each batch size's step as a CUDA graph over
        static buffers (the default on the card); False runs each step
        eagerly. On the CPU the default is the plain eager step, and True
        runs the static-buffer step eagerly."""
        self.config = config or PipelineConfig()
        if input_format not in ("i420", "bgr"):
            raise ValueError(f"input_format must be 'i420' or 'bgr', not {input_format!r}")
        self.input_format = input_format
        self.input_type = self.config.main.input_type
        pin_float32_matmul()
        self.device = torch.device(device)
        self.cuda_graphs = self.device.type == "cuda" if cuda_graphs is None else bool(cuda_graphs)
        self._device_params: Optional[Dict[str, Any]] = None  # the cast nets, made once
        self._support_mask: Optional[torch.Tensor] = None
        self._graphs: Dict[int, _StepGraph] = {}
        cam_shape = (self.config.main.cam_height, self.config.main.cam_width)
        self.hpe = hpe or HumanPoseEstimator(self.config.hpe, self.config.intrinsics,
                                             frame_shape=cam_shape, device=device)
        self.ar = ar or ActionRecognizer(self.config.ar, device=device)
        self.with_focus = with_focus
        self.focus = (focus or FocusDetector(self.config.focus, self.config.intrinsics,
                                             frame_shape=cam_shape, device=device)
                      ) if with_focus else None
        cfg = self.config.ar
        fields = {
            "pose": (cfg.n_joints, 3),
            "pose_abs": (cfg.n_joints, 3),
            "bbox": (4,),
            "conf": (),
            "pose_ok": (),
            "distance": (),
            "probs": (cfg.way,),
            "is_true": (),
            "ar_ready": (),
        }
        if with_focus:
            fields.update({name: shape for name, (_, shape) in FOCUS_FIELDS.items()})
        self.layout = _Layout(fields)

    # -------------------------------------------------------------- factory

    def init_state(self, lead: Tuple[int, ...] = ()) -> StreamState:
        """A fresh state; ``lead=(S,)`` gives S independent streams."""
        cfg = self.config.ar
        lead = tuple(lead)
        smooth = (one_euro_gated_state((cfg.n_joints, 3), self.device, lead)
                  if self._smooths() else ())
        return StreamState(
            window=torch.zeros(lead + (cfg.seq_len, cfg.trans_linear_in_dim), device=self.device),
            n_valid=torch.zeros(lead, dtype=torch.int32, device=self.device),
            smooth=smooth,
        )

    def _smooths(self) -> bool:
        """One-Euro smoothing of the pose: on by config, never in rgb mode
        (no pose feeds the recognizer there)."""
        return self.config.ar.smooth_poses and self.input_type != "rgb"

    def _detector_only(self) -> bool:
        """rgb with ``just_box``: the step runs YOLO and no pose chain."""
        return self.input_type == "rgb" and self.hpe.just_box

    def frame_shape(self) -> Tuple[int, ...]:
        """The shape of one input frame in this pipeline's format."""
        h, w = self.hpe.frame_shape
        return (h * 3 // 2, w) if self.input_format == "i420" else (h, w, 3)

    def _params(self) -> Dict[str, Any]:
        """The nets the step runs, cast once at the first ``start()``: a
        CUDA graph holds the addresses of the parameters it was captured with."""
        if self._device_params is None:
            nets = self.hpe.nets
            if self.config.param_dtype != "float32":
                nets = _cast_trunk_params(nets, getattr(torch, self.config.param_dtype))
            self._device_params = {"hpe": nets, "ar": self.ar.model}
            if self.with_focus:
                self._device_params["focus"] = self.focus.nets
        return self._device_params

    # ------------------------------------------------------------ the step

    def _decode_frame(self, frames: torch.Tensor):
        """(B, H*3/2, W) uint8 I420 or (B, H, W, 3) uint8 BGR -> ((B, H, W, 3)
        float BGR, (B, 1, S, S, 3) YOLO input). I420 on CUDA launches the
        fused kernel, on the CPU its plain version; BGR has no kernel, as in JAX."""
        size = self.hpe.config.yolo_input_size
        if self.input_format == "i420":
            return fused_i420_inputs(frames, self.hpe.frame_shape[0], size)
        frames = frames.to(torch.float32)
        return frames, yolo_preprocess(frames, size)

    @torch.inference_mode()
    def _step_batch_impl(self, params, frames, support_kv, state: StreamState, support_mask,
                         match=None):
        """B frames of one stream -> ((B, layout.size) packed float32, new
        state). With a state of S streams (a leading axis S), (S, B) frames
        -> ((S, B, layout.size), new state): the nets run on the S*B frames
        at once, the recurrences per stream. ``match(recognizer, windows,
        support_mask, s_k, s_v) -> (probs, is_true)`` replaces the match of
        the windows against the whole support set."""
        cfg = self.config.ar
        lead = tuple(state.n_valid.shape)
        t = len(lead)  # the time axis of the frames
        b = frames.shape[t]
        n = b * int(np.prod(lead, dtype=np.int64))
        frames, yolo_in = self._decode_frame(frames.reshape((n,) + frames.shape[t + 1:]))
        if self._detector_only():
            bbox, conf, found = self.hpe._box_impl(params["hpe"], frames, yolo_in)
            pose = torch.zeros((n, cfg.n_joints, 3), device=frames.device)
        else:
            pose, bbox, conf, found, visible = self.hpe._estimate_impl(params["hpe"], frames,
                                                                       yolo_in)
        # rgb gates on the detection alone; skeleton and hybrid also on the
        # joints in view
        pose_ok = found if self.input_type == "rgb" else found & visible

        distance = torch.linalg.norm(pose[:, 0], dim=-1) * 2.5
        rel_pose = pose - pose[:, :1]

        def per_stream(x):  # (n, ...) -> (*lead, b, ...)
            return x.reshape(lead + (b,) + x.shape[1:])

        ok = per_stream(pose_ok)
        # causal pose smoothing before the batched embedding: good frames
        # tick the filter, no-detection frames leave it untouched
        smooth_state = state.smooth
        if self._smooths():
            rel = per_stream(rel_pose)
            smoothed = []
            for i in range(b):
                smooth_state, r = one_euro_gated_step(smooth_state, rel.select(t, i), ok.select(t, i))
                smoothed.append(r)
            rel_pose = torch.stack(smoothed, dim=t).reshape(rel_pose.shape)

        kwargs = {}
        if self.input_type in ("skeleton", "hybrid"):
            kwargs["sk"] = rel_pose.reshape(n, -1)
        if self.input_type in ("rgb", "hybrid"):
            # the box is (x1, x2, y1, y2), the crop takes (x1, y1, x2, y2)
            box = (bbox[:, 0], bbox[:, 2], bbox[:, 1], bbox[:, 3])
            kwargs["rgb"] = ar_rgb_preprocess(center_square_crop_resize(frames, box, cfg.rgb_size))
        features = per_stream(params["ar"].embed_frame(**kwargs))

        # ring recurrence, pushed only on good frames
        window, n_valid = state.window, state.n_valid
        windows, n_valids = [], []
        for i in range(b):
            ok_i = ok.select(t, i)
            pushed = torch.cat([window[..., 1:, :], features.select(t, i).unsqueeze(-2)], dim=-2)
            window = torch.where(ok_i.reshape(ok_i.shape + (1, 1)), pushed, window)
            n_valid = torch.where(ok_i, torch.clamp(n_valid + 1, max=cfg.seq_len), n_valid)
            windows.append(window)
            n_valids.append(n_valid)
        windows = torch.stack(windows, dim=t).reshape((n,) + window.shape[t:])
        n_valids = torch.stack(n_valids, dim=t).reshape(n)

        s_k, s_v = support_kv
        if match is None:
            out = params["ar"].match_features(
                windows, support_mask.expand(n, -1), s_k.expand(n, *s_k.shape),
                s_v.expand(n, *s_v.shape))
            probs = torch.softmax(out["logits"], dim=-1)
            is_true = out["is_true"][:, 0]
        else:
            probs, is_true = match(params["ar"], windows, support_mask, s_k, s_v)
        ar_ready = (n_valids >= cfg.seq_len) & support_mask.any()
        values = {
            "pose": rel_pose,
            "pose_abs": pose,
            "bbox": bbox,
            "conf": conf,
            "pose_ok": pose_ok,
            "distance": distance,
            "probs": probs,
            "is_true": is_true,
            "ar_ready": ar_ready,
        }
        if self.with_focus:
            # the unrounded float frames: focus does not round, the estimator does
            f = self.focus._forward_impl(params["focus"], frames)
            values.update({name: f[key] for name, (key, _) in FOCUS_FIELDS.items()})
        new_state = StreamState(window=window, n_valid=n_valid, smooth=smooth_state)
        return self.layout.pack(values, n).reshape(lead + (b, self.layout.size)), new_state

    # ------------------------------------------------------------ host API

    @torch.inference_mode()
    def start(self) -> None:
        """Materialize support features, support K/V and state; call after
        support-set edits. With static buffers, copies them into the buffers."""
        if self.ar.support_features is None and self.ar.support_mask.any():
            self.ar.support_features = self.ar.embed_support()
        elif self.ar.support_features is None:
            cfg = self.config.ar
            self.ar.support_features = torch.zeros(
                (cfg.way, cfg.seq_len, cfg.trans_linear_in_dim), device=self.device)
        s_k, s_v = self.ar.model.support_kv(self.ar.support_features[None])
        mask = torch.from_numpy(self.ar.support_mask.copy()).to(self.device)
        self._assign(_state=self.init_state(), _support_kv=(s_k[0], s_v[0]), _support_mask=mask)
        self._params()

    @property
    def pipe(self) -> "FusedPipeline":
        """The pipeline whose step and nets run (itself; ``_StaticSteps``)."""
        return self

    @torch.inference_mode()
    def dispatch(self, frame: np.ndarray) -> HostCopy:
        """Enqueue one frame; returns the token of its packed vector's copy
        to the host, started right after the step."""
        return HostCopy(self._enqueue(frame[None], 1)[0])

    @torch.inference_mode()
    def dispatch_batch(self, frames: np.ndarray) -> HostCopy:
        """Enqueue B frames as one step; the token's rows are the frames'."""
        return HostCopy(self._enqueue(frames, len(frames)))

    def step(self, frame: np.ndarray) -> Dict[str, np.ndarray]:
        """One frame, synchronous: dispatch then read the packed vector."""
        return self.fetch(self.dispatch(frame))

    def fetch(self, token: HostCopy) -> Dict[str, np.ndarray]:
        """Wait for one dispatched frame's host copy; host-side field slicing."""
        return self.layout.unpack(token.numpy())

    def stream(self, frames: Iterable[np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
        """Double-buffered streaming: frame i+1 is enqueued before frame i is read."""
        pending = None
        for frame in frames:
            token = self.dispatch(frame)
            if pending is not None:
                yield self.fetch(pending)
            pending = token
        if pending is not None:
            yield self.fetch(pending)

    def stream_batched(self, frames: Iterable[np.ndarray],
                       batch_size: int = 8) -> Iterator[Dict[str, np.ndarray]]:
        """Micro-batched streaming: per-frame results, one device round trip
        per ``batch_size`` frames; batch i+1 is enqueued before batch i is
        read. A partial tail batch runs as single-frame steps."""
        buf: list = []
        pending: Optional[HostCopy] = None
        for frame in frames:
            buf.append(frame)
            if len(buf) == batch_size:
                token = self.dispatch_batch(np.stack(buf))
                buf = []
                if pending is not None:
                    for row in pending.numpy():
                        yield self.layout.unpack(row)
                pending = token
        if pending is not None:
            for row in pending.numpy():
                yield self.layout.unpack(row)
        for frame in buf:
            yield self.fetch(self.dispatch(frame))

    def warmup(self, n: int = 2) -> None:
        """``n`` steps on an empty frame (with graphs: the B=1 capture), then
        a fresh state: the dummy frames must not fill the live AR window."""
        dummy = np.zeros(self.frame_shape(), np.uint8)
        for _ in range(n):
            self.step(dummy)
        self._assign(_state=self.init_state())

    def decode(self, outputs: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Unpacked outputs -> the orchestrator's elements contract."""
        elements: Dict[str, Any] = {}
        if outputs["pose_ok"] > 0:
            if not self._detector_only():  # the detector alone has no pose to publish
                elements["pose"] = outputs["pose"]
                elements["distance"] = float(outputs["distance"])
                elements["edges"] = self.hpe.edges
            x1, x2, y1, y2 = (int(v) for v in outputs["bbox"])
            elements["bbox"] = (x1, x2, y1, y2)
        if outputs["ar_ready"] > 0 and outputs["pose_ok"] > 0:
            probs = outputs["probs"]
            elements["actions"] = {
                name: float(probs[i])
                for i, name in enumerate(self.ar.class_order)
                if self.ar.support_mask[i] and name is not None
            }
            elements["is_true"] = float(outputs["is_true"])
            elements["requires_focus"] = dict(self.ar.requires_focus)
        else:
            elements["actions"] = {}
            elements["is_true"] = 0
            elements["requires_focus"] = {}
        if self.with_focus and outputs["f_found"] > 0:
            focus_out = {key: outputs[name] for name, (key, _) in FOCUS_FIELDS.items()}
            res = self.focus.estimate_collect(focus_out)
            if res is not None:
                elements["focus"], face = res
                elements["face_bbox"] = face.bbox.reshape(-1)
        return elements


class _StepGraph:
    """A step at one input shape over static buffers.

    ``run`` copies the frames into this shape's static input, then runs
    ``body`` (static frames -> packed rows; it writes the new recurrent
    state into the owner's state buffers): eagerly on its first call and on
    the CPU, by replaying the CUDA graph captured right after that first
    call otherwise. A replay returns the graph's static output, which the
    next replay overwrites: the caller starts its host copy at once. The
    owner passes ``body`` on each call and this object keeps no reference
    to it, so an owner and its graphs form no cycle and are freed with it.
    """

    def __init__(self, device: torch.device, shape: Tuple[int, ...]):
        self.frames = torch.empty(shape, dtype=torch.uint8, device=device)
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.staging = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            self.uploaded = torch.cuda.Event()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches = {kernel: 0 for kernel in KERNELS}  # launches recorded in the graph

    def run(self, frames: np.ndarray, body) -> torch.Tensor:
        frames = np.ascontiguousarray(frames, np.uint8)
        if self.on_card:
            self.uploaded.synchronize()  # the previous upload has left the pinned buffer
            self.staging.numpy()[...] = frames
            self.frames.copy_(self.staging, non_blocking=True)
            self.uploaded.record()
        else:
            self.frames.copy_(torch.from_numpy(frames))
        if self.graph is not None:
            self.graph.replay()
            for kernel, n in self.launches.items():
                kernel.launches += n
            return self.out
        packed = body(self.frames)
        if self.on_card:
            self._capture(body)
        return packed

    def _capture(self, body) -> None:
        before = {kernel: kernel.launches for kernel in KERNELS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = body(self.frames)
        # capture records the launches and runs none of them
        for kernel, n in before.items():
            self.launches[kernel] = kernel.launches - n
            kernel.launches = n
        self.graph = graph
