"""FusedPipeline, skeleton mode without focus, I420 input (port of
``isbfsar_tpu/pipeline.py``).

Per frame:

    I420 decode + YOLO input (the CUDA kernel of ops/fused_input.py) ->
    YOLO -> person pick -> virtual camera -> crop warp -> backbone ->
    heatmap head -> soft-argmax -> absolute reconstruction -> joint
    mapping -> root-centering -> One-Euro smoothing -> skeleton embed ->
    feature-ring push -> TRX match vs the cached support K/V ->
    softmax scores + open-set decision -> one packed float32 vector.

The JAX package runs one frame in ``_step_impl`` and vmaps it in
``_step_batch_impl``; here both are the same batched code, the per-frame
step being a batch of one. The recurrent parts (smoothing and the feature
ring) run frame by frame inside the batch, as the JAX scans do, so a
batched step equals the sequence of per-frame steps.

Geometry and reconstruction need full float32 matrix products (the JAX code
pins ``Precision.HIGHEST``), so the constructor turns TF32 off for matmuls
and cuDNN convolutions. It is process-wide PyTorch state.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.configs import PipelineConfig
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.layers import BatchNorm
from isbfsar_tpu_torch.ops.fused_input import fused_i420_inputs
from isbfsar_tpu_torch.ops.smooth import one_euro_gated_state, one_euro_gated_step


class StreamState(NamedTuple):
    """Device-resident recurrent state threaded through the step."""

    window: torch.Tensor  # (seq_len, trans_linear_in_dim) per-frame feature ring
    n_valid: torch.Tensor  # () int32 — filled frames in the window
    smooth: Any = ()  # One-Euro state dict when ARConfig.smooth_poses


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


def pin_float32_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class FusedPipeline:
    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        hpe: Optional[HumanPoseEstimator] = None,
        ar: Optional[ActionRecognizer] = None,
        with_focus: bool = False,
        input_format: str = "i420",
        device: str = "cuda",
    ):
        self.config = config or PipelineConfig()
        if with_focus:
            raise NotImplementedError("focus is not ported yet")
        if input_format != "i420":
            raise NotImplementedError("the port takes I420 frames only")
        if self.config.main.input_type != "skeleton":
            raise NotImplementedError("the port runs skeleton mode only")
        pin_float32_matmul()
        self.device = torch.device(device)
        cam_shape = (self.config.main.cam_height, self.config.main.cam_width)
        self.hpe = hpe or HumanPoseEstimator(self.config.hpe, self.config.intrinsics,
                                             frame_shape=cam_shape, device=device)
        self.ar = ar or ActionRecognizer(self.config.ar, device=device)
        cfg = self.config.ar
        self.layout = _Layout({
            "pose": (cfg.n_joints, 3),
            "pose_abs": (cfg.n_joints, 3),
            "bbox": (4,),
            "conf": (),
            "pose_ok": (),
            "distance": (),
            "probs": (cfg.way,),
            "is_true": (),
            "ar_ready": (),
        })

    # -------------------------------------------------------------- factory

    def init_state(self) -> StreamState:
        cfg = self.config.ar
        smooth = one_euro_gated_state((cfg.n_joints, 3), self.device) if cfg.smooth_poses else ()
        return StreamState(
            window=torch.zeros((cfg.seq_len, cfg.trans_linear_in_dim), device=self.device),
            n_valid=torch.zeros((), dtype=torch.int32, device=self.device),
            smooth=smooth,
        )

    def _params(self) -> Dict[str, Any]:
        nets = self.hpe.nets
        if self.config.param_dtype != "float32":
            nets = _cast_trunk_params(nets, getattr(torch, self.config.param_dtype))
        return {"hpe": nets, "ar": self.ar.model}

    # ------------------------------------------------------------ the step

    def _decode_frame(self, frames: torch.Tensor):
        """(B, H*3/2, W) uint8 I420 -> ((B, H, W, 3) BGR, (B, 1, S, S, 3) YOLO input).
        On CUDA this launches the fused kernel; on CPU it runs its plain version."""
        return fused_i420_inputs(frames, self.hpe.frame_shape[0], self.hpe.config.yolo_input_size)

    @torch.inference_mode()
    def _step_batch_impl(self, params, frames, support_kv, state: StreamState, support_mask):
        """B frames -> ((B, layout.size) packed float32, new state)."""
        cfg = self.config.ar
        b = frames.shape[0]
        frames, yolo_in = self._decode_frame(frames)
        pose, bbox, conf, found, visible = self.hpe._estimate_impl(params["hpe"], frames, yolo_in)
        pose_ok = found & visible

        distance = torch.linalg.norm(pose[:, 0], dim=-1) * 2.5
        rel_pose = pose - pose[:, :1]

        # causal pose smoothing before the batched embedding: good frames
        # tick the filter, no-detection frames leave it untouched
        smooth_state = state.smooth
        if cfg.smooth_poses:
            smoothed = []
            for i in range(b):
                smooth_state, r = one_euro_gated_step(smooth_state, rel_pose[i], pose_ok[i])
                smoothed.append(r)
            rel_pose = torch.stack(smoothed)

        features = params["ar"].embed_frame(rel_pose.reshape(b, -1))

        # ring recurrence, pushed only on good frames
        window, n_valid = state.window, state.n_valid
        windows, n_valids = [], []
        for i in range(b):
            pushed = torch.cat([window[1:], features[i:i + 1]], dim=0)
            window = torch.where(pose_ok[i], pushed, window)
            n_valid = torch.where(pose_ok[i], torch.clamp(n_valid + 1, max=cfg.seq_len), n_valid)
            windows.append(window)
            n_valids.append(n_valid)
        windows = torch.stack(windows)
        n_valids = torch.stack(n_valids)

        s_k, s_v = support_kv
        out = params["ar"].match_features(
            windows, support_mask.expand(b, -1), s_k.expand(b, *s_k.shape),
            s_v.expand(b, *s_v.shape))
        probs = torch.softmax(out["logits"], dim=-1)
        is_true = out["is_true"][:, 0]
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
        new_state = StreamState(window=window, n_valid=n_valid, smooth=smooth_state)
        return self.layout.pack(values, b), new_state

    def _step_impl(self, params, frame, support_kv, state, support_mask):
        """One (H*3/2, W) frame -> ((layout.size,) packed, new state)."""
        packed, state = self._step_batch_impl(params, frame[None], support_kv, state, support_mask)
        return packed[0], state

    # ------------------------------------------------------------ host API

    @torch.inference_mode()
    def start(self) -> None:
        """Materialize support features, support K/V and state; call after
        support-set edits."""
        self._state = self.init_state()
        if self.ar.support_features is None and self.ar.support_mask.any():
            self.ar.support_features = self.ar.embed_support()
        elif self.ar.support_features is None:
            cfg = self.config.ar
            self.ar.support_features = torch.zeros(
                (cfg.way, cfg.seq_len, cfg.trans_linear_in_dim), device=self.device)
        s_k, s_v = self.ar.model.support_kv(self.ar.support_features[None])
        self._support_kv = (s_k[0], s_v[0])
        self._support_mask = torch.from_numpy(self.ar.support_mask.copy()).to(self.device)
        self._device_params = self._params()

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(self.device)

    def dispatch(self, frame: np.ndarray) -> torch.Tensor:
        """Enqueue one frame; returns the packed vector (on the device)."""
        packed, self._state = self._step_impl(
            self._device_params, self._upload(frame), self._support_kv, self._state,
            self._support_mask)
        return packed

    def step(self, frame: np.ndarray) -> Dict[str, np.ndarray]:
        """One frame, synchronous: dispatch then read the packed vector."""
        return self.fetch(self.dispatch(frame))

    def fetch(self, packed: torch.Tensor) -> Dict[str, np.ndarray]:
        """One device->host copy; host-side field slicing."""
        return self.layout.unpack(packed.cpu().numpy())

    def dispatch_batch(self, frames: np.ndarray) -> torch.Tensor:
        packed, self._state = self._step_batch_impl(
            self._device_params, self._upload(frames), self._support_kv, self._state,
            self._support_mask)
        return packed

    def stream_batched(self, frames: Iterable[np.ndarray],
                       batch_size: int = 8) -> Iterator[Dict[str, np.ndarray]]:
        """Micro-batched streaming: per-frame results, one device round trip
        per ``batch_size`` frames; batch i+1 is enqueued before batch i is
        read. A partial tail batch runs as single-frame steps."""
        buf: list = []
        pending: Optional[torch.Tensor] = None
        for frame in frames:
            buf.append(frame)
            if len(buf) == batch_size:
                packed = self.dispatch_batch(np.stack(buf))
                buf = []
                if pending is not None:
                    for row in pending.cpu().numpy():
                        yield self.layout.unpack(row)
                pending = packed
        if pending is not None:
            for row in pending.cpu().numpy():
                yield self.layout.unpack(row)
        for frame in buf:
            yield self.fetch(self.dispatch(frame))

    def decode(self, outputs: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Unpacked outputs -> the orchestrator's elements contract."""
        elements: Dict[str, Any] = {}
        if outputs["pose_ok"] > 0:
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
        return elements
