"""Typed configuration for the PyTorch port.

A copy of the fields of ``isbfsar_tpu/configs.py`` that the ported slice
reads (I420 frame -> pose -> TRX match), with the same defaults. The port
keeps its own copy so it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

# The port reads the JAX package's data files by path and never copies them.
ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "isbfsar_tpu", "assets"
)

DEFAULT_INPUT_TYPE = "skeleton"
DEFAULT_SKELETON = "smpl+head_30"


def seq_len_for(input_type: str) -> int:
    """Sequence length per input mode."""
    return 16 if input_type == "skeleton" else 8


@dataclasses.dataclass(frozen=True)
class MainConfig:
    input_type: str = DEFAULT_INPUT_TYPE
    cam_width: int = 640
    cam_height: int = 480


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """RealSense D435i defaults."""

    fx: float = 384.025146484375
    fy: float = 384.025146484375
    ppx: float = 319.09661865234375
    ppy: float = 237.75723266601562
    width: int = 640
    height: int = 480

    def matrix(self) -> np.ndarray:
        k = np.zeros((3, 3), np.float32)
        k[0, 0] = self.fx
        k[0, 2] = self.ppx
        k[1, 1] = self.fy
        k[1, 2] = self.ppy
        k[2, 2] = 1.0
        return k


@dataclasses.dataclass(frozen=True)
class HPEConfig:
    skeleton: str = DEFAULT_SKELETON
    yolo_thresh: float = 0.3
    yolo_input_size: int = 256
    crop_size: int = 256
    expand_joints_path: str = os.path.join(ASSETS_DIR, "joints_32_to_122.npy")
    skeletons_path: str = os.path.join(ASSETS_DIR, "skeletons.npz")
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class ARConfig:
    model: str = "DISC"  # "DISC" | "EXP"
    input_type: str = DEFAULT_INPUT_TYPE
    way: int = 5
    n_joints: int = 30
    seq_len: int = seq_len_for(DEFAULT_INPUT_TYPE)
    trans_linear_out_dim: int = 128
    temp_set: Tuple[int, ...] = (2,)
    pe_scale_factor: float = 0.1
    smooth_poses: bool = True

    @property
    def trans_linear_in_dim(self) -> int:
        return 512 if self.input_type == "hybrid" else 256

    @staticmethod
    def for_input(input_type: str, **kw) -> "ARConfig":
        return ARConfig(input_type=input_type, seq_len=seq_len_for(input_type), **kw)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    main: MainConfig = dataclasses.field(default_factory=MainConfig)
    intrinsics: CameraIntrinsics = dataclasses.field(default_factory=CameraIntrinsics)
    hpe: HPEConfig = dataclasses.field(default_factory=HPEConfig)
    ar: ARConfig = dataclasses.field(default_factory=ARConfig)
    # Storage dtype of the two conv trunks (YOLO and EfficientNetV2); the
    # decode heads, BatchNorm statistics and the TRX stay float32.
    param_dtype: str = "bfloat16"
