"""Typed configuration for the PyTorch port.

A copy of the fields of ``isbfsar_tpu/configs.py`` that the ported slice
reads (I420 or BGR frame -> pose -> TRX match -> focus, the serving layer
around it, and the recognizer's trainer and evaluators), with the same
defaults. The port keeps its own copy so it imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

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
    """Orchestrator settings: the camera, and the acquisition of a new action
    (``window_size`` good frames paced over ``acquisition_time`` seconds)."""

    input_type: str = DEFAULT_INPUT_TYPE
    cam_width: int = 640
    cam_height: int = 480
    window_size: int = seq_len_for(DEFAULT_INPUT_TYPE)
    skeleton_scale: float = 2200.0
    acquisition_time: float = 3.0  # seconds

    @staticmethod
    def for_input(input_type: str) -> "MainConfig":
        return MainConfig(input_type=input_type, window_size=seq_len_for(input_type))


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
    # None: the full 122-joint pose (the offline extraction stores it)
    skeleton: Optional[str] = DEFAULT_SKELETON
    yolo_thresh: float = 0.3
    nms_thresh: float = 0.7
    num_aug: int = 0  # test-time augmentations; 0 disables
    # "mean": the visibility-weighted mean over the unflipped augmentations;
    # "aug0": the reference's pick of augmentation 0
    tta_aggregate: str = "mean"
    just_box: bool = False  # rgb mode: only the person box is needed
    yolo_input_size: int = 256
    crop_size: int = 256
    max_detections: int = 64  # ops/nms.py::postprocess_yolo's capacity
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
    rgb_size: int = 224  # AR rgb crop side
    trans_linear_out_dim: int = 128
    temp_set: Tuple[int, ...] = (2,)
    pe_scale_factor: float = 0.1
    smooth_poses: bool = True
    # episodes and the transformer's dropout
    shot: int = 1
    query_per_class: int = 1
    trans_dropout: float = 0.0
    # training (train/trainer.py)
    initial_lr: float = 1e-2
    n_task: int = 10000
    optimize_every: int = 1
    batch_size: int = 32
    n_epochs: int = 10000
    start_discriminator_after_epoch: int = 0
    first_milestone: int = 10000
    second_milestone: int = 10000
    eval_every_n_epoch: int = 10
    checkpoint_dir: Optional[str] = None
    ckpt_backend: str = "msgpack"  # the port writes msgpack only
    data_path: Optional[str] = None
    compute_dtype: str = "float32"
    remat: bool = False  # per-block rematerialization of the rgb extractor in training
    # open-set accept threshold for the live display; train/fsos.py::
    # calibrate_os_threshold picks one on training classes
    os_threshold: float = 0.66

    @property
    def trans_linear_in_dim(self) -> int:
        return 512 if self.input_type == "hybrid" else 256

    @staticmethod
    def for_input(input_type: str, **kw) -> "ARConfig":
        lr = 1e-2 if input_type == "skeleton" else 3e-4
        return ARConfig(input_type=input_type, seq_len=seq_len_for(input_type), initial_lr=lr,
                        **kw)


@dataclasses.dataclass(frozen=True)
class FocusConfig:
    """Gaze-based focus detection. The nets have fixed widths; only the
    gaze crop size and the compute type vary."""

    area_thr: float = 0.03  # face bbox area fraction above which the human is "close"
    close_thr: float = -0.95  # close: normalized gaze z below this is focus
    dist_thr: float = 0.3  # far: |normalized head rot y| under this is focus
    foc_rot_thr: float = 0.7  # close: |head yaw rotvec| above this is not focus
    patience: int = 3  # majority vote over the last N observations
    gaze_image_size: int = 224
    normalized_camera_distance: float = 0.6
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    main: MainConfig = dataclasses.field(default_factory=MainConfig)
    intrinsics: CameraIntrinsics = dataclasses.field(default_factory=CameraIntrinsics)
    hpe: HPEConfig = dataclasses.field(default_factory=HPEConfig)
    ar: ARConfig = dataclasses.field(default_factory=ARConfig)
    focus: FocusConfig = dataclasses.field(default_factory=FocusConfig)
    # Storage dtype of the two conv trunks (YOLO and EfficientNetV2); the
    # decode heads, BatchNorm statistics and the TRX stay float32.
    param_dtype: str = "bfloat16"

    @staticmethod
    def for_input(input_type: str) -> "PipelineConfig":
        return PipelineConfig(
            main=MainConfig.for_input(input_type),
            hpe=HPEConfig(just_box=(input_type == "rgb")),
            ar=ARConfig.for_input(input_type),
        )
