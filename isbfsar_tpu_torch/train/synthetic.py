"""Synthetic episodic dataset (port of ``isbfsar_tpu/train/synthetic.py``).

:func:`generate_dataset` writes the tree the reference's NTU-RGBD
extraction writes, ``root/<class>/<clip>/{i}.npy`` with one (122, 3)
float32 root-relative pose per frame, with a class-specific sinusoid on
the joints so that training has signal to fit, and with ``with_images``
an ``{i}.png`` crop per frame: a grey background of the class's level and a
filled white circle that moves with the same sinusoid. The same seed
writes the same ``.npy`` files and the same pixels as the JAX package's
generator (which draws the circle with cv2 and writes with cv2).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from isbfsar_tpu_torch.utils.draw import circle
from isbfsar_tpu_torch.utils.png import write_png

MODALITY_KEYS = {"skeleton": ("sk",), "rgb": ("rgb",), "hybrid": ("rgb", "sk")}


def generate_dataset(
    root: str,
    n_classes: int = 8,
    clips_per_class: int = 4,
    n_frames: int = 16,
    n_joints: int = 122,
    with_images: bool = False,
    image_size: int = 224,
    seed: int = 0,
    class_names: Optional[list] = None,
) -> list:
    """Create root/<class>/<clip>/{i}.npy (and {i}.png with ``with_images``).
    Returns the class names."""
    rng = np.random.default_rng(seed)
    names = class_names or [f"action_{c:02d}" for c in range(n_classes)]
    base_pose = rng.normal(0, 0.3, (n_joints, 3)).astype(np.float32)

    for c, name in enumerate(names):
        freq = 0.5 + 0.45 * c
        joint_gain = rng.normal(0, 1, (n_joints, 3)).astype(np.float32)
        for clip in range(clips_per_class):
            clip_dir = os.path.join(root, name, str(clip))
            os.makedirs(clip_dir, exist_ok=True)
            phase = rng.uniform(0, 2 * np.pi)
            noise = rng.normal(0, 0.02, (n_frames, n_joints, 3)).astype(np.float32)
            for i in range(n_frames):
                t = i / n_frames
                pose = base_pose + 0.2 * joint_gain * np.sin(
                    2 * np.pi * freq * t + phase
                ) + noise[i]
                np.save(os.path.join(clip_dir, f"{i}.npy"), pose.astype(np.float32))
                if with_images:  # draws nothing from rng
                    img = np.full((image_size, image_size, 3), 30 * (c + 1) % 255, np.uint8)
                    cx = int((0.5 + 0.3 * np.sin(2 * np.pi * freq * t + phase)) * image_size)
                    circle(img, (cx, image_size // 2), image_size // 8, 255)
                    write_png(os.path.join(clip_dir, f"{i}.png"), img)
    return names


def episodic_batch(cfg, batch_size: int, rgb_size: int, modality: str, seed: int = 0):
    """One deterministic synthetic episodic batch in the data loader's
    layout (train/dataloader.py::batch_iterator)."""
    rng = np.random.default_rng(seed)
    b, way, L = batch_size, cfg.way, cfg.seq_len
    shapes = {"sk": (cfg.n_joints * 3,), "rgb": (rgb_size, rgb_size, 3)}
    keys = MODALITY_KEYS[modality]

    def clipset(lead):
        return {m: rng.normal(size=lead + (L,) + shapes[m]).astype(np.float32)
                for m in keys}

    return {
        "support_set": clipset((b, way)),
        "target_set": clipset((b,)),
        "unknown_set": clipset((b,)),
        "support_classes": np.tile(np.arange(way, dtype=np.int32), (b, 1)),
        "target_class": np.zeros((b,), np.int32),
        "known": np.ones((b,), bool),
    }
