"""Shared set-up of the focus-alternative detector tests
(``tests/test_torch_mutual.py``, ``test_torch_head_pose_detector.py``):
the frames, JAX's head crop read from inside its jitted ``_forward_impl``,
and the bf16 rule.

:func:`jax_crops` swaps ``isbfsar_tpu.ops.image.square_box_crop_gather``
(which the JAX detectors import when their program is traced) for a
wrapper that hands the crop and its box to the host through
``jax.debug.callback``, so the crop read is the one XLA computed inside the
detector's own program, with whatever it fused there. The tests check that
the wrapper leaves the program's outputs bit-equal.

bf16: XLA and oneDNN round bf16 activations in other places, so each stage
of a bf16 run is held to JAX's float32 run within ``BF16_RATIO`` times
JAX's own bf16 error there (ROADMAP, "bf16 focus nets"), and a decision
(the best anchor, ``watching``, a score gate) must equal JAX's float32
decision wherever JAX's float32 value lies farther from its gate than that
error allows.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import isbfsar_tpu.ops.image as jimage
from isbfsar_tpu_torch.ops.image import i420_to_bgr

BF16_RATIO = 1.5


def frames(n_random: int = 3, n_faces: int = 2) -> list:
    """120x160 random frames and 240x320 face frames (the committed
    ``focus_frames.npz``, decoded and rounded), uint8 BGR."""
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(n_random)]
    data = np.load("isbfsar_tpu_torch/assets/focus_frames.npz")
    for yuv in data["i420_240"][:n_faces]:
        bgr = i420_to_bgr(torch.from_numpy(yuv.copy()), 240).numpy()
        out.append(np.clip(np.rint(bgr), 0, 255).astype(np.uint8))
    return out


@contextlib.contextmanager
def jax_crops():
    """Within the block, JAX detectors traced for the first time append
    (crop, box) of every call to the yielded list."""
    seen = []
    original = jimage.square_box_crop_gather

    def spy(frame, box, size):
        crop = original(frame, box, size)
        jax.debug.callback(lambda c, b: seen.append((np.asarray(c), np.asarray(b))), crop,
                           jnp.stack(box))
        return crop

    jimage.square_box_crop_gather = spy
    try:
        yield seen
    finally:
        jimage.square_box_crop_gather = original


def perturbed(variables, seed: int):
    """JAX's init (numpy leaves) with random BatchNorm statistics, scales
    and biases, so that every normalization moves its input."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("scale", "bias") and a.ndim == 1:
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def crop_batch(crops: list, n: int = 32) -> np.ndarray:
    """The crops (BGR) as RGB / 255, topped up with seeded random crops to
    ``n``: a crop net's bf16 error over a few crops alone swings by tens of
    percent between draws, over 32 by a few."""
    rgb = [c[..., ::-1] / 255.0 for c in crops]
    rng = np.random.default_rng(7)
    rgb += list(rng.uniform(0, 1, (n - len(rgb),) + rgb[0].shape))
    return np.ascontiguousarray(np.stack(rgb), np.float32)


def max_err(a: list, b: list) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def mean_err(a: list, b: list) -> float:
    return float(np.mean([np.mean(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)))
                          for x, y in zip(a, b)]))


def check_bf16(port16: list, jax16: list, jax32: list, what: str) -> None:
    """The port's bf16 outputs within BF16_RATIO times JAX's own bf16
    error, against JAX's float32, at the largest difference and on the mean."""
    for err in (max_err, mean_err):
        got, own = err(port16, jax32), err(jax16, jax32)
        assert got <= BF16_RATIO * own, (what, err.__name__, got, own)


def top2_margin(scores: np.ndarray) -> float:
    s = np.sort(np.asarray(scores).ravel())
    return float(s[-1] - s[-2])
