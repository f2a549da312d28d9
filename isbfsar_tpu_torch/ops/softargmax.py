"""Soft-argmax heatmap decoding (port of ``isbfsar_tpu/ops/softargmax.py``).

Layout contract: head logits (b, 8, 8, 288) in NHWC -> logits2d =
[..., :32], the remaining 256 channels reshape to (b, h, w, d=8, j=32).
The port's head emits NCHW; the estimator permutes back to NHWC first.
"""

from __future__ import annotations

from typing import Tuple

import torch


def split_head_logits(logits: torch.Tensor, n_joints: int = 32):
    """(b, h, w, 9*j) -> 2D logits (b, h, w, j) and 3D logits (b, h, w, d, j)."""
    b, h, w, c = logits.shape
    return logits[..., :n_joints], logits[..., n_joints:].reshape(
        b, h, w, (c - n_joints) // n_joints, n_joints)


def _axis_expectation(probs: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    coords = []
    for ax in axes:
        others = tuple(a for a in axes if a != ax)
        marginal = probs.sum(dim=others, keepdim=True)
        grid = torch.linspace(0.0, 1.0, probs.shape[ax], dtype=probs.dtype, device=probs.device)
        shape = [1] * probs.dim()
        shape[ax] = probs.shape[ax]
        coords.append((marginal * grid.reshape(shape)).sum(dim=axes))
    return torch.stack(coords, dim=-1)


def _joint_softmax(logits: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    m = logits.amax(dim=axes, keepdim=True)
    e = torch.exp(logits - m)
    return e / e.sum(dim=axes, keepdim=True)


def decode_heatmap3d(logits3d: torch.Tensor) -> torch.Tensor:
    """(b, h, w, d, j) -> (b, j, 3) coords in [0, 1], order (x, y, z)."""
    probs = _joint_softmax(logits3d.to(torch.float32), axes=(2, 1, 3))
    return _axis_expectation(probs, axes=(2, 1, 3))


def decode_heatmap2d(logits2d: torch.Tensor, scale: float = 255.0) -> torch.Tensor:
    """(b, h, w, j) -> (b, j, 2) pixel coords in [0, scale], order (x, y)."""
    probs = _joint_softmax(logits2d.to(torch.float32), axes=(2, 1))
    return _axis_expectation(probs, axes=(2, 1)) * scale
