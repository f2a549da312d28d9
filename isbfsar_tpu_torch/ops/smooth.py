"""Causal One-Euro pose smoothing, gated (port of the live-pipeline half of
``isbfsar_tpu/ops/smooth.py``: ``one_euro_gated_state`` / ``_step``).

    alpha(fc) = 1 / (1 + fs / (2*pi*fc))
    dx_hat    = EMA(dx, alpha(d_cutoff))
    fc        = min_cutoff + beta * |dx_hat|
    x_hat     = EMA(x, alpha(fc))

Only good observations (``ok``) tick the filter; the first one passes
through unchanged.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

MIN_CUTOFF = 0.05
BETA = 2.0
D_CUTOFF = 0.3


def _alpha(cutoff: float, fs: float) -> float:
    tau = 1.0 / (2.0 * math.pi * cutoff)
    te = 1.0 / fs
    return 1.0 / (1.0 + tau / te)


def one_euro_gated_state(shape, device=None) -> Dict[str, torch.Tensor]:
    return {
        "x": torch.zeros(shape, dtype=torch.float32, device=device),
        "dx": torch.zeros(shape, dtype=torch.float32, device=device),
        "init": torch.zeros((), dtype=torch.bool, device=device),
    }


def one_euro_step(state, x, min_cutoff=MIN_CUTOFF, beta=BETA, d_cutoff=D_CUTOFF, fs=1.0):
    """One causal tick. Returns (new_state, x_hat)."""
    a_d = _alpha(d_cutoff, fs)
    dx = (x - state["x"]) * fs
    dx_hat = a_d * dx + (1.0 - a_d) * state["dx"]
    fc = min_cutoff + beta * torch.abs(dx_hat)
    a = 1.0 / (1.0 + fs / (2.0 * math.pi * fc))
    x_hat = a * x + (1.0 - a) * state["x"]
    return {"x": x_hat, "dx": dx_hat}, x_hat


def one_euro_gated_step(state, x, ok, **kw):
    """One tick that only ingests good observations; returns (state, output)."""
    x = x.to(torch.float32)
    prev = {
        "x": torch.where(state["init"], state["x"], x),
        "dx": torch.where(state["init"], state["dx"], torch.zeros_like(x)),
    }
    new, x_hat = one_euro_step(prev, x, **kw)
    out_state = {
        "x": torch.where(ok, new["x"], state["x"]),
        "dx": torch.where(ok, new["dx"], state["dx"]),
        "init": state["init"] | ok,
    }
    return out_state, torch.where(ok, x_hat, x)
