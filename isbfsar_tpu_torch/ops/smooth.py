"""Causal One-Euro pose smoothing (port of ``isbfsar_tpu/ops/smooth.py``):
the gated per-step filter of the live pipeline (``one_euro_gated_state`` /
``_step``, torch) and the offline whole-sequence filter the dataset
extraction runs (``one_euro``, numpy).

    alpha(fc) = 1 / (1 + fs / (2*pi*fc))
    dx_hat    = EMA(dx, alpha(d_cutoff))
    fc        = min_cutoff + beta * |dx_hat|
    x_hat     = EMA(x, alpha(fc))

Only good observations (``ok``) tick the filter; the first one passes
through unchanged. A leading stream axis is allowed: with ``lead=(S,)``
the state holds S independent filters, and ``ok`` is one flag per stream.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MIN_CUTOFF = 0.05
BETA = 2.0
D_CUTOFF = 0.3


def _alpha(cutoff, fs: float):
    tau = 1.0 / (2.0 * math.pi * cutoff)
    te = 1.0 / fs
    return 1.0 / (1.0 + tau / te)


def one_euro_init(x0) -> Dict[str, torch.Tensor]:
    """Filter state from the first observation (a tensor or numpy array)."""
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    return {"x": x0, "dx": torch.zeros_like(x0)}


def one_euro_gated_state(shape, device=None, lead=()) -> Dict[str, torch.Tensor]:
    """The state of ``prod(lead)`` filters of observations of ``shape``."""
    lead = tuple(lead)
    return {
        "x": torch.zeros(lead + tuple(shape), dtype=torch.float32, device=device),
        "dx": torch.zeros(lead + tuple(shape), dtype=torch.float32, device=device),
        "init": torch.zeros(lead, dtype=torch.bool, device=device),
    }


def _gate(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-stream flag shaped to broadcast over its stream's observation."""
    return flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))


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
    init, gate = _gate(state["init"], x), _gate(ok, x)
    prev = {
        "x": torch.where(init, state["x"], x),
        "dx": torch.where(init, state["dx"], torch.zeros_like(x)),
    }
    new, x_hat = one_euro_step(prev, x, **kw)
    out_state = {
        "x": torch.where(gate, new["x"], state["x"]),
        "dx": torch.where(gate, new["dx"], state["dx"]),
        "init": state["init"] | ok,
    }
    return out_state, torch.where(gate, x_hat, x)


def one_euro(xs: np.ndarray, min_cutoff: float = MIN_CUTOFF, beta: float = BETA,
             d_cutoff: float = D_CUTOFF, fs: float = 1.0) -> np.ndarray:
    """Filter a whole sequence, xs (T, ...) of any trailing shape: float64
    state, float32 output; the first sample passes through unchanged (the
    filter state starts on it). Causal: output t depends on inputs <= t."""
    xs = np.asarray(xs, np.float32)
    out = np.empty_like(xs)
    out[0] = xs[0]
    x_hat = xs[0].astype(np.float64)
    dx_hat = np.zeros_like(x_hat)
    a_d = _alpha(d_cutoff, fs)
    for t in range(1, xs.shape[0]):
        dx = (xs[t] - x_hat) * fs
        dx_hat = a_d * dx + (1.0 - a_d) * dx_hat
        fc = min_cutoff + beta * np.abs(dx_hat)
        a = _alpha(fc, fs)
        x_hat = a * xs[t] + (1.0 - a) * x_hat
        out[t] = x_hat
    return out
