"""Metrics logging (port of ``isbfsar_tpu/utils/metrics.py``).

:class:`MetricsLogger` appends each metric dict to ``metrics.jsonl`` in its
log directory, and forwards it to wandb only when wandb imports and
``WANDB_API_KEY`` is set; it never needs wandb.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def binary_prf(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """accuracy/precision/recall/f1 with zero-division -> 0 (sklearn semantics)."""
    y_true = np.asarray(y_true).reshape(-1).astype(bool)
    y_pred = np.asarray(y_pred).reshape(-1).astype(bool)
    if y_true.size == 0:
        return {"accuracy": 0.0, "precision": 0.0, "recall": 0.0, "f1": 0.0}
    tp = float(np.sum(y_true & y_pred))
    fp = float(np.sum(~y_true & y_pred))
    fn = float(np.sum(y_true & ~y_pred))
    acc = float(np.mean(y_true == y_pred))
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1}


def _json_value(v):
    """numpy scalars and 0-d arrays -> Python floats; strings and other
    JSON values pass through."""
    if isinstance(v, str):
        return v
    if isinstance(v, (int, float, bool, np.number)) or getattr(v, "ndim", 1) == 0:
        return float(v)
    return v


class MetricsLogger:
    def __init__(self, log_dir: str, project: str = "isbfsar-tpu", use_wandb: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._wandb = None
        if use_wandb and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb

                self._wandb = wandb.init(project=project)
            except Exception:  # logging to wandb is optional; the JSONL file is the record
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        record = {"time": time.time(), "step": step}
        record.update({k: _json_value(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
