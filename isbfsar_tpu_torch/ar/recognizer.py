"""One-shot open-set action recognizer state (port of the support-set half
of ``isbfsar_tpu/ar/recognizer.py``: ``train``, ``remove``, the support mask
and ``class_order``).

The support set lives in fixed-shape buffers — raw skeleton data
(way, L, 90), cached features (way, L, D) and a validity mask (way,) — so
adding or removing a class rewrites one slot. The pipeline computes the
features and the transformer's support K/V once per edit (``start``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.weights import convert_variables


class ActionRecognizer:
    def __init__(self, config: ARConfig, params: Optional[Mapping[str, Any]] = None,
                 seed: int = 0, device: str = "cuda"):
        """params: Flax variables ``{"params": ...}`` of the JAX TRXOS (numpy
        leaves); None initializes random weights from ``seed``."""
        self.config = config
        self.device = torch.device(device)
        self.model = TRXOS(config)
        if params is None:
            init_random(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(convert_variables(params), strict=True)
        self.model.eval().to(self.device)
        self.seq_len = config.seq_len
        self.way = config.way
        self.support_data = {"sk": np.zeros((self.way, self.seq_len, config.n_joints * 3), np.float32)}
        self.support_mask = np.zeros((self.way,), bool)
        self.support_features: Optional[torch.Tensor] = None  # (way, L, D) when cached
        self.class_order: List[Optional[str]] = [None] * self.way
        self.requires_focus: Dict[str, bool] = {}

    def train(self, inp: Dict) -> None:
        """Insert or overwrite a class: {'flag': name, 'data': {'poses': (L, 90)},
        'requires_focus': bool}."""
        name = inp["flag"]
        if name in self.class_order:
            slot = self.class_order.index(name)
        else:
            free = np.flatnonzero(~self.support_mask)
            if free.size == 0:
                raise ValueError(f"support set is full (way={self.way}); remove a class first")
            slot = int(free[0])
        for k, v in inp["data"].items():
            m = {"poses": "sk"}.get(k, k)
            if m not in self.support_data:
                raise ValueError(f"modality {k!r} is not ported (skeleton mode only)")
            self.support_data[m][slot] = np.asarray(v, np.float32).reshape(
                self.support_data[m][slot].shape)
        self.support_mask[slot] = True
        self.class_order[slot] = name
        self.requires_focus[name] = bool(inp.get("requires_focus", False))
        self.support_features = None

    def remove(self, flag: str) -> bool:
        if flag not in self.class_order:
            return False
        slot = self.class_order.index(flag)
        self.support_mask[slot] = False
        self.class_order[slot] = None
        for v in self.support_data.values():
            v[slot] = 0.0
        self.requires_focus.pop(flag, None)
        self.support_features = None
        return True

    @property
    def n_classes(self) -> int:
        return int(self.support_mask.sum())

    @torch.inference_mode()
    def embed_support(self) -> torch.Tensor:
        """(way, L, D) features of the support data (empty slots included)."""
        sk = torch.from_numpy(self.support_data["sk"]).to(self.device)
        return self.model.embed_frame(sk)
