"""Online one-shot open-set action recognizer (port of
``isbfsar_tpu/ar/recognizer.py``).

The support set lives in fixed-shape buffers — raw data per modality of
the input type (skeleton ``sk`` (way, L, 90), whitened crops ``rgb``
(way, L, rgb_size, rgb_size, 3); hybrid holds both), cached features
(way, L, D) and a validity mask (way,) — so adding or removing a class
rewrites one slot. The pipeline computes the features and the
transformer's support K/V once per edit (``start``);
:meth:`ActionRecognizer.inference`, the module path's matcher, caches them
itself on its first call after an edit, and embeds the whole query window
on every call, as the JAX recognizer does.

Guarantees kept from the reference:
- empty input or an empty support set -> ({}, 0, {});
- results only once the window holds seq_len frames;
- class scores are a softmax over the live classes only.

``save_support_set`` / ``load_support_set`` write and read the JAX
package's format (``support_set.npz`` + ``support_set.json``), so a set
saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.weights import convert_variables

MODALITY_SHAPES = {
    "sk": lambda cfg: (cfg.n_joints * 3,),
    "rgb": lambda cfg: (cfg.rgb_size, cfg.rgb_size, 3),
}
# the clip keys of ``train``'s data -> modalities
CLIP_KEYS = {"poses": "sk", "imgs": "rgb"}


def _modalities(input_type: str) -> List[str]:
    return {"skeleton": ["sk"], "rgb": ["rgb"], "hybrid": ["rgb", "sk"]}[input_type]


class ActionRecognizer:
    def __init__(self, config: ARConfig, params: Optional[Mapping[str, Any]] = None,
                 seed: int = 0, device: str = "cuda"):
        """params: Flax variables ``{"params": ...}`` of the JAX TRXOS (numpy
        leaves; rgb and hybrid also carry the ResNet-50's ``batch_stats``);
        None initializes random weights from ``seed``."""
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
        self.modalities = _modalities(config.input_type)
        self.support_data = {
            m: np.zeros((self.way, self.seq_len) + MODALITY_SHAPES[m](config), np.float32)
            for m in self.modalities
        }
        self.support_mask = np.zeros((self.way,), bool)
        self.support_features: Optional[torch.Tensor] = None  # (way, L, D) when cached
        self.class_order: List[Optional[str]] = [None] * self.way
        self.requires_focus: Dict[str, bool] = {}
        self.previous_frames: List[Dict[str, np.ndarray]] = []
        # bumped on every support-set edit; holders of derived caches compare it
        self.support_version: int = 0
        # (support_features it was computed from, s_k, s_v), inference's cache
        self._support_kv: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None

    def train(self, inp: Dict) -> None:
        """Insert or overwrite a class: {'flag': name, 'data': {'poses':
        (L, 90) and/or 'imgs': (L, rgb_size, rgb_size, 3)}, 'requires_focus': bool}."""
        name = inp["flag"]
        if name in self.class_order:
            slot = self.class_order.index(name)
        else:
            free = np.flatnonzero(~self.support_mask)
            if free.size == 0:
                raise ValueError(f"support set is full (way={self.way}); remove a class first")
            slot = int(free[0])
        for k, v in inp["data"].items():
            m = CLIP_KEYS.get(k, k)
            if m not in self.support_data:
                raise ValueError(f"clip key {k!r} is not a modality of "
                                 f"input_type={self.config.input_type!r}")
            self.support_data[m][slot] = np.asarray(v, np.float32).reshape(
                self.support_data[m][slot].shape)
        self.support_mask[slot] = True
        self.class_order[slot] = name
        self.requires_focus[name] = bool(inp.get("requires_focus", False))
        self.support_features = None
        self.support_version += 1

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
        self.support_version += 1
        return True

    @property
    def n_classes(self) -> int:
        return int(self.support_mask.sum())

    @torch.inference_mode()
    def embed_support(self, classes: slice = slice(None)) -> torch.Tensor:
        """(way, L, D) features of the support data (empty slots included),
        or of its ``classes`` slots alone: in rgb and hybrid, way * L
        ResNet-50 forwards as one batch."""
        return self.model.extract_features(
            {m: torch.from_numpy(np.ascontiguousarray(v[classes])).to(self.device)
             for m, v in self.support_data.items()})

    def _live_classes(self) -> List[str]:
        return [c for c, v in zip(self.class_order, self.support_mask) if v and c is not None]

    @torch.inference_mode()
    def inference(self, data: Optional[Dict[str, np.ndarray]]
                  ) -> Tuple[Dict[str, float], float, Dict[str, bool]]:
        """One frame's {'sk': (90,)} and/or {'rgb': (rgb_size, rgb_size, 3)}
        -> (scores per live class, open-set decision, requires_focus);
        ({}, 0, {}) until the window holds seq_len frames. The support
        features and K/V are computed on the first call after an edit and
        reused; the window's frames are embedded anew on each call."""
        if data is None or len(data) == 0:
            return {}, 0, {}
        if not self.support_mask.any():
            return {}, 0, {}
        missing = [m for m in self.modalities if m not in data]
        if missing:
            # checked before the append: a malformed frame in the window
            # would break the next seq_len stacks
            raise ValueError(
                f"inference data missing modalities {missing} for "
                f"input_type={self.config.input_type!r} (got {sorted(data)})")
        self.previous_frames.append({k: np.asarray(v, np.float32) for k, v in data.items()})
        if len(self.previous_frames) < self.seq_len:
            return {}, 0, {}
        self.previous_frames = self.previous_frames[-self.seq_len:]

        if self.support_features is None:
            self.support_features = self.embed_support()
        if self._support_kv is None or self._support_kv[0] is not self.support_features:
            s_k, s_v = self.model.support_kv(self.support_features[None])
            self._support_kv = (self.support_features, s_k, s_v)
        _, s_k, s_v = self._support_kv
        query = {m: torch.from_numpy(np.stack([f[m] for f in self.previous_frames])[None]
                                     ).to(self.device) for m in self.modalities}
        feats = self.model.extract_features(query)
        mask = torch.from_numpy(self.support_mask.copy())[None].to(self.device)
        out = self.model.match_features(feats, mask, s_k, s_v)
        probs = torch.softmax(out["logits"][0], dim=-1)
        # one device -> host copy for both outputs
        host = torch.cat([probs, out["is_true"][0, :1]]).cpu().numpy()
        results = {name: float(host[i]) for i, name in enumerate(self.class_order)
                   if self.support_mask[i] and name is not None}
        return results, float(host[-1]), dict(self.requires_focus)

    # --------------------------------------------------------- persistence

    def save_support_set(self, directory: str) -> str:
        """Write the support set as the JAX package does: ``support_set.npz``
        (mask and data) and ``support_set.json`` (class order, focus flags,
        input type)."""
        os.makedirs(directory, exist_ok=True)
        np.savez_compressed(
            os.path.join(directory, "support_set.npz"),
            mask=self.support_mask,
            **{f"data_{m}": v for m, v in self.support_data.items()},
        )
        meta = {
            "class_order": self.class_order,
            "requires_focus": self.requires_focus,
            "input_type": self.config.input_type,
        }
        with open(os.path.join(directory, "support_set.json"), "w") as f:
            json.dump(meta, f)
        return directory

    def load_support_set(self, directory: str) -> int:
        """Read a support set written by either package; returns the number
        of classes. Refuses another input type or other shapes."""
        with np.load(os.path.join(directory, "support_set.npz")) as npz:
            data = {k: npz[k] for k in npz.files}
        with open(os.path.join(directory, "support_set.json")) as f:
            meta = json.load(f)
        if meta.get("input_type") != self.config.input_type:
            raise ValueError(
                f"support set was saved for input_type={meta.get('input_type')!r}, "
                f"recognizer is configured for {self.config.input_type!r}")
        for m in self.modalities:
            want, got = self.support_data[m].shape, data[f"data_{m}"].shape
            if want != got:
                raise ValueError(
                    f"support set shape mismatch for {m!r}: saved {got}, "
                    f"config expects {want} (way/seq_len/size changed?)")
        self.support_mask = data["mask"].astype(bool)
        for m in self.modalities:
            self.support_data[m] = data[f"data_{m}"].astype(np.float32)
        self.class_order = meta["class_order"]
        self.requires_focus = meta["requires_focus"]
        self.support_features = None
        self.support_version += 1
        return self.n_classes
