"""Way-sharded support-set matching over a process group (port of
``isbfsar_tpu/parallel/support.py``).

The TRX match is independent per class up to the softmax over the class
logits and the open-set decision, which reads the winning class's tuple
differences. So each of n ranks holds way/n classes: it embeds its own
class slice of the support clips, caches that slice's features and K/V,
matches the (replicated) query window against them, and computes the
open-set decision of its own best class. One all-gather carries every
rank's (way/n,) logits and that decision; the winning class's owner's
decision is the answer, and every rank returns the same result.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.parallel.mesh import make_mesh


class WayShardedMatcher:
    """An ActionRecognizer's match with its support set split over the ranks
    of a 1-D mesh.

    Wraps the recognizer: its support-set API (train/remove/save/load)
    stays on it, and every rank makes the same edits; this class owns the
    rank's class slice of the features and K/V. ``way`` must be a multiple
    of the mesh size (pad the config's way: masked slots cost nothing).
    """

    def __init__(self, ar: ActionRecognizer, mesh=None):
        self.ar = ar
        self.mesh = mesh if mesh is not None else make_mesh(device=ar.device)
        n = self.mesh.size()
        if ar.way % n:
            raise ValueError(f"way ({ar.way}) must be a multiple of the mesh size ({n}); pad "
                             "ARConfig.way (masked slots cost nothing)")
        self.group = self.mesh.get_group()
        self.n = n
        self.per_rank = ar.way // n
        lo = self.mesh.get_local_rank() * self.per_rank
        self.classes = slice(lo, lo + self.per_rank)
        self._features: Optional[torch.Tensor] = None  # (way/n, L, D), this rank's classes
        self._kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._features_version = -1  # ar.support_version at the last refresh

    @torch.inference_mode()
    def refresh(self) -> None:
        """Embed this rank's classes of the recognizer's support data."""
        self._features = self.ar.embed_support(self.classes)
        self._kv = self.ar.model.support_kv(self._features[None])
        self._features_version = self.ar.support_version

    @torch.inference_mode()
    def match_window(self, window: Dict[str, np.ndarray]) -> Tuple[Dict[str, float], float]:
        """Match a full (L, ...) query window against the split support:
        ({class: prob}, open-set score), the recognizer's inference result
        without its sliding window (``ar.inference`` keeps that)."""
        ar = self.ar
        if not ar.support_mask.any():
            return {}, 0.0
        if self._features is None or self._features_version != ar.support_version:
            self.refresh()  # the support set was edited since the last embed
        query = {m: torch.from_numpy(np.asarray(v, np.float32)[None]).to(ar.device)
                 for m, v in window.items()}
        feats = ar.model.extract_features(query)
        mask = torch.from_numpy(ar.support_mask[self.classes].copy())[None].to(ar.device)
        s_k, s_v = self._kv
        out = ar.model.match_features(feats, mask, s_k, s_v)  # this rank's best class decides
        row = torch.cat([out["logits"][0], out["is_true"][0, :1].to(out["logits"].dtype)])
        rows = [torch.empty_like(row) for _ in range(self.n)]
        dist.all_gather(rows, row.contiguous(), group=self.group)
        rows = torch.stack(rows)  # (n, way/n + 1)
        logits = rows[:, :-1].reshape(-1)
        winner = int(logits.argmax()) // self.per_rank
        host = torch.cat([torch.softmax(logits, dim=-1), rows[winner, -1:]]).cpu().numpy()
        results = {name: float(host[i]) for i, name in enumerate(ar.class_order)
                   if ar.support_mask[i] and name is not None}
        return results, float(host[-1])
