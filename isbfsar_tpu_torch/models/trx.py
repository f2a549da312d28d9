"""TRX-OS, skeleton mode (port of ``isbfsar_tpu/models/trx.py``).

SkeletonMLP (90 -> 180 -> 256, ReLU on both), the temporal cross-transformer
over all C(seq_len, 2) frame pairs (K/V linears with LayerNorm on K,
softmax over the query-tuple axis, negative mean squared distance logits)
and the open-set Discriminator. The support set is a fixed (way,) buffer
with a validity mask: invalid classes get -1e30 logits. All float32.

``forward`` is the whole episode the trainer and the evaluators run;
``support_kv`` and ``match_features`` are the streaming split the pipeline
and the recognizer run, with the support K/V cached.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import LayerNorm
from isbfsar_tpu_torch.ops.tuples import frame_tuples

NEG_INF = -1e30


def positional_encoding_table(max_len: int, d_model: int, scale: float = 0.1) -> np.ndarray:
    """(max_len, d_model) sin/cos table, scaled."""
    position = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * -(np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div) * scale
    pe[:, 1::2] = np.cos(position * div) * scale
    return pe


class SkeletonMLP(nn.Module):
    def __init__(self, n_in: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(n_in, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class Discriminator(nn.Module):
    def __init__(self, n_tuples: int, in_dim: int, reduced: int):
        super().__init__()
        self.reduce = nn.Linear(in_dim, reduced)
        self.fc1 = nn.Linear(n_tuples * reduced, 256)
        self.fc2 = nn.Linear(256, 64)
        self.fc3 = nn.Linear(64, 1)

    def forward(self, diff):  # (b, n_tuples, in_dim)
        y = self.reduce(diff).reshape(diff.shape[0], -1)
        y = F.relu(self.fc2(F.relu(self.fc1(y))))
        return torch.sigmoid(self.fc3(y))


class TemporalCrossTransformer(nn.Module):
    def __init__(self, seq_len: int, in_dim: int, out_dim: int = 128, set_size: int = 2,
                 pe_scale: float = 0.1):
        super().__init__()
        self.out_dim = out_dim
        self.set_size = set_size
        self.register_buffer("pe", torch.from_numpy(
            positional_encoding_table(int(seq_len * 1.5), in_dim, pe_scale)), persistent=False)
        self.register_buffer("tuples", torch.from_numpy(
            frame_tuples(seq_len, set_size).astype(np.int64)), persistent=False)
        self.k_linear = nn.Linear(set_size * in_dim, out_dim)
        self.v_linear = nn.Linear(set_size * in_dim, out_dim)
        self.norm_k = LayerNorm(out_dim)

    def _tuplify(self, feats):
        """(..., L, D) -> (..., n_tuples, set_size * D) after the positional encoding."""
        feats = feats + self.pe[: feats.shape[-2]]
        gathered = feats[..., self.tuples, :]  # (..., T, set, D)
        return gathered.reshape(*gathered.shape[:-2], self.set_size * feats.shape[-1])

    def support_kv(self, support_features):
        """(b, way, L, D) -> keys and values, each (b, way, T, out)."""
        s_tup = self._tuplify(support_features)
        return self.norm_k(self.k_linear(s_tup)), self.v_linear(s_tup)

    def match(self, s_k, s_v, support_mask, query_features) -> Dict[str, torch.Tensor]:
        q_tup = self._tuplify(query_features)  # (b, T, 2D)
        q_k = self.norm_k(self.k_linear(q_tup))
        q_v = self.v_linear(q_tup)
        scores = torch.einsum("btd,bwsd->bwts", q_k, s_k) / np.float32(np.sqrt(self.out_dim))
        attn = torch.softmax(scores, dim=-2)  # over the query-tuple axis
        proto = torch.einsum("bwts,bwsd->bwtd", attn, s_v)
        diff = q_v[:, None] - proto
        norm_sq = torch.square(diff).sum(dim=(-2, -1))
        logits = -(norm_sq / self.tuples.shape[0])
        logits = torch.where(support_mask, logits, torch.full_like(logits, NEG_INF))
        return {"logits": logits, "diffs": diff, "prototypes": proto, "attention": attn}


class TRXOS(nn.Module):
    """Skeleton-mode recognizer; module names follow the Flax tree."""

    def __init__(self, config: ARConfig):
        super().__init__()
        if config.input_type != "skeleton":
            raise NotImplementedError("the port runs skeleton mode only")
        self.config = config
        self.sk_extractor = SkeletonMLP(config.n_joints * 3, config.n_joints * 3 * 2, 256)
        self.transformer = TemporalCrossTransformer(
            config.seq_len, config.trans_linear_in_dim, config.trans_linear_out_dim,
            config.temp_set[0], config.pe_scale_factor)
        n_tuples = frame_tuples(config.seq_len, config.temp_set[0]).shape[0]
        if config.model == "DISC":
            self.discriminator = Discriminator(n_tuples, config.trans_linear_out_dim, config.seq_len)

    def embed_frame(self, sk):
        """(..., n_joints*3) root-relative skeletons -> (..., 256) features."""
        return self.sk_extractor(sk)

    def extract_features(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{"sk": (..., L, n_joints*3)} -> (..., L, 256)."""
        return self.sk_extractor(data["sk"])

    def forward(self, query_data, support_mask, support_data=None, support_features=None):
        """A whole episode: query clips {"sk": (b, L, 90)} against a support
        set given as clips {"sk": (b, way, L, 90)} or as their features
        (b, way, L, D), exactly one of the two."""
        query_features = self.extract_features(query_data)
        if support_features is None:
            support_features = self.extract_features(support_data)
        return self.match_with_features(query_features, support_mask, support_features)

    def match_with_features(self, query_features, support_mask, support_features):
        """The match and open-set decision on embedded query (b, L, D) and
        support (b, way, L, D) features: logits, is_true, prototypes,
        support_features and attention."""
        s_k, s_v = self.support_kv(support_features)
        out = self.transformer.match(s_k, s_v, support_mask, query_features)
        return {"logits": out["logits"], "is_true": self._decide(out),
                "prototypes": out["prototypes"], "support_features": support_features,
                "attention": out["attention"]}

    def support_kv(self, support_features):
        return self.transformer.support_kv(support_features)

    def match_features(self, query_features, support_mask, s_k, s_v):
        """Query windows (b, L, D) against cached K/V (b, way, T, out)."""
        out = self.transformer.match(s_k, s_v, support_mask, query_features)
        return {"logits": out["logits"], "is_true": self._decide(out)}

    def _decide(self, out):
        """The open-set score of the best-matching class: the discriminator
        on its tuple differences, or exp of its logit."""
        logits = out["logits"]
        chosen = logits.argmax(dim=1)
        chosen_diff = out["diffs"][torch.arange(logits.shape[0], device=logits.device), chosen]
        if self.config.model == "DISC":
            return self.discriminator(chosen_diff)
        return torch.exp(logits.max(dim=1, keepdim=True).values)
