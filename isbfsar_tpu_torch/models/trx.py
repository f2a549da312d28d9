"""TRX-OS in its three input modes (port of ``isbfsar_tpu/models/trx.py``).

The per-frame extractors: SkeletonMLP (90 -> 180 -> 256, ReLU on both)
for skeleton and hybrid; RGBExtractor (ResNet-50 pooled features, ReLU,
Dense 2048 -> 256) for rgb and hybrid, which takes NHWC whitened crops as
the JAX module does. Hybrid concatenates them, rgb first. Then the
temporal cross-transformer over all C(seq_len, 2) frame pairs (K/V linears
with LayerNorm on K, softmax over the query-tuple axis, negative mean
squared distance logits) and the open-set Discriminator. The support set is
a fixed (way,) buffer with a validity mask: invalid classes get -1e30
logits. All float32 (``ARConfig.compute_dtype``), the ResNet-50 included.

``forward`` is the whole episode the trainer and the evaluators run;
``support_kv`` and ``match_features`` are the streaming split the pipeline
and the recognizer run, with the support K/V cached. ``train`` and ``stats``
reach the ResNet-50's BatchNorm only (``models/resnet.py``): the query's
b·L frames are one BatchNorm batch and the support's b·way·L frames
another, extracted in that order, as the JAX module does.

Under tensor parallelism (``parallel/mesh.py::shard_params_tp``) the
transformer's ``tp_group`` is set and its K/V linears hand back their
local feature columns: ``norm_k`` then takes its mean and ``E[x²]`` over
the group and normalizes the local columns with its slice of the
replicated scale and bias, the score einsum's partial sums are added over
the group, and the distance logits' too; the prototypes and the
differences stay feature-sharded, as the discriminator's row-parallel
``reduce`` takes them. Each reduction is the one GSPMD inserts for the JAX
sharding (``parallel/collectives.py`` gives each its backward).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import LayerNorm
from isbfsar_tpu_torch.models.resnet import resnet50
from isbfsar_tpu_torch.ops.tuples import frame_tuples
from isbfsar_tpu_torch.parallel.collectives import all_reduce_sum, tp_copy, tp_reduce

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


class RGBExtractor(nn.Module):
    """(n, H, W, 3) whitened crops -> (n, 256): ResNet-50 pooled features,
    ReLU, Dense ``post``. ``ResNet_0`` is the name Flax gives the ResNet it
    builds inline, so the JAX parameter tree loads as it is."""

    def __init__(self, dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.ResNet_0 = resnet50(dtype, remat)
        self.post = nn.Linear(2048, 256)

    def forward(self, x, train: bool = False, stats: Optional[list] = None):
        feats = F.relu(self.ResNet_0(x.permute(0, 3, 1, 2), train, stats))
        # the pooled features are float32; Dense promotes them to its
        # parameters' type, as Flax's does
        return self.post(feats.to(self.post.weight.dtype))


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
        self.tp_group = None  # set when k_linear and v_linear are column-parallel

    def _norm_keys(self, k):
        """``norm_k`` over the whole feature axis, also when ``k`` holds
        this rank's columns of it."""
        g = self.tp_group
        if g is None:
            return self.norm_k(k)
        width = k.shape[-1]
        lo = torch.distributed.get_rank(g) * width
        sums = all_reduce_sum(torch.cat([k.sum(dim=-1, keepdim=True),
                                         (k * k).sum(dim=-1, keepdim=True)], dim=-1), g)
        mean, mean_sq = sums[..., :1] / self.out_dim, sums[..., 1:] / self.out_dim
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        scale = tp_copy(self.norm_k.weight, g)[lo:lo + width]
        bias = tp_copy(self.norm_k.bias, g)[lo:lo + width]
        return (k - mean) * (torch.rsqrt(var + self.norm_k.eps) * scale) + bias

    def _tuplify(self, feats):
        """(..., L, D) -> (..., n_tuples, set_size * D) after the positional encoding."""
        feats = feats + self.pe[: feats.shape[-2]]
        gathered = feats[..., self.tuples, :]  # (..., T, set, D)
        return gathered.reshape(*gathered.shape[:-2], self.set_size * feats.shape[-1])

    def support_kv(self, support_features):
        """(b, way, L, D) -> keys and values, each (b, way, T, out)."""
        s_tup = self._tuplify(support_features)
        return self._norm_keys(self.k_linear(s_tup)), self.v_linear(s_tup)

    def match(self, s_k, s_v, support_mask, query_features) -> Dict[str, torch.Tensor]:
        g = self.tp_group
        q_tup = self._tuplify(query_features)  # (b, T, 2D)
        q_k = self._norm_keys(self.k_linear(q_tup))
        q_v = self.v_linear(q_tup)
        scores = torch.einsum("btd,bwsd->bwts", q_k, s_k)
        if g is not None:  # each rank's prototype columns read the whole attention
            scores = all_reduce_sum(scores, g)
        scores = scores / np.float32(np.sqrt(self.out_dim))
        attn = torch.softmax(scores, dim=-2)  # over the query-tuple axis
        proto = torch.einsum("bwts,bwsd->bwtd", attn, s_v)
        diff = q_v[:, None] - proto
        norm_sq = torch.square(diff).sum(dim=(-2, -1))
        if g is not None:  # the logits feed replicated work only
            norm_sq = tp_reduce(norm_sq, g)
        logits = -(norm_sq / self.tuples.shape[0])
        logits = torch.where(support_mask, logits, torch.full_like(logits, NEG_INF))
        return {"logits": logits, "diffs": diff, "prototypes": proto, "attention": attn}


class TRXOS(nn.Module):
    """The recognizer in ``config.input_type``; module names follow the Flax tree."""

    def __init__(self, config: ARConfig):
        super().__init__()
        if config.input_type not in ("skeleton", "rgb", "hybrid"):
            raise ValueError(f"unknown input_type {config.input_type!r}")
        self.config = config
        if config.input_type in ("skeleton", "hybrid"):
            self.sk_extractor = SkeletonMLP(config.n_joints * 3, config.n_joints * 3 * 2, 256)
        if config.input_type in ("rgb", "hybrid"):
            self.rgb_extractor = RGBExtractor(getattr(torch, config.compute_dtype), config.remat)
        self.transformer = TemporalCrossTransformer(
            config.seq_len, config.trans_linear_in_dim, config.trans_linear_out_dim,
            config.temp_set[0], config.pe_scale_factor)
        n_tuples = frame_tuples(config.seq_len, config.temp_set[0]).shape[0]
        if config.model == "DISC":
            self.discriminator = Discriminator(n_tuples, config.trans_linear_out_dim, config.seq_len)

    def embed_frame(self, sk=None, rgb=None, train: bool = False, stats: Optional[list] = None):
        """Per-frame features (..., trans_linear_in_dim) of root-relative
        skeletons ``sk`` (..., n_joints*3) and whitened NHWC crops ``rgb``
        (..., H, W, 3), the modalities of the input type; rgb first, as the
        JAX concatenation."""
        feats = []
        if rgb is not None:
            lead = rgb.shape[:-3]
            flat = self.rgb_extractor(rgb.reshape((-1,) + rgb.shape[-3:]), train, stats)
            feats.append(flat.reshape(lead + (flat.shape[-1],)))
        if sk is not None:
            feats.append(self.sk_extractor(sk))
        return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)

    def extract_features(self, data: Dict[str, torch.Tensor], train: bool = False,
                         stats: Optional[list] = None) -> torch.Tensor:
        """{"sk": (..., L, n_joints*3)} and/or {"rgb": (..., L, H, W, 3)} ->
        (..., L, trans_linear_in_dim)."""
        return self.embed_frame(sk=data.get("sk"), rgb=data.get("rgb"), train=train, stats=stats)

    def forward(self, query_data, support_mask, support_data=None, support_features=None,
                train: bool = False, stats: Optional[list] = None):
        """A whole episode: query clips {"sk": (b, L, 90)} and/or {"rgb":
        (b, L, H, W, 3)} against a support set given as clips (the same keys,
        (b, way, L, ...)) or as their features (b, way, L, D), exactly one
        of the two. ``train`` normalizes with batch statistics, collected in
        ``stats`` (query first, then support) where it is a list."""
        query_features = self.extract_features(query_data, train, stats)
        if support_features is None:
            support_features = self.extract_features(support_data, train, stats)
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
