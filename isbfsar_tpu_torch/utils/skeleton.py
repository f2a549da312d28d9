"""Skeleton format registry (port of ``isbfsar_tpu/utils/skeleton.py``).

Reads ``skeletons.npz`` and ``joints_32_to_122.npy`` by path from the JAX
package's asset directory. The live pipeline uses ``smpl+head_30``
(30 joints, 29 edges).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional, Tuple

import numpy as np

from isbfsar_tpu_torch.configs import ASSETS_DIR


@dataclasses.dataclass(frozen=True)
class SkeletonSpec:
    name: str
    indices: Tuple[int, ...]  # joint selection out of the 122-joint superset
    edges: np.ndarray  # (n_edges, 2) int32
    joint_names: Tuple[str, ...]


@functools.lru_cache(maxsize=None)
def load_registry(path: str = "") -> Dict[str, SkeletonSpec]:
    data = np.load(path or os.path.join(ASSETS_DIR, "skeletons.npz"), allow_pickle=False)
    registry = {}
    for key in sorted({k.rsplit("__", 1)[0] for k in data.files}):
        name = key.replace("_plus_", "+")
        registry[name] = SkeletonSpec(
            name=name,
            indices=tuple(int(i) for i in data[f"{key}__indices"]),
            edges=np.asarray(data[f"{key}__edges"], dtype=np.int32),
            joint_names=tuple(str(s) for s in data[f"{key}__names"]),
        )
    return registry


def get_skeleton(name: str, path: str = "") -> SkeletonSpec:
    registry = load_registry(path)
    if name not in registry:
        raise KeyError(f"unknown skeleton {name!r}; available: {sorted(registry)}")
    return registry[name]


@functools.lru_cache(maxsize=None)
def load_expand_joints(path: str = "") -> np.ndarray:
    """(32, 122) float32 joint-expansion matrix."""
    return np.load(path or os.path.join(ASSETS_DIR, "joints_32_to_122.npy")).astype(np.float32)


def joint_matrix(skeleton: Optional[str], expand_path: str = "",
                 skeletons_path: str = "") -> np.ndarray:
    """(32, n_joints) fused 32->122 expansion and skeleton selection; the
    whole (32, 122) expansion when ``skeleton`` is None."""
    expand = load_expand_joints(expand_path)
    if skeleton is None:
        return np.ascontiguousarray(expand)
    return np.ascontiguousarray(expand[:, list(get_skeleton(skeleton, skeletons_path).indices)])
