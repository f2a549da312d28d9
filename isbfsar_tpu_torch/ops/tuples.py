"""Temporal tuple indices for the cross-transformer (copy of
``isbfsar_tpu/ops/tuples.py``).

The TRX attends over all C(seq_len, m) ordered frame combinations. The
index table is static given (seq_len, m), so it is computed once on the
host and kept as a constant gather table.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np


@functools.lru_cache(maxsize=None)
def frame_tuples(seq_len: int, set_size: int = 2) -> np.ndarray:
    """(n_tuples, set_size) int32 — all combinations in lexicographic order."""
    combos = list(itertools.combinations(range(seq_len), set_size))
    return np.asarray(combos, dtype=np.int32)


def n_tuples(seq_len: int, set_size: int = 2) -> int:
    return frame_tuples(seq_len, set_size).shape[0]
