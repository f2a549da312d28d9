"""Weight bridge: the JAX package's Flax msgpack bundle -> torch state dicts.

The bundle (``isbfsar_tpu/assets/pretrained/``) is Flax's msgpack format:
msgpack maps with str keys whose array leaves are msgpack ext type 1, a
packed ``(shape, dtype_name, bytes)`` triple. The decoder here is plain
Python and numpy (the machine with the card has no msgpack, flax or
ml_dtypes): bfloat16 leaves are read as 16-bit integers and viewed as
``torch.bfloat16``.

Conversion runs at load time, in memory; nothing converted is written
anywhere. Flax layouts map to the port's modules as:

* conv kernel HWIO -> weight OIHW (depthwise (3, 3, 1, C) -> (C, 1, 3, 3));
* dense kernel (in, out) -> weight (out, in);
* BatchNorm ``scale``/``bias`` params and ``mean``/``var`` batch stats keep
  their names (the port's BatchNorm uses Flax's names);
* LayerNorm ``scale`` -> ``weight``.

The port's modules carry the Flax module names, so a leaf at
``{collection}/a/b/kernel`` becomes state-dict key ``a.b.weight``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ASSETS_DIR

BUNDLE_DIR = os.path.join(ASSETS_DIR, "pretrained")

_NDARRAY_EXT = 1
_NPSCALAR_EXT = 3


class _Reader:
    """Minimal msgpack decoder for the subset Flax writes."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def value(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        fixed = {
            0xCA: (">f", 4), 0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
        }
        if t in fixed:
            return self._unpack(*fixed[t])
        lengths = {0: (">B", 1), 1: (">H", 2), 2: (">I", 4)}
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self._take(self._unpack(*lengths[t - 0xC4]))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack(*lengths[t - 0xC7])
            return self._ext(self._unpack(">b", 1), self._take(n))
        if t in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
            n = 1 << (t - 0xD4)
            return self._ext(self._unpack(">b", 1), self._take(n))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack(*lengths[t - 0xD9]))
        if t in (0xDC, 0xDD):  # array 16/32
            return self._array(self._unpack(*lengths[t - 0xDB]))
        if t in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack(*lengths[t - 0xDD]))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def _ext(code: int, payload: memoryview) -> Any:
        if code not in (_NDARRAY_EXT, _NPSCALAR_EXT):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = _Reader(payload).value()
        arr = _array_from_bytes(tuple(shape), str(dtype_name), raw)
        return arr.reshape(()) if code == _NPSCALAR_EXT else arr


def _array_from_bytes(shape, dtype_name: str, raw) -> torch.Tensor:
    if dtype_name == "bfloat16":
        arr = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(raw, np.dtype(dtype_name)).copy()
    return torch.from_numpy(arr).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode Flax msgpack bytes into a tree of dicts with CPU tensor leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    _refuse_chunked(tree)
    return tree


def _refuse_chunked(tree) -> None:
    # Flax splits arrays over 1 GiB into chunks; no leaf of the bundle is.
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked msgpack arrays are not supported")
        for v in tree.values():
            _refuse_chunked(v)


def manifest(bundle_dir: str = BUNDLE_DIR) -> Dict[str, Dict[str, str]]:
    with open(os.path.join(bundle_dir, "MANIFEST.json")) as f:
        return json.load(f)


def bundle_path(name: str, bundle_dir: str = BUNDLE_DIR) -> str:
    meta = manifest(bundle_dir).get(name)
    if meta is None:
        raise KeyError(f"no bundled pretrained entry {name!r}")
    return os.path.join(bundle_dir, meta["file"])


def load_bundle(name: str, bundle_dir: str = BUNDLE_DIR) -> Any:
    """Restore one bundle entry as a tree of CPU tensors."""
    with open(bundle_path(name, bundle_dir), "rb") as f:
        return msgpack_restore(f.read())


def load_calibrated(base: str = "pose-prod-256", bundle_dir: str = BUNDLE_DIR) -> Any:
    """``base`` with its ``-calib`` detector delta merged over it (the delta
    holds only the YOLO branch), as ``isbfsar_tpu/pretrained.py::load_calibrated``."""
    return {**load_bundle(base, bundle_dir), **load_bundle(f"{base}-calib", bundle_dir)}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _tensor(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array from JAX
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def convert_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """One Flax module's variables ``{"params": ..., "batch_stats": ...}``
    (numpy or torch leaves) -> the port module's state dict."""
    sd = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected Flax collection {collection!r}")
        for path, leaf in _flatten(tree).items():
            t = leaf if isinstance(leaf, torch.Tensor) else _tensor(leaf)
            *mod, name = path
            if name == "kernel" and t.ndim == 4:
                t, name = t.permute(3, 2, 0, 1), "weight"
            elif name == "kernel" and t.ndim == 2:
                t, name = t.t(), "weight"
            elif name == "scale" and "norm" in mod[-1]:
                name = "weight"  # LayerNorm
            sd[".".join([*mod, name])] = t.contiguous()
    return sd


def convert_pose_stack(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A pose-stack bundle ``{"yolo", "bbone", "head"}`` -> state dicts."""
    return {k: convert_variables(params[k]) for k in ("yolo", "bbone", "head")}
