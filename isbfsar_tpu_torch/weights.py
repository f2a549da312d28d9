"""Weight bridge between the JAX package's Flax msgpack files and torch
state dicts, both ways.

The bundle (``isbfsar_tpu/assets/pretrained/``) is Flax's msgpack format:
msgpack maps with str keys whose array leaves are msgpack ext type 1, a
packed ``(shape, dtype_name, bytes)`` triple. The decoder here is plain
Python and numpy (the machine with the card has no msgpack, flax or
ml_dtypes): bfloat16 leaves are read as 16-bit integers and viewed as
``torch.bfloat16``.

Conversion runs at load time, in memory. Flax layouts map to the port's
modules as:

* conv kernel HWIO -> weight OIHW (depthwise (k, k, 1, C) -> (C, 1, k, k));
* dense kernel (in, out) -> weight (out, in);
* BatchNorm ``scale``/``bias`` params and ``mean``/``var`` batch stats keep
  their names (the port's BatchNorm uses Flax's names);
* LayerNorm ``scale`` -> ``weight``.

The port's modules carry the Flax module names, so a leaf at
``{collection}/a/b/kernel`` becomes state-dict key ``a.b.weight``.
:func:`to_flax_variables` maps a state dict back, and :func:`msgpack_dumps`
writes a tree as Flax's ``serialization.to_bytes`` does, so the trainer's
checkpoints read in either package.

The bundle's registry (port of ``isbfsar_tpu/pretrained.py``):
:func:`available` names the entries present, and :func:`verify` checks
both ways that every manifest entry's file is the digest of its fixture's
live cache key (the port's key builders, which give the JAX package's
strings) and that every registered fixture is bundled.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.utils.cache import params_cache_digest, pretrained_bundle_dir

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


def manifest(bundle_dir: Optional[str] = None) -> Dict[str, Dict[str, str]]:
    """The bundle's MANIFEST.json; ``bundle_dir`` None is the shared bundle
    (``utils/cache.py::pretrained_bundle_dir``, which honours
    ``ISBFSAR_PRETRAINED_DIR``)."""
    with open(os.path.join(bundle_dir or pretrained_bundle_dir(), "MANIFEST.json")) as f:
        return json.load(f)


def bundle_path(name: str, bundle_dir: Optional[str] = None) -> str:
    meta = manifest(bundle_dir).get(name)
    if meta is None:
        raise KeyError(f"no bundled pretrained entry {name!r}")
    return os.path.join(bundle_dir or pretrained_bundle_dir(), meta["file"])


def load_bundle(name: str, bundle_dir: Optional[str] = None) -> Any:
    """Restore one bundle entry as a tree of CPU tensors."""
    with open(bundle_path(name, bundle_dir), "rb") as f:
        return msgpack_restore(f.read())


def load_calibrated(base: str = "pose-prod-256", bundle_dir: Optional[str] = None) -> Any:
    """``base`` with its ``-calib`` detector delta merged over it (the delta
    holds only the YOLO branch), as ``isbfsar_tpu/pretrained.py::load_calibrated``."""
    return {**load_bundle(base, bundle_dir), **load_bundle(f"{base}-calib", bundle_dir)}


class Spec(NamedTuple):
    """A bundled trained fixture: its cache key, version and builder."""

    key: Callable[[], str]  # the exact cached_params key (built lazily)
    version: str
    builder: Callable[[], Any]  # the fixture (trains on a miss)


def _specs() -> Dict[str, Spec]:
    # the trainers are imported here, not with this module: they import it
    from isbfsar_tpu_torch.train import gazefocus as gf
    from isbfsar_tpu_torch.train import posestack as ps

    return {
        "pose-ci-motions": Spec(ps._CI_KEY_V[1], ps._CI_KEY_V[0], ps.ci_pose_params),
        "pose-ci-diverse": Spec(ps._DIVERSE_KEY_V[1], ps._DIVERSE_KEY_V[0],
                                ps.diverse_pose_params),
        "pose-diverse-256": Spec(ps._DIVERSE256_KEY_V[1], ps._DIVERSE256_KEY_V[0],
                                 ps.diverse_pose_params_256),
        "focus-ci": Spec(gf._CI_FOCUS_KEY_V[1], gf._CI_FOCUS_KEY_V[0], gf.ci_focus_params),
        "pose-prod-256": Spec(ps._PROD_KEY_V[1], ps._PROD_KEY_V[0], ps.prod_pose_params),
        "pose-prod-256-calib": Spec(ps._PROD_CALIB_KEY_V[1], ps._PROD_CALIB_KEY_V[0],
                                    ps.prod_detector_calib_delta),
        "pose-ci-calib": Spec(ps._CI_CALIB_KEY_V[1], ps._CI_CALIB_KEY_V[0],
                              ps.ci_detector_calib_delta),
    }


def _bundle_manifest() -> Dict[str, Dict[str, str]]:
    """The shared bundle's manifest, empty where there is none."""
    if not os.path.exists(os.path.join(pretrained_bundle_dir(), "MANIFEST.json")):
        return {}
    return manifest()


def available() -> Dict[str, str]:
    """name -> description of every manifest entry whose file is present."""
    d = pretrained_bundle_dir()
    return {name: meta.get("description", "") for name, meta in _bundle_manifest().items()
            if os.path.exists(os.path.join(d, meta["file"]))}


def verify() -> Dict[str, str]:
    """name -> digest when the bundle and the registry agree both ways:
    every manifest entry's file is the digest of its fixture's live key,
    and every registered fixture is in the manifest. Raises naming the
    stale and the unbundled entries otherwise."""
    specs, manifest_ = _specs(), _bundle_manifest()
    stale, out = [], {}
    for name, meta in manifest_.items():
        spec = specs.get(name)
        digest = params_cache_digest(spec.key(), spec.version) if spec else None
        if spec is None or f"{digest}.msgpack" != meta["file"]:
            stale.append(name)
        else:
            out[name] = digest
    unbundled = sorted(set(specs) - set(manifest_))
    if stale or unbundled:
        raise AssertionError(
            f"pretrained bundle out of sync: stale entries {stale} (trainer keys or budgets "
            f"moved since the bundle was built), specs missing from the manifest {unbundled}")
    return out


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


def convert_focus(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A focus bundle ``{"face_det", "lm_refiner", "gaze_net"}`` (``focus-ci``)
    -> state dicts of ``BlazeFaceLite``, ``LandmarkRefiner`` and ``GazeNet``."""
    return {k: convert_variables(params[k]) for k in ("face_det", "lm_refiner", "gaze_net")}


def to_flax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The inverse of :func:`convert_variables`: a port module's state dict
    -> Flax variables ``{"params": ...}`` (plus ``"batch_stats"`` where the
    module has BatchNorm statistics), with CPU tensor leaves and keys in
    Flax's order."""
    out: Dict[str, Dict] = {}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        t = t.detach().cpu()
        collection = "params"
        if name == "weight" and t.ndim == 4:
            t, name = t.permute(2, 3, 1, 0), "kernel"
        elif name == "weight" and t.ndim == 2:
            t, name = t.t(), "kernel"
        elif name == "weight" and "norm" in mod[-1]:
            name = "scale"  # LayerNorm
        elif name in ("mean", "var"):
            collection = "batch_stats"
        node = out.setdefault(collection, {})
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = t.contiguous()
    return _sorted(out)


def _sorted(tree):
    """Keys sorted at every level, the order Flax writes parameter trees in."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return leaf.dtype.name


def _leaf_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


class _Writer:
    """Minimal msgpack encoder that picks each type's shortest form, as the
    msgpack package does, so a decoded Flax file encodes to the same bytes."""

    def __init__(self):
        self.parts = []

    def _head(self, n: int, small: int, small_max: int, wide: tuple) -> None:
        """A length header: ``small | n`` up to ``small_max``, else the first
        of ``wide``'s (type byte, struct format, limit) that holds n."""
        if small is not None and n <= small_max:
            self.parts.append(bytes([small | n]))
            return
        for code, fmt, limit in wide:
            if n <= limit:
                self.parts.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack object of length {n} is too long")

    def value(self, v) -> None:
        if v is None:
            self.parts.append(b"\xc0")
        elif v is True or v is False:
            self.parts.append(b"\xc3" if v else b"\xc2")
        elif isinstance(v, int):
            self._int(v)
        elif isinstance(v, float):
            self.parts.append(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            self._head(len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                            (0xDB, ">I", 0xFFFFFFFF)))
            self.parts.append(raw)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            raw = bytes(v)
            self._head(len(raw), None, -1, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                            (0xC6, ">I", 0xFFFFFFFF)))
            self.parts.append(raw)
        elif isinstance(v, Mapping):
            self._head(len(v), 0x80, 15, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
            for k, x in v.items():
                self.value(str(k))
                self.value(x)
        elif isinstance(v, (list, tuple)):
            self._head(len(v), 0x90, 15, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
            for x in v:
                self.value(x)
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            self._ext(_NDARRAY_EXT, v)
        elif isinstance(v, np.generic):
            self._ext(_NPSCALAR_EXT, np.asarray(v))
        else:
            raise TypeError(f"cannot write {type(v).__name__} to msgpack")

    def _int(self, n: int) -> None:
        if 0 <= n <= 0x7F:
            self.parts.append(bytes([n]))
        elif -32 <= n < 0:
            self.parts.append(struct.pack(">b", n))
        elif n >= 0:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                     (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
                if n <= limit:
                    self.parts.append(bytes([code]) + struct.pack(fmt, n))
                    return
            raise ValueError(f"integer {n} does not fit msgpack")
        else:
            for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                     (0xD2, ">i", -0x80000000), (0xD3, ">q", -2**63)):
                if n >= limit:
                    self.parts.append(bytes([code]) + struct.pack(fmt, n))
                    return
            raise ValueError(f"integer {n} does not fit msgpack")

    def _ext(self, code: int, leaf) -> None:
        inner = _Writer()
        inner.value([list(leaf.shape), _dtype_name(leaf), _leaf_bytes(leaf)])
        payload = b"".join(inner.parts)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.parts.append(bytes([fixext[n]]))
        else:
            self._head(n, None, -1, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                     (0xC9, ">I", 0xFFFFFFFF)))
        self.parts.append(struct.pack(">b", code) + payload)


def msgpack_dumps(tree: Any) -> bytes:
    """Encode a tree of dicts with str keys and tensor or numpy leaves as
    Flax msgpack (array leaves are ext type 1, ``(shape, dtype, bytes)``);
    :func:`msgpack_restore` reads it back bit for bit."""
    writer = _Writer()
    writer.value(tree)
    return b"".join(writer.parts)
