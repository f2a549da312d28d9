"""ctypes bindings for the native shared-memory frame queue (port of
``isbfsar_tpu/runtime/native/``; ``shm_queue.cpp`` is a copy of its source).

The library is built with ``g++ -O2 -shared -fPIC shm_queue.cpp -lpthread
-lrt`` at first use into ``build/isbfsar_tpu_torch/`` beside the package,
as ``ops/build.py`` builds the CUDA kernels, never next to the source. Its
file name carries the source's SHA-256, so a library built from an older
``shm_queue.cpp`` is never loaded: the JAX package's source-hash staleness
check, without a sidecar file. See shm_queue.cpp for the role of this
transport in the runtime.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from typing import Any, Dict, Optional, Tuple

import numpy as np

from isbfsar_tpu_torch.ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shm_queue.cpp")

_lib: Optional[ctypes.CDLL] = None


def library_path(src: str = SRC) -> str:
    """Where the library of this exact source lives."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libshmq-{digest}.so")


def build_library(force: bool = False, src: str = SRC) -> str:
    """Compile ``src`` with g++ unless a library of this exact source exists;
    returns its path. The build writes a temporary file and renames it, so
    processes building at once never load a half-written library."""
    lib = library_path(src)
    if force or not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", src, "-o", tmp, "-lpthread", "-lrt"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        # a leftover library that does not load (a truncated file, another
        # ABI) is rebuilt instead of failing opaquely
        try:
            lib = ctypes.CDLL(build_library())
        except OSError:
            lib = ctypes.CDLL(build_library(force=True))
        lib.shmq_create.restype = ctypes.c_void_p
        lib.shmq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.shmq_open.restype = ctypes.c_void_p
        lib.shmq_open.argtypes = [ctypes.c_char_p]
        lib.shmq_push.restype = ctypes.c_int
        lib.shmq_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
        lib.shmq_push2.restype = ctypes.c_int
        lib.shmq_push2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.shmq_pop.restype = ctypes.c_int64
        lib.shmq_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
        lib.shmq_size.restype = ctypes.c_uint32
        lib.shmq_size.argtypes = [ctypes.c_void_p]
        lib.shmq_slot_size.restype = ctypes.c_uint64
        lib.shmq_slot_size.argtypes = [ctypes.c_void_p]
        lib.shmq_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class ShmQueueError(RuntimeError):
    pass


class ShmQueueTimeout(ShmQueueError):
    pass


class ShmBytesQueue:
    """Capacity-N blocking byte queue in POSIX shared memory."""

    def __init__(self, name: str, slot_size: int = 0, capacity: int = 1, create: bool = True):
        lib = _load()
        self.name = name.encode()
        if create:
            self._h = lib.shmq_create(self.name, slot_size, capacity)
        else:
            self._h = lib.shmq_open(self.name)
        if not self._h:
            raise ShmQueueError(f"cannot {'create' if create else 'open'} shm queue {name!r}")
        self._lib = lib
        # Openers adopt the segment's REAL slot size (the creator picked
        # it); a caller-guessed size would mis-bound put/get and only fail
        # later with an opaque push/pop error.
        self.slot_size = int(lib.shmq_slot_size(self._h)) if not create else slot_size

    def put(self, data: bytes, timeout_ms: int = 60_000) -> None:
        rc = self._lib.shmq_push(self._h, data, len(data), timeout_ms)
        if rc == -1:
            raise ShmQueueTimeout("push timed out (queue full)")
        if rc != 0:
            raise ShmQueueError(f"push failed (payload {len(data)} bytes)")

    def get(self, max_size: int, timeout_ms: int = 60_000) -> bytes:
        buf = ctypes.create_string_buffer(max_size)
        n = self._lib.shmq_pop(self._h, buf, max_size, timeout_ms)
        if n == -1:
            raise ShmQueueTimeout("pop timed out (queue empty)")
        if n < 0:
            raise ShmQueueError("pop failed")
        return buf.raw[:n]

    def qsize(self) -> int:
        return int(self._lib.shmq_size(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.shmq_close(self._h)
            self._h = None


class ShmFrameQueue:
    """Frame + message transport over the native ring (reference
    ``{rgb, msg}`` dict contract, source.py:51 / main.py:69).

    Wire layout per slot: [4-byte meta length][meta JSON][frame bytes].
    """

    def __init__(self, name: str, frame_shape: Tuple[int, int, int],
                 capacity: int = 1, create: bool = True, meta_size: int = 4096):
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        self.meta_size = meta_size
        self._slot = 4 + meta_size + self.frame_bytes
        self._q = ShmBytesQueue(name, self._slot, capacity, create)
        if not create and self._q.slot_size != self._slot:
            # Geometry handshake: the creator sized the ring for ITS frame
            # shape; a different opener shape means the two processes
            # disagree on the camera resolution. Failing here names the
            # cause — otherwise a larger frame dies later as an opaque
            # "push failed" and a smaller one as a reshape error on the
            # consumer side.
            seg = self._q.slot_size - 4 - meta_size
            self._q.close()
            raise ShmQueueError(
                f"shm ring {name!r} was created for {seg}-byte frames but "
                f"this side opened it for shape {self.frame_shape} "
                f"({self.frame_bytes} bytes) — the serve config's cam "
                f"height/width and the actual source frames disagree"
            )

        self._recv_buf = np.empty(self._slot, np.uint8)  # reused pop target

    def put(self, frame: Optional[np.ndarray], msg: str = "",
            extra: Optional[Dict[str, Any]] = None, timeout_ms: int = 60_000) -> None:
        meta = json.dumps({"msg": msg, "has_frame": frame is not None, **(extra or {})}).encode()
        if len(meta) > self.meta_size:
            raise ShmQueueError("meta too large")
        header = len(meta).to_bytes(4, "little") + meta
        lib = _load()
        if frame is not None:
            frame = np.ascontiguousarray(frame, dtype=np.uint8)
            if frame.shape != self.frame_shape:
                raise ShmQueueError(f"frame shape {frame.shape} != {self.frame_shape}")
            # zero host-side concatenation: the frame goes straight from the
            # numpy buffer into the shared ring
            rc = lib.shmq_push2(
                self._q._h, header, len(header),
                frame.ctypes.data_as(ctypes.c_void_p), frame.nbytes, timeout_ms,
            )
        else:
            rc = lib.shmq_push2(self._q._h, header, len(header), None, 0, timeout_ms)
        if rc == -1:
            raise ShmQueueTimeout("push timed out (queue full)")
        if rc != 0:
            raise ShmQueueError("push failed")

    def get(self, timeout_ms: int = 60_000) -> Dict[str, Any]:
        lib = _load()
        buf = self._recv_buf
        n = lib.shmq_pop(
            self._q._h, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes, timeout_ms
        )
        if n == -1:
            raise ShmQueueTimeout("pop timed out (queue empty)")
        if n < 0:
            raise ShmQueueError("pop failed")
        mlen = int.from_bytes(buf[:4].tobytes(), "little")
        meta = json.loads(buf[4 : 4 + mlen].tobytes())
        out: Dict[str, Any] = {"msg": meta.get("msg", "")}
        out.update({k: v for k, v in meta.items() if k not in ("msg", "has_frame")})
        if meta.get("has_frame"):
            out["rgb"] = buf[4 + mlen : int(n)].reshape(self.frame_shape).copy()
        return out

    def qsize(self) -> int:
        return self._q.qsize()

    def close(self) -> None:
        self._q.close()
