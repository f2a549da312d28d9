"""Same-host service transport over the native shared-memory ring (port of
``isbfsar_tpu/runtime/shm_transport.py``).

The reference bridges its host and compute processes with a TCP
``BaseManager`` hub (reference manager.py:6-15) because they may live on
different machines (README.md:20-25 topology). On ONE host that costs four
pickle+TCP hops per frame cycle (source -> hub -> serve, serve -> hub ->
source). This module replaces the hub with the C++ robust-mutex ring
(runtime/native/shm_queue.cpp) for the co-located case, preserving the
capacity-1 blocking backpressure contract exactly:

- frames ride :class:`ShmFrameChannel` — the ``{rgb, msg}`` dict contract
  over the ZERO-COPY frame ring (numpy buffer -> shared memory, no pickling
  of the payload),
- results ride :class:`ShmObjectQueue` — whole ``elements`` dicts (numpy
  arrays included) pickled into a shared slot; still one memcpy and no
  sockets.

Select with ``--hub shm`` on BOTH ``runtime.serve`` and
``runtime.source_cli`` (or ``run_source(hub_host="shm")``). The serve
process CREATES the segments (it owns the compute side and starts first);
the source OPENS them, retrying while serve is still warming up. Cross-host
deployments keep the TCP hub — this is the fast path, not a replacement.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from isbfsar_tpu_torch.runtime.native import (
    ShmBytesQueue,
    ShmFrameQueue,
    ShmQueueError,
    ShmQueueTimeout,
)

SRC2SRV = "isbfsar_src2srv"
SRV2SRC = "isbfsar_srv2src"


def _name(prefix: str, base: str) -> str:
    """POSIX shm names must be one '/'-rooted path component."""
    return "/" + prefix + base
_DEFAULT_TIMEOUT_MS = 120_000  # covers a long warm-up pause


class ShmFrameChannel:
    """Queue-compatible ``{rgb, msg}`` channel over the zero-copy ring."""

    def __init__(self, name: str, frame_shape: Tuple[int, int, int],
                 create: bool, timeout_ms: int = _DEFAULT_TIMEOUT_MS):
        self._q = ShmFrameQueue(name, frame_shape, capacity=1, create=create)
        self._timeout_ms = timeout_ms

    def put(self, data: Dict[str, Any]) -> None:
        # blocking-queue contract on BOTH ends (queue.Queue semantics): the
        # consumer may legitimately pause for minutes mid-stream (warm-up
        # and graph capture) with the capacity-1 slot full — retry
        # through the ring's internal timeout instead of raising
        extra = {k: v for k, v in data.items() if k not in ("rgb", "msg")}
        while True:
            try:
                return self._q.put(data.get("rgb"), data.get("msg", ""),
                                   extra=extra or None,
                                   timeout_ms=self._timeout_ms)
            except ShmQueueTimeout:
                continue

    def get(self) -> Dict[str, Any]:
        # the hub contract blocks indefinitely (queue.Queue.get) — a serve
        # process may legitimately idle for minutes before a source starts,
        # so retry through the ring's internal timeout instead of raising
        while True:
            try:
                return self._q.get(timeout_ms=self._timeout_ms)
            except ShmQueueTimeout:
                continue

    def close(self) -> None:
        self._q.close()


class ShmObjectQueue:
    """Capacity-1 blocking queue of pickled Python objects in shared memory.

    Carries the service's ``elements`` dicts (ndarray fields survive the
    pickle round-trip bit-exactly, unlike a JSON meta encoding). Slot size
    must hold the largest object — default fits a 480x640 BGR frame plus
    every per-frame field with headroom.
    """

    def __init__(self, name: str, slot_size: int = 2 << 20, capacity: int = 1,
                 create: bool = True, timeout_ms: int = _DEFAULT_TIMEOUT_MS):
        self._q = ShmBytesQueue(name, slot_size if create else 0,
                                capacity, create)
        # openers adopt the segment's REAL slot size (the creator picked it)
        self.slot_size = self._q.slot_size
        self._timeout_ms = timeout_ms

    def put(self, obj: Any) -> None:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if len(data) > self.slot_size:
            raise ShmQueueError(
                f"object pickles to {len(data)} bytes > slot {self.slot_size}"
            )
        while True:  # blocking queue contract — see ShmFrameChannel.put
            try:
                return self._q.put(data, timeout_ms=self._timeout_ms)
            except ShmQueueTimeout:
                continue

    def get(self) -> Any:
        while True:  # blocking queue contract — see ShmFrameChannel.get
            try:
                return pickle.loads(self._q.get(self.slot_size,
                                                timeout_ms=self._timeout_ms))
            except ShmQueueTimeout:
                continue

    def close(self) -> None:
        self._q.close()


def _elements_slot(frame_shape: Tuple[int, int, int],
                   rgb_size: int = 224) -> int:
    # Sized for the LARGEST elements dict: rgb/hybrid frames carry BOTH the
    # raw img (frame bytes) and img_preprocessed — a whitened float32
    # (rgb_size, rgb_size, 3) crop (orchestrator.preprocess_ar_crop); the
    # budget keeps 8 bytes/px (2x headroom) so a future dtype change can't
    # silently overflow — plus pose/probs/strings in the slack. Shared
    # memory is cheap at capacity 1; undersizing fails the serve loop on
    # its first detection.
    return int(np.prod(frame_shape)) + (8 * rgb_size * rgb_size * 3) + (512 << 10)


def serve_queues(frame_shape: Tuple[int, int, int] = (480, 640, 3),
                 prefix: str = "", rgb_size: int = 224):
    """Create both channels (serve side). Returns (in_q, out_q) with the
    orchestrator's queue contract: ``in_q.get() -> {rgb, msg}``,
    ``out_q.put(elements)``. ``rgb_size`` sizes the result slot for the
    AR crop the elements carry in rgb/hybrid modes (ARConfig.rgb_size)."""
    in_q = ShmFrameChannel(_name(prefix, SRC2SRV), frame_shape, create=True)
    out_q = ShmObjectQueue(
        _name(prefix, SRV2SRC),
        slot_size=_elements_slot(frame_shape, rgb_size), create=True)
    return in_q, out_q


def source_queues(frame_shape: Tuple[int, int, int] = (480, 640, 3),
                  prefix: str = "", wait_s: float = 600.0):
    """Open both channels (source side), waiting for serve to create them
    (warm-up can take minutes — keep retrying).
    Returns (to_compute, from_compute)."""
    deadline = time.time() + wait_s
    while True:
        try:
            to_compute = ShmFrameChannel(_name(prefix, SRC2SRV), frame_shape,
                                         create=False)
            break
        except ShmQueueError:
            if time.time() > deadline:
                raise ShmQueueError(
                    f"shm channel {_name(prefix, SRC2SRV)} not created "
                    f"within {wait_s:.0f}s — is `python -m isbfsar_tpu_torch."
                    f"runtime.serve --hub shm` running on this host?"
                )
            time.sleep(0.5)
    # slot size is adopted from the segment the serve side created
    from_compute = ShmObjectQueue(_name(prefix, SRV2SRC), create=False)
    return to_compute, from_compute
