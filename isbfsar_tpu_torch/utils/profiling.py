"""Tracing and profiling helpers (port of ``isbfsar_tpu/utils/profiling.py``).

The reference's observability is a 10-frame moving-average FPS counter and
ad-hoc ``time.time()`` spans (reference main.py:127-130,
check_homography_consistency.py:37-44). This module keeps that contract and
adds what the reference lacks:

- :class:`FpsCounter` — the reference's moving-average FPS
- :class:`Stopwatch` — named span timing with summary stats
- :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (``chrome://tracing``, Perfetto) of the host ops and, where
  a card is present, its kernels
- :func:`device_memory_stats` — live device memory per card
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch


class FpsCounter:
    """Moving-average FPS over the last ``window`` frames (main.py:127-130)."""

    def __init__(self, window: int = 10):
        self.window = window
        self._samples: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.time()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            self._samples.append(1.0 / dt)
            self._samples = self._samples[-self.window:]
        self._last = now
        return self.fps

    @property
    def fps(self) -> float:
        return sum(self._samples) / len(self._samples) if self._samples else 0.0


class Stopwatch:
    """Named span accumulator: ``with sw.span('yolo'): ...``; ``sw.summary()``.
    A span times the host: around work on the card, end it with
    ``torch.cuda.synchronize()`` or it reads the enqueue."""

    def __init__(self):
        self._spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for name, vals in self._spans.items():
            arr = np.asarray(vals) * 1000
            out[name] = {
                "count": len(vals),
                "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
            }
        return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format), written when the block
    ends, also by an exception. It records the host's ops, and the CUDA
    activity (kernel names and device times) when a card is present. Yields
    the profiler, whose ``key_averages()`` sum the block by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory in MB under JAX's keys: ``bytes_in_use_mb`` (the
    caching allocator's allocated bytes), ``peak_bytes_mb`` (their peak since
    the last ``torch.cuda.reset_peak_memory_stats``) and ``limit_mb`` (the
    card's total memory). Empty without a card, as JAX's CPU backend gives."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6,
            "limit_mb": total / 1e6,
        }
    return out
