"""The port's profiling helpers (``utils/profiling.py``) against JAX's, as
tests/test_misc.py holds JAX's: ``FpsCounter`` and ``Stopwatch`` under a
patched clock give JAX's readings and summaries exactly, ``trace`` writes a
Chrome trace of the block (also when the block raises), and
``device_memory_stats()`` is ``{}`` without a card, as JAX's CPU backend
gives. Tolerance: none, the clocks are patched."""

import json
import os

import pytest
import torch

from isbfsar_tpu.utils import profiling as jp
from isbfsar_tpu_torch.utils import profiling as tp

TICKS = [10.0, 10.04, 10.05, 10.09, 10.2, 10.2, 10.21, 11.0]


class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def _fps_readings(module, monkeypatch, window):
    monkeypatch.setattr(module.time, "time", _Clock(TICKS))
    c = module.FpsCounter(window=window)
    return [c.tick() for _ in TICKS], c.fps


@pytest.mark.parametrize("window", [1, 3, 10])
def test_fps_counter_equals_jax(monkeypatch, window):
    got = _fps_readings(tp, monkeypatch, window)
    want = _fps_readings(jp, monkeypatch, window)
    assert got == want
    assert got[0][0] == 0.0 and got[0][1] == pytest.approx(25.0)


def _summary(module, monkeypatch):
    # perf_counter pairs (start, end): spans of 5, 7, 2 ms on "a" and 1 ms on "b"
    ends = [0.0, 0.005, 1.0, 1.007, 2.0, 2.002, 3.0, 3.001]
    monkeypatch.setattr(module.time, "perf_counter", _Clock(ends))
    sw = module.Stopwatch()
    for name in ("a", "a", "a", "b"):
        with sw.span(name):
            pass
    return sw.summary()


def test_stopwatch_summary_equals_jax(monkeypatch):
    got, want = _summary(tp, monkeypatch), _summary(jp, monkeypatch)
    assert got == want
    assert got["a"]["count"] == 3 and got["b"]["count"] == 1
    assert got["a"]["p50_ms"] == pytest.approx(5.0)


def test_stopwatch_records_a_span_that_raises():
    sw = tp.Stopwatch()
    with pytest.raises(ValueError):
        with sw.span("x"):
            raise ValueError
    assert sw.summary()["x"]["count"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with tp.trace(str(tmp_path)) as prof:
        y = torch.mm(x, x) * 2
    assert float(y[0, 0]) == 128.0
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_trace_writes_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with tp.trace(str(tmp_path / "t")):
            torch.ones(3).sum()
            raise RuntimeError("inside the trace")
    assert len(os.listdir(tmp_path / "t")) == 1


def test_device_memory_stats_empty_without_a_card():
    assert not torch.cuda.is_available()
    assert tp.device_memory_stats() == {}
    assert jp.device_memory_stats() == {}
