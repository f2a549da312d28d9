"""The port's native shared-memory queue: twins of tests/test_native.py
(build, the queue contract, cross-process use, the shm service transport),
without its throughput test. The library builds into ``build/`` beside the
package, named by its source's hash. The shared-memory names carry
"torch" and the process id: the JAX package's tests run beside these and a
creator unlinks a segment of the same name."""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest

from isbfsar_tpu_torch.runtime.native import (
    ShmBytesQueue,
    ShmFrameQueue,
    ShmQueueTimeout,
    SRC,
    build_library,
    library_path,
)
from isbfsar_tpu_torch.ops.build import BUILD_DIR


def _name(base: str) -> str:
    return f"/isbfsar_torch_{os.getpid()}_{base}"


class TestBuild:
    def test_builds_into_the_build_directory(self):
        lib = build_library()
        assert os.path.dirname(lib) == BUILD_DIR
        assert os.path.basename(lib) == os.path.basename(library_path())
        assert os.path.basename(lib).startswith("libshmq-") and lib.endswith(".so")
        assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(SRC)))

    def test_a_changed_source_gets_its_own_library(self, tmp_path):
        src = tmp_path / "shm_queue.cpp"
        src.write_text(open(SRC).read() + "\n// changed\n")
        assert library_path(str(src)) != library_path()
        lib = build_library(src=str(src))
        try:
            assert os.path.exists(lib) and lib == library_path(str(src))
        finally:
            os.remove(lib)


class TestBytesQueue:
    def test_fifo_roundtrip(self):
        q = ShmBytesQueue(_name("fifo"), slot_size=64, capacity=4)
        try:
            for i in range(4):
                q.put(f"item{i}".encode())
            assert q.qsize() == 4
            for i in range(4):
                assert q.get(64) == f"item{i}".encode()
        finally:
            q.close()

    def test_capacity_blocking_timeout(self):
        q = ShmBytesQueue(_name("cap"), slot_size=16, capacity=1)
        try:
            q.put(b"one")
            with pytest.raises(ShmQueueTimeout):
                q.put(b"two", timeout_ms=50)
            assert q.get(16) == b"one"
            with pytest.raises(ShmQueueTimeout):
                q.get(16, timeout_ms=50)
        finally:
            q.close()


def _producer(name: str, n_frames: int, shape):
    from isbfsar_tpu_torch.runtime.native import ShmFrameQueue

    q = ShmFrameQueue(name, shape, capacity=1, create=False)
    for i in range(n_frames):
        frame = np.full(shape, i, np.uint8)
        q.put(frame, msg=f"m{i}")
    q.close()


class TestFrameQueue:
    def test_frame_roundtrip(self):
        shape = (48, 64, 3)
        q = ShmFrameQueue(_name("rt"), shape, capacity=2)
        try:
            frame = np.random.default_rng(0).integers(0, 255, shape).astype(np.uint8)
            q.put(frame, msg="add wave -focus", extra={"seq": 7})
            out = q.get()
            np.testing.assert_array_equal(out["rgb"], frame)
            assert out["msg"] == "add wave -focus"
            assert out["seq"] == 7
        finally:
            q.close()

    def test_message_only(self):
        q = ShmFrameQueue(_name("msg"), (8, 8, 3), capacity=1)
        try:
            q.put(None, msg="quit")
            out = q.get()
            assert out["msg"] == "quit" and "rgb" not in out
        finally:
            q.close()

    def test_cross_process_backpressure(self):
        shape = (32, 32, 3)
        q = ShmFrameQueue(_name("frames"), shape, capacity=1)
        try:
            proc = mp.get_context("spawn").Process(target=_producer,
                                                   args=(_name("frames"), 5, shape))
            proc.start()
            got = []
            for _ in range(5):
                out = q.get(timeout_ms=30_000)
                got.append((int(out["rgb"][0, 0, 0]), out["msg"]))
            proc.join(timeout=30)
            assert proc.exitcode == 0
            assert got == [(i, f"m{i}") for i in range(5)]  # FIFO across processes
            assert q.qsize() == 0
        finally:
            q.close()


class TestShmTransport:
    """The same-host service transport (runtime/shm_transport.py): the
    ``--hub shm`` path replacing the TCP hub for co-located processes."""

    def test_object_queue_ndarray_bitexact(self):
        from isbfsar_tpu_torch.runtime.shm_transport import ShmObjectQueue

        q = ShmObjectQueue(_name("obj"), slot_size=1 << 20)
        try:
            elements = {
                "img": np.arange(48, dtype=np.uint8).reshape(4, 4, 3),
                "pose": np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32),
                "actions": {"wave": 0.75},
                "is_true": 0.5,
                "log": "hello",
            }
            q.put(elements)
            out = q.get()
            np.testing.assert_array_equal(out["img"], elements["img"])
            np.testing.assert_array_equal(out["pose"], elements["pose"])
            assert out["pose"].dtype == np.float32
            assert out["actions"] == {"wave": 0.75}
            assert out["log"] == "hello"
        finally:
            q.close()

    def test_object_queue_rejects_oversize(self):
        from isbfsar_tpu_torch.runtime.native import ShmQueueError
        from isbfsar_tpu_torch.runtime.shm_transport import ShmObjectQueue

        q = ShmObjectQueue(_name("obj_small"), slot_size=256)
        try:
            with pytest.raises(ShmQueueError, match="slot"):
                q.put(np.zeros(4096, np.uint8))
        finally:
            q.close()

    def test_run_source_over_shm(self, monkeypatch):
        """run_source(hub_host='shm') against a compute loop on the serve
        channels: frames arrive zero-copy, elements (ndarray fields intact)
        come back, 'quit' terminates — the full transport contract without
        a hub process. Both loops run in threads with a deadline."""
        from isbfsar_tpu_torch.runtime import shm_transport
        from isbfsar_tpu_torch.runtime.source import SyntheticSource, run_source

        # run_source opens the default channel names: make them this test's
        monkeypatch.setattr(shm_transport, "SRC2SRV", _name("src2srv")[1:])
        monkeypatch.setattr(shm_transport, "SRV2SRC", _name("srv2src")[1:])
        shape = (48, 64, 3)
        in_q, out_q = shm_transport.serve_queues(shape)
        stopped = threading.Event()

        def compute():
            while True:
                d = in_q.get()
                if d.get("msg") in ("quit", "close", "exit", "q"):
                    stopped.set()
                    return
                out_q.put({
                    "img": d["rgb"],
                    "pose": np.full((30, 3), 0.5, np.float32),
                    "actions": {"a": 1.0},
                    "fps": 1.0,
                })

        shown, pushed = [], []

        class Viz:
            def show(self, elements):
                shown.append(elements)

        def commands():
            for i in range(100):
                yield "quit" if i == 10 else ""

        def source():
            pushed.append(run_source(SyntheticSource(shape[1], shape[0]), hub_host="shm",
                                     visualizer=Viz(), command_stream=commands(),
                                     max_frames=50))

        threads = [threading.Thread(target=f, daemon=True) for f in (compute, source)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads), "the shm loop did not finish"
            assert stopped.is_set(), "compute loop never saw 'quit'"
            assert pushed == [11]  # 10 frames + the quit cycle
            assert len(shown) == 10
            assert shown[0]["img"].shape == shape
            np.testing.assert_array_equal(
                shown[0]["pose"], np.full((30, 3), 0.5, np.float32)
            )
            assert shown[0]["actions"] == {"a": 1.0}
        finally:
            in_q.close()
            out_q.close()

    def test_get_blocks_through_internal_timeouts(self):
        """The queue contract blocks indefinitely: a serve process idling
        past the ring's internal timeout must keep waiting, not raise
        (regression: ShmQueueTimeout leaked out of get() after 120 s)."""
        from isbfsar_tpu_torch.runtime.shm_transport import ShmFrameChannel

        ch = ShmFrameChannel(_name("block"), (8, 8, 3), create=True,
                             timeout_ms=100)
        try:
            def late_put():
                time.sleep(0.35)  # > 3 internal timeout cycles
                ch.put({"rgb": np.zeros((8, 8, 3), np.uint8), "msg": "late"})

            threading.Thread(target=late_put, daemon=True).start()
            out = ch.get()
            assert out["msg"] == "late"
        finally:
            ch.close()

    def test_put_blocks_through_internal_timeouts(self):
        """PUT blocks too (queue.Queue.put semantics): with the capacity-1
        slot full and the consumer pausing past the ring's internal timeout
        (a cold fused-program compile), the producer must keep waiting, not
        die with ShmQueueTimeout (regression: put raised after 120 s while
        serve was still warming up, killing the source process)."""
        from isbfsar_tpu_torch.runtime.shm_transport import ShmFrameChannel

        ch = ShmFrameChannel(_name("putblock"), (8, 8, 3), create=True,
                             timeout_ms=100)
        try:
            ch.put({"rgb": np.zeros((8, 8, 3), np.uint8), "msg": "first"})
            done = threading.Event()

            def second_put():
                # slot is full; the consumer won't drain for >3 timeout cycles
                ch.put({"rgb": np.ones((8, 8, 3), np.uint8), "msg": "second"})
                done.set()

            threading.Thread(target=second_put, daemon=True).start()
            time.sleep(0.35)
            assert not done.is_set()  # still (correctly) waiting, not dead
            assert ch.get()["msg"] == "first"
            assert ch.get()["msg"] == "second"
            assert done.wait(5.0)
        finally:
            ch.close()

    def test_elements_slot_fits_rgb_mode_payload(self):
        """The result slot must hold the rgb/hybrid elements dict: raw img
        PLUS the whitened AR crop (orchestrator.preprocess_ar_crop; float64
        below = the slot's 2x dtype headroom) — regression: slot was
        frame+256KB, and the ~1.2 MB crop overflowed it on the first
        detection."""
        from isbfsar_tpu_torch.runtime.shm_transport import ShmObjectQueue, _elements_slot

        shape = (480, 640, 3)
        q = ShmObjectQueue(_name("rgbslot"),
                           slot_size=_elements_slot(shape))
        try:
            elements = {
                "img": np.zeros(shape, np.uint8),
                "img_preprocessed": np.zeros((224, 224, 3), np.float64),
                "pose": np.zeros((30, 3), np.float32),
                "bbox": (1, 2, 3, 4),
                "actions": {"wave": 0.9},
                "is_true": 0.5,
                "requires_focus": {"wave": True},
                "fps": 30.0,
                "log": "x" * 200,
            }
            q.put(elements)
            out = q.get()
            assert out["img_preprocessed"].shape == (224, 224, 3)
        finally:
            q.close()

    def test_opener_adopts_segment_slot_size(self):
        """An opener must use the CREATOR's slot size, whatever it guessed —
        otherwise its put/get bounds disagree with the ring's real geometry."""
        from isbfsar_tpu_torch.runtime.shm_transport import ShmObjectQueue

        creator = ShmObjectQueue(_name("adopt"), slot_size=1 << 20)
        try:
            opener = ShmObjectQueue(_name("adopt"), create=False,
                                    slot_size=64)  # wrong guess, ignored
            assert opener.slot_size == 1 << 20
            big = np.zeros(300_000, np.uint8)  # > the 64-byte guess
            creator.put({"x": big})
            assert opener.get()["x"].nbytes == big.nbytes
            opener.close()
        finally:
            creator.close()

    def test_frame_ring_geometry_handshake(self):
        """Opening a frame ring with a different frame shape than it was
        created for must fail IMMEDIATELY with a message naming the
        resolution mismatch — not later as an opaque push/reshape error."""
        from isbfsar_tpu_torch.runtime.native import ShmFrameQueue, ShmQueueError

        creator = ShmFrameQueue(_name("geom"), (48, 64, 3), create=True)
        try:
            with pytest.raises(ShmQueueError, match="disagree"):
                ShmFrameQueue(_name("geom"), (480, 640, 3), create=False)
        finally:
            creator.close()
