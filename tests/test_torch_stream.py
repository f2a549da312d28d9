"""The port's TCP frame stream (``runtime/stream.py``) against JAX's: the same
frame gives the same bytes on the wire (an 8-byte little-endian length, then
the JPEG), each package decodes the other's frames to the same pixels, a
source streamed by one package over TCP is served by the other's
``serve_frames``, and ``record_source`` writes the same frame count and
frames. Tolerance: none, every comparison is exact (both packages call the
same cv2 codec)."""

import socket
import threading

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from isbfsar_tpu.runtime import stream as js  # noqa: E402
from isbfsar_tpu_torch.runtime import stream as ts  # noqa: E402
from isbfsar_tpu_torch.runtime.source import SyntheticSource  # noqa: E402

DEADLINE_S = 30


def _frames(n=4):
    src = SyntheticSource(160, 120)
    return [src.read()[1] for _ in range(n)]


def _wire(module, frame) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        module.send_frame(a, frame)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
    return b"".join(chunks)


@pytest.mark.parametrize("sender,receiver", [(ts, js), (js, ts), (ts, ts)],
                         ids=["port-to-jax", "jax-to-port", "port-to-port"])
def test_socket_round_trip(sender, receiver):
    frames = _frames()
    a, b = socket.socketpair()
    a.settimeout(DEADLINE_S)
    b.settimeout(DEADLINE_S)
    with a, b:
        for f in frames:
            sender.send_frame(a, f)
        a.shutdown(socket.SHUT_WR)
        got = list(receiver.iter_frames(b))
    want = [cv2.imdecode(np.frombuffer(_wire(js, f)[8:], np.uint8), cv2.IMREAD_COLOR)
            for f in frames]
    assert len(got) == len(frames)
    for g, w in zip(got, want):
        assert g.shape == (120, 160, 3) and np.array_equal(g, w)


def test_same_bytes_on_the_wire():
    for f in _frames():
        port, jax_ = _wire(ts, f), _wire(js, f)
        assert port == jax_
        assert int.from_bytes(port[:8], "little") == len(port) - 8
        assert port[8:10] == b"\xff\xd8"  # a JPEG


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("streamer,server", [(ts, js), (js, ts)],
                         ids=["port-streams", "jax-streams"])
def test_stream_source_over_tcp(streamer, server):
    port = _free_port()
    got, done = [], []

    def serve():
        done.append(server.serve_frames(port, got.append, max_frames=5, host="127.0.0.1"))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    n = None
    for _ in range(200):  # until the listener is up; its one accept takes this stream
        try:
            n = streamer.stream_source(SyntheticSource(160, 120), "127.0.0.1", port, max_frames=5)
            break
        except ConnectionRefusedError:
            t.join(0.05)
    t.join(DEADLINE_S)
    assert not t.is_alive() and n == 5 and done[-1] == 5
    want = [cv2.imdecode(np.frombuffer(_wire(js, f)[8:], np.uint8), cv2.IMREAD_COLOR)
            for f in _frames(5)]
    assert len(got) == 5 and all(np.array_equal(g, w) for g, w in zip(got, want))


def _read_video(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def test_record_source(tmp_path):
    n_t = ts.record_source(SyntheticSource(160, 120), str(tmp_path / "t.mp4"), max_frames=6)
    n_j = js.record_source(SyntheticSource(160, 120), str(tmp_path / "j.mp4"), max_frames=6)
    assert n_t == n_j == 6
    a, b = _read_video(str(tmp_path / "t.mp4")), _read_video(str(tmp_path / "j.mp4"))
    assert len(a) == len(b) == 6
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
