"""Raw-TCP camera streaming utilities (port of ``isbfsar_tpu/runtime/stream.py``).

Rebuild of the reference's socket tools used to bridge cameras across
machine boundaries (reference utils/stream_camera_in_socket.py:1-31,
forward_from_socket_to_socket.py:1-33, visualize_image_from_socket.py:1-27,
record_video.py:1-23): stream frames over a raw TCP socket, forward between
two sockets, view a stream, record a source to a video file.

Wire format: [8-byte little-endian length][JPEG bytes] per frame — bounded
and self-synchronizing (the reference sends raw fixed-size buffers; JPEG
keeps WSL/Windows-class links under control at 640x480x30fps). The wire
format is JAX's, byte for byte, so either package's end talks to the other's.

Host-only: JPEG coding and video writing need cv2, which ``send_frame``,
``recv_frame`` and ``record_source`` import when called. The card machine
has no cv2, so this module runs on the camera's host, never beside the
card; there those three raise ``ImportError``.
"""

from __future__ import annotations

import socket
import struct
from typing import Iterator, Optional

import numpy as np

_LEN = struct.Struct("<Q")


def send_frame(sock: socket.socket, frame: np.ndarray, quality: int = 90) -> None:
    import cv2

    ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError("jpeg encode failed")
    data = buf.tobytes()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> Optional[np.ndarray]:
    import cv2

    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    data = _recv_exact(sock, length)
    if data is None:
        return None
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def iter_frames(sock: socket.socket) -> Iterator[np.ndarray]:
    while True:
        frame = recv_frame(sock)
        if frame is None:
            return
        yield frame


def stream_source(source, host: str, port: int, max_frames: Optional[int] = None) -> int:
    """Stream a source's frames to host:port (reference stream_camera_in_socket)."""
    sock = socket.create_connection((host, port))
    n = 0
    try:
        while max_frames is None or n < max_frames:
            ok, frame = source.read()
            if not ok:
                break
            send_frame(sock, frame)
            n += 1
    finally:
        sock.close()
    return n


def serve_frames(port: int, handler, max_frames: Optional[int] = None, host: str = "0.0.0.0") -> int:
    """Accept one client and pass each frame to handler(frame)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    conn, _ = srv.accept()
    n = 0
    try:
        for frame in iter_frames(conn):
            handler(frame)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    finally:
        conn.close()
        srv.close()
    return n


def forward(listen_port: int, dst_host: str, dst_port: int,
            max_frames: Optional[int] = None) -> int:
    """Relay frames between sockets (reference forward_from_socket_to_socket)."""
    dst = socket.create_connection((dst_host, dst_port))

    def handler(frame):
        send_frame(dst, frame)

    try:
        return serve_frames(listen_port, handler, max_frames)
    finally:
        dst.close()


def record_source(source, out_path: str, fps: float = 30.0,
                  max_frames: Optional[int] = None) -> int:
    """Record a source to a video file (reference record_video.py)."""
    import cv2

    ok, frame = source.read()
    if not ok:
        return 0
    h, w = frame.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    n = 0
    try:
        while ok:
            writer.write(frame)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
            ok, frame = source.read()
    finally:
        writer.release()
    return n
