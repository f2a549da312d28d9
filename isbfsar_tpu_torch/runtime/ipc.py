"""IPC hub: named capacity-1 blocking queues over TCP (a copy of
``isbfsar_tpu/runtime/ipc.py``, which imports no JAX; the port keeps its own).

Rebuild of the reference's communication backend (reference manager.py:6-15,
main.py:43-47, source.py:25-30): a ``BaseManager`` TCP server exposing named
``Queue(1)`` objects (``source_human``: host -> compute, ``human_sink``:
compute -> host) on port 50000 with a shared authkey, bridging the
host <-> container boundary. The capacity-1 blocking semantics provide
lock-step backpressure between the camera loop and the compute loop — that
contract is preserved exactly.

Python-side transport uses the stdlib manager protocol (pickle framing is
the reference's wire contract); the intra-process stand-in is
:class:`LocalQueuePair`. Co-located source and serve processes can skip
this hub: ``--hub shm`` on both sides routes the same queue contract over
the C++ shared-memory ring (runtime/shm_transport.py).
"""

from __future__ import annotations

import queue
import threading
from multiprocessing.managers import BaseManager
from typing import Dict, Optional

DEFAULT_PORT = 50000
DEFAULT_AUTHKEY = b"isbfsar-tpu"


class _QueueRegistry:
    def __init__(self):
        self._queues: Dict[str, queue.Queue] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> queue.Queue:
        with self._lock:
            if name not in self._queues:
                self._queues[name] = queue.Queue(maxsize=1)
            return self._queues[name]


class QueueHub:
    """Serve named capacity-1 queues over TCP (reference manager.py role)."""

    def __init__(self, address=("0.0.0.0", DEFAULT_PORT), authkey: bytes = DEFAULT_AUTHKEY):
        registry = _QueueRegistry()

        class _Manager(BaseManager):
            pass

        _Manager.register("get_queue", callable=registry.get)
        self._manager = _Manager(address=address, authkey=authkey)
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self.registry = registry

    def start_background(self) -> "QueueHub":
        self._server = self._manager.get_server()
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._manager.get_server().serve_forever()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop_event.set()


class QueueClient:
    """Connect to a hub and fetch named queues (reference main.py:43-47)."""

    def __init__(self, host: str = "localhost", port: int = DEFAULT_PORT,
                 authkey: bytes = DEFAULT_AUTHKEY):
        class _Manager(BaseManager):
            pass

        _Manager.register("get_queue")
        self._manager = _Manager(address=(host, port), authkey=authkey)
        self._manager.connect()

    def get_queue(self, name: str):
        return self._manager.get_queue(name)


class LocalQueuePair:
    """In-process stand-in with the same (get/put, capacity-1) contract.

    Replaces the reference's per-module ``multiprocessing.Queue(1)`` pairs
    (main.py:26-38): with one process owning the device there is no
    process boundary, but the orchestrator still speaks queue semantics so
    frontends are interchangeable.
    """

    def __init__(self):
        self.inbound = queue.Queue(maxsize=1)
        self.outbound = queue.Queue(maxsize=1)


def run_hub(port: int = DEFAULT_PORT) -> None:
    """CLI entry: python -m isbfsar_tpu_torch.runtime.ipc"""
    print(f"[isbfsar-tpu] queue hub listening on :{port}", flush=True)
    QueueHub(("0.0.0.0", port)).serve_forever()


if __name__ == "__main__":
    run_hub()
