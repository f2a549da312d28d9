"""Checkpoint save/load (port of ``isbfsar_tpu/utils/checkpoint.py``,
msgpack backend).

A checkpoint is ``{step}.msgpack``, a Flax msgpack tree, plus the
``{step}.json`` sidecar. The port writes it with its own encoder
(``weights.msgpack_dumps``) and reads it with its own decoder
(``weights.msgpack_restore``), so the bytes are what
``flax.serialization.to_bytes`` writes for the same tree: each package reads
and resumes from the other's files. The orbax backend needs orbax, which the
port does not use.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from isbfsar_tpu_torch.weights import msgpack_dumps, msgpack_restore


def _refuse_orbax(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError("orbax checkpoints need orbax (ROADMAP A.18); use msgpack")
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def save_checkpoint(directory: str, step: int, tree: Any, meta: Optional[Dict] = None,
                    backend: str = "msgpack") -> str:
    """Write one checkpoint (a tree of dicts with tensor or numpy leaves);
    returns its path."""
    _refuse_orbax(backend)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{step}.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_dumps(tree))
    with open(os.path.join(directory, f"{step}.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    return path


def load_checkpoint(path: str, template: Any = None) -> Any:
    """Read a checkpoint as a tree of CPU tensors. With a ``template`` (a
    tree of dicts), the checkpoint must have the template's keys wherever the
    template has a dict, as Flax's ``from_bytes`` requires; a ``None`` in the
    template takes whatever the checkpoint holds there."""
    if os.path.isdir(path):
        _refuse_orbax("orbax")
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if template is not None:
        _match(template, tree, "")
    return tree


def _match(template, tree, where: str) -> None:
    if not isinstance(template, dict):
        return
    if not isinstance(tree, dict) or set(template) != set(tree):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"checkpoint keys at {where or '/'}: {got}, expected {sorted(template)}")
    for k, v in template.items():
        _match(v, tree[k], f"{where}/{k}")


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = [
        (int(f.split(".")[0]), f)
        for f in os.listdir(directory)
        if (f.endswith(".msgpack") or f.endswith(".orbax"))
        and f.split(".")[0].isdigit()
    ]
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])
