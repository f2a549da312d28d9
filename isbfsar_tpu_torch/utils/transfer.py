"""Host <-> device transfers that do not wait for the device.

:func:`to_device` uploads a host array through pinned memory without
waiting for the card; :class:`HostCopy` starts a device -> host copy into
pinned memory at once and waits only for that copy when it is read. The
serving paths dispatch frame i, then read frame i-1: a plain ``.cpu()``
would wait for frame i's work as well, since it synchronizes the whole
stream.

Every copy gets its own pinned buffer from PyTorch's caching host
allocator, which hands a block out again only after the tensor is freed
and the copies that used it have finished. The arrays :meth:`HostCopy.numpy`
returns keep their buffer alive, so a result already handed out never
changes under its holder.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on the card through pinned memory, enqueued
    on the current stream without waiting for it."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """The device -> host copy of ``tensor``, enqueued now on the current
    stream; :meth:`numpy` waits for this copy alone."""

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host = tensor.detach()
            self._done = None

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()
