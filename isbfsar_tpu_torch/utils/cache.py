"""The trained-parameter cache (port of ``isbfsar_tpu/utils/cache.py``'s
``cached_params``; the XLA compile cache has no counterpart).

A synthetic-supervision fit is a pure function of its trainer's
configuration, so its parameters are stored under the digest of a key that
captures that configuration (:func:`params_cache_digest`, the JAX
package's, so the same key names the same file). Lookup order: the
read-only bundle shared with the JAX package (``isbfsar_tpu/assets/
pretrained/``, or ``ISBFSAR_PRETRAINED_DIR``), then the port's own writable
cache, then train and write. The writable cache is the port's own
(``ISBFSAR_TORCH_PARAMS_CACHE``, by default ``build/isbfsar_tpu_torch/
params_cache`` in the repo), so a fit one package trained is never served
to the other under the same digest. Entries are Flax msgpack trees
(``weights.msgpack_dumps``/``msgpack_restore``): either package reads them.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Callable

from isbfsar_tpu_torch.configs import ASSETS_DIR

BUNDLED_PRETRAINED_DIR = os.path.join(ASSETS_DIR, "pretrained")
DEFAULT_PARAMS_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "isbfsar_tpu_torch", "params_cache")


def params_cache_digest(key: str, version: str) -> str:
    """The file name of a (key, version) entry, as the JAX package names it."""
    return hashlib.sha256(f"v{version}:{key}".encode()).hexdigest()[:24]


def pretrained_bundle_dir() -> str:
    """The read-only bundle; ``ISBFSAR_PRETRAINED_DIR`` overrides it, as in
    the JAX package (the cache lookup and ``weights.available``/``verify``
    both resolve it here)."""
    return os.environ.get("ISBFSAR_PRETRAINED_DIR", BUNDLED_PRETRAINED_DIR)


def cached_params(key: str, builder: Callable[[], Any], version: str = "1",
                  cache_dir: str = "") -> Any:
    """``builder()``'s parameter tree, cached on disk under ``key``.

    ``key`` must capture everything the fit depends on; a bundle entry whose
    key moved has another digest and is never read. An unreadable entry
    falls through to the next tier, or to a fresh ``builder()``, whose tree
    (CPU tensors or numpy leaves) is written atomically. Returns a tree of
    dicts with CPU tensor leaves."""
    from isbfsar_tpu_torch.weights import msgpack_dumps, msgpack_restore

    cache_dir = cache_dir or os.environ.get("ISBFSAR_TORCH_PARAMS_CACHE",
                                            DEFAULT_PARAMS_CACHE_DIR)
    digest = params_cache_digest(key, version)
    path = os.path.join(cache_dir, f"{digest}.msgpack")
    for candidate in (os.path.join(pretrained_bundle_dir(), f"{digest}.msgpack"), path):
        if os.path.exists(candidate):
            try:
                with open(candidate, "rb") as f:
                    return msgpack_restore(f.read())
            except Exception:
                pass  # a corrupt entry: the next tier, or a retrain
    data = msgpack_dumps(builder())
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic: a concurrent run never reads a partial file
    return msgpack_restore(data)
