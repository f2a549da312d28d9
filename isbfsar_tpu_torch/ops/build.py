"""Builds the port's CUDA sources with nvcc into shared libraries.

Each ``csrc/*.cu`` file has a plain C interface and is compiled for
``sm_90a`` into ``build/isbfsar_tpu_torch/`` beside the package, named by
the source's content hash, at first use; the wrappers load the library
with ctypes. :func:`build_all` starts one nvcc per source at once and
waits for all of them.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, NamedTuple, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "isbfsar_tpu_torch")
SOURCES = ("fused_i420", "head_pose")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: str
    seconds: float  # 0.0 when the library for this source was already built
    log: str  # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str, csrc: str) -> Tuple[str, str]:
    """(source path, library path) of ``<csrc>/<name>.cu``."""
    source = os.path.join(csrc, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return source, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES, csrc: str = CSRC) -> Dict[str, BuildInfo]:
    """Compile every named source of ``csrc`` whose library is missing, one
    nvcc each, all at once. Raises if any fails."""
    out: Dict[str, BuildInfo] = {}
    running: Dict[str, Tuple[subprocess.Popen, str, str, float]] = {}
    for name in names:
        source, lib = _target(name, csrc)
        if os.path.exists(lib):
            out[name] = BuildInfo(lib, 0.0, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed: Optional[str] = None
    for name, (proc, tmp, lib, t0) in running.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            failed = failed or f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}"
            continue
        os.replace(tmp, lib)
        out[name] = BuildInfo(lib, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError(failed)
    return out


def build(name: str, csrc: str = CSRC) -> BuildInfo:
    """Compile ``<csrc>/<name>.cu`` unless a library of this exact source exists."""
    return build_all((name,), csrc)[name]
