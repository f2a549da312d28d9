"""Start a process group of fresh processes and collect what each returns.

    results = run_ranks(fn, world, device, timeout, *args)

``fn`` is a module-level function of this package; each of ``world`` fresh
interpreters (``python -m isbfsar_tpu_torch.parallel.launch``, so a rank
imports torch, the port and what unpickling ``args`` needs, and neither its
caller's modules nor its caller's main script, which the ``spawn`` start
method of ``multiprocessing`` would run again) joins the group and calls
``fn(*args)``; ``results[r]`` is rank r's return value. The ranks meet
through a ``FileStore`` in a temporary directory, not a TCP port, so that
groups started at the same time by different callers cannot race for one.
The backend is ``nccl`` for ``device="cuda"`` and ``gloo`` for ``"cpu"``;
``backend=`` overrides it (gloo with CUDA tensors runs two ranks on one
card, which NCCL refuses). Every rank first sets one torch thread.

The group is made with ``timeout``, and the caller waits at most
``timeout`` seconds in all: on expiry, or on the first rank that fails, it
kills every rank and raises with the failing rank's traceback and output.
A hung collective therefore costs ``timeout`` seconds, never the caller's
own limit.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_ranks(fn: Callable, world: int, device: str = "cuda", timeout: float = 120.0,
              *args, backend: Optional[str] = None,
              env: Optional[Sequence[Dict[str, str]]] = None) -> List[Any]:
    """Rank r's ``fn(*args)`` for r in range(world); ``env[r]`` is added to
    rank r's environment."""
    backend = backend or BACKENDS[str(device).split(":")[0]]
    tmp = tempfile.mkdtemp(prefix="isbfsar_ranks_")
    job = os.path.join(tmp, "job.pickle")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    procs = []
    try:
        for r in range(world):
            child_env = dict(os.environ)
            child_env["PYTHONPATH"] = REPO + os.pathsep + child_env.get("PYTHONPATH", "")
            child_env.update(env[r] if env else {})
            with open(os.path.join(tmp, f"{r}.log"), "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "isbfsar_tpu_torch.parallel.launch", tmp, str(r),
                     str(world), backend, str(timeout)],
                    env=child_env, cwd=REPO, stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                why = _tail(os.path.join(tmp, f"{r}.error")) or _tail(os.path.join(tmp, f"{r}.log"))
                raise RuntimeError(f"{fn.__name__}: rank {r} of {world} failed (exit "
                                   f"{codes[r]}):\n{why}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"{fn.__name__}: ranks {late} of {world} did not finish "
                                   f"within {timeout} s; rank {late[0]}'s output:\n"
                                   + _tail(os.path.join(tmp, f"{late[0]}.log")))
            time.sleep(0.05)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.result"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(tmp: str, rank: int, world: int, backend: str, timeout: float) -> int:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        with open(os.path.join(tmp, "job.pickle"), "rb") as f:
            fn, args = pickle.load(f)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"{rank}.result.part"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(tmp, f"{rank}.result.part"), os.path.join(tmp, f"{rank}.result"))
        return 0
    except Exception:  # the caller raises it with this traceback
        with open(os.path.join(tmp, f"{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        return 1


if __name__ == "__main__":
    tmp_dir, rank_, world_, backend_, timeout_ = sys.argv[1:6]
    sys.exit(_rank_main(tmp_dir, int(rank_), int(world_), backend_, float(timeout_)))
