"""The orchestrator's eager module path of this tree and of an earlier one,
in turns, on one card.

    python3 -m tests.torch_ab_module_path --parent DIR [--frames 40]

DIR is an unpacked earlier tree of this repository: its ``isbfsar_tpu_torch``
(``git archive <commit> isbfsar_tpu_torch``) beside an ``isbfsar_tpu``
holding the asset files (a link to this tree's will do). Each turn is a
process of its own with one tree's package first on ``sys.path``, in the
order parent, this, this, parent. A turn builds
``profile_slice.build_slice`` (the full-width slice with focus, its kernels
built from that tree's sources) and times ``Orchestrator.get_frame`` on the
module path (the eager estimator, focus and recognizer) over the smoke and
face frames as BGR camera frames, as ``chip_smoke.py`` phase 6b does, after
3 warm-up frames; it prints the p50 and the fastest frame. Needs a CUDA
device and the bundle files phase 5 reads.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, sys, time
sys.path.insert(0, TREE)
import numpy as np, torch
from isbfsar_tpu_torch.ops.image import i420_to_bgr
from isbfsar_tpu_torch.profile_slice import build_slice, slice_frames
from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator
import isbfsar_tpu_torch
assert isbfsar_tpu_torch.__file__.startswith(TREE), isbfsar_tpu_torch.__file__
pipe = build_slice(seed=0, cuda_graphs=True)
clip = [torch.round(i420_to_bgr(torch.from_numpy(f), 480)).to(torch.uint8).numpy()
        for f in slice_frames()]
frames = [clip[i % len(clip)] for i in range(N)]
module = Orchestrator(pipe.config, hpe=pipe.hpe, focus=pipe.focus, ar=pipe.ar)
for f in frames[:3]:
    module.get_frame(img=f)
torch.cuda.synchronize()
lat = []
for f in frames:
    t = time.perf_counter()
    module.get_frame(img=f)
    lat.append(time.perf_counter() - t)
print(json.dumps({"p50_ms": float(np.median(lat) * 1e3), "min_ms": float(np.min(lat) * 1e3)}))
"""


def turn(tree: str, frames: int) -> dict:
    code = f"TREE = {os.path.abspath(tree)!r}\nN = {frames}\n" + TURN
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an unpacked earlier tree")
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, tree in (("parent", args.parent), ("this", here), ("this", here),
                       ("parent", args.parent)):
        r = turn(tree, args.frames)
        print(f"[ab] {name} ({tree}): module path get_frame p50 {r['p50_ms']:.2f} ms "
              f"(min {r['min_ms']:.2f} ms) over {args.frames} BGR frames", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
