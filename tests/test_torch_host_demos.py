"""The demo and example twins at a tiny size on the CPU.

- ``tools/demo_tracking.py``: the CLI learns wave and squat through the
  fused pipeline (``pose-ci-motions``, bf16 as JAX's demo) and recognizes
  each fresh clip as itself, writing the filmstrip and the GUI panel; its
  tracking in float32 gives every frame a label once the window fills. The
  parity run against JAX's ``tools/demo_tracking.py --cpu`` (same recognizer
  weights, BGR frames as JAX's pipeline takes them: the same majority vote
  and vote count per clip) is in the slow lane: JAX's run compiles for
  about a minute here.
- ``examples/train_fsos_demo.py``: one epoch of 8 tasks and one FSOS repeat.
- ``examples/serve_multistream_demo.py`` at the CI size: two streams in one
  process, and over two gloo ranks with the support classes split over a
  ``way`` axis, give the same action scores within TOL_SCORES (float32,
  a gather of the same logits; read 0 on a CPU).
"""

import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from isbfsar_tpu_torch.examples import serve_multistream_demo, train_fsos_demo
from isbfsar_tpu_torch.tools import demo_tracking as demo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_SCORES = 1e-6


def test_demo_tracking_cli_writes_both_panels(tmp_path, capsys):
    out, gui = tmp_path / "strip.png", tmp_path / "gui.png"
    demo.main(["--device", "cpu", "--out", str(out), "--gui-out", str(gui)])
    printed = capsys.readouterr().out
    for motion in ("wave", "squat"):
        assert re.search(rf"\[demo\] {motion}: recognized {motion} \(\d+ votes\)", printed)
    strip = cv2.imread(str(out))
    assert strip.shape == (2 * (30 + 480), 6 * 640, 3)
    panel = cv2.imread(str(gui))
    assert panel.shape == (600, 1200, 3) and len(np.unique(panel.reshape(-1, 3), axis=0)) > 50


def test_demo_tracking_float32_labels():
    pipe = demo.build_demo("cpu", dtype="float32")
    demo.learn(pipe, verbose=False)
    clips = demo.track(pipe, verbose=False)
    assert [c["pred"] for c in clips] == ["wave", "squat"]
    for c in clips:
        assert len(c["labels"]) == 36 and len(c["cells"]) == demo.N_STRIP
        assert c["labels"][:15] == [None] * 15  # the window fills on the 16th frame
        assert c["votes"] >= 16 and c["score"] > 0.5
        pose, bbox, conf, found, visible = c["cells"][0][1]
        assert pose.shape == (30, 3) and bool(found) and np.isfinite(pose).all()


@pytest.mark.slow
def test_demo_tracking_matches_jax(tmp_path):
    from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
    from isbfsar_tpu.configs import ARConfig

    proc = subprocess.run([sys.executable, "tools/demo_tracking.py", "--cpu", "--out",
                           str(tmp_path / "jax.png")], cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = re.findall(r"\[demo\] (\w+): recognized (\w+) \((\d+) votes\)", proc.stdout)
    ar_params = JaxRecognizer(ARConfig.for_input("skeleton")).params
    pipe = demo.build_demo("cpu", input_format="bgr",
                           ar_params=jax_tree_to_numpy(ar_params))
    demo.learn(pipe, verbose=False)
    got = [(c["motion"], c["pred"], str(c["votes"])) for c in demo.track(pipe, verbose=False)]
    assert got == want


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_train_fsos_demo_tiny(tmp_path):
    res = train_fsos_demo.run_demo(str(tmp_path), epochs=1, n_task=8, batch_size=4,
                                   fsos_repeats=1, device="cpu")
    assert len(res["epochs"]) == 1 and np.isfinite(res["epochs"][0]["train/fs_loss"])
    assert set(res["fsos"]) == {"FSOS-ACC", "FS-ACC", "OS-ACC"}
    assert sorted(os.listdir(tmp_path / "test")) == [f"action_{i:02d}" for i in range(14, 20)]


def test_serve_multistream_demo_mesh_equals_one_process():
    from isbfsar_tpu_torch.parallel.launch import run_ranks

    kw = dict(streams=2, way_devices=1, way=16, frames=18, device="cpu", ci_size=True)
    alone = serve_multistream_demo.run_demo(**kw)
    assert alone["n_streams"] == 2 and not alone["mesh"]
    ranks = run_ranks(serve_multistream_demo.run_demo_kw, 2, "cpu", 240,
                      {**kw, "way_devices": 2})
    meshed = ranks[0]
    assert meshed["mesh"] and meshed["n_streams"] == 2
    for got, want in zip(meshed["elements"], alone["elements"], strict=True):
        got, want = got["actions"], want["actions"]
        assert got.keys() == want.keys() and len(got) == 5
        assert max(abs(got[k] - want[k]) for k in got) <= TOL_SCORES
