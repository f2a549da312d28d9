"""The port's ``tools/train_posestack.py`` on the CPU at CI size: a short
fit written as Flax msgpack that the JAX package's estimator and the
port's both load and run, a warm start with ``--eval-only``, and the exit
codes of a bad call."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from isbfsar_tpu.configs import HPEConfig as JaxHPEConfig
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu_torch.configs import HPEConfig
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.tools import train_posestack as cli
from isbfsar_tpu_torch.train import posestack as tps

torch.set_num_threads(2)


def run(argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_fit_writes_a_tree_both_packages_load(tmp_path):
    path = str(tmp_path / "pose.msgpack")
    rc, out = run(["--out", path, "--steps-det", "1", "--steps-pose", "1", "--batch", "2",
                   "--remat", "--device", "cpu"])
    assert rc == 0 and "wrote" in out
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    assert set(tree) == {"yolo", "bbone", "head"}
    frame, _ = tps.SyntheticHumanSampler(tps.CI_FRAME_HW, tps.CI_INTRINSICS, seed=0).sample()
    jest = JaxEstimator(JaxHPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.0,
                                     compute_dtype="float32"), tps.CI_INTRINSICS, params=tree,
                        backbone_stages=JAX_V2_TINY, frame_shape=tps.CI_FRAME_HW,
                        yolo_width=0.25)
    want = jax.device_get(jest._estimate_jit(jest.params, frame))
    est = HumanPoseEstimator(HPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.0,
                                       compute_dtype="float32"), tps.CI_INTRINSICS,
                             params=tree, backbone_stages=V2_TINY, frame_shape=tps.CI_FRAME_HW,
                             yolo_width=0.25, device="cpu")
    row = tps.estimate_row(est, frame)
    np.testing.assert_array_equal(row[:4], np.asarray(want[1], np.float32))
    assert abs(row[4] - float(want[2])) <= 1e-5


def test_eval_only_from_init(tmp_path):
    from isbfsar_tpu_torch import weights

    path = str(tmp_path / "ci.msgpack")
    with open(path, "wb") as f:
        f.write(weights.msgpack_dumps(weights.load_bundle("pose-ci-motions")))
    rc, out = run(["--init", path, "--eval-only", "--eval", "3", "--device", "cpu"])
    assert rc == 0
    line = [ln for ln in out.splitlines() if ln.startswith("[train_posestack:eval]")][0]
    metrics = json.loads(line.split(" ", 1)[1])
    assert metrics["n_scenes"] == 3 and metrics["found_rate"] == 1.0


@pytest.mark.parametrize("argv", [["--eval-only", "--device", "cpu"],
                                  ["--steps-det", "1", "--device", "cpu"]])
def test_bad_calls_exit_2(argv):
    assert run(argv)[0] == 2


def test_cuda_without_a_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would train")
    assert run(["--out", str(tmp_path / "x.msgpack")])[0] == 2
