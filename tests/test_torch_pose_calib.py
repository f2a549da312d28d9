"""The detector calibration and the fresh-scene receipt of the port
(``train/posestack.py::finetune_detector``, ``evaluate_pose_stack``)
against the JAX package's on the CPU.

``finetune_detector``: two steps at batch 4 on the hard-empty stream from
the bundled ``pose-ci-motions`` detector. This CPU reads the update 2.2e-2
apart in relative L2 and the running stats 1.8e-4 (limits 0.1 and 1e-3;
at the fine-tune's rate of 1e-4 more of the warm-started detector's
gradient entries lie near zero, where float32 can flip Adam's sign).

``evaluate_pose_stack`` on ``pose-ci-motions`` in float32 at the 0.3 gate
(8 person scenes, 4 empty, 4 hard empty): found and false-positive rates
exact; this CPU reads IoU equal, errors up to 3.9e-7 m and confidences up
to 6.6e-7 apart (limits 1e-5 and 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import pretrained
from isbfsar_tpu.configs import HPEConfig as JaxHPEConfig
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.train import posestack as jps
from isbfsar_tpu_torch.configs import HPEConfig
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.train import posestack as tps
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_UPDATE, TOL_STATS = 0.1, 1e-3
TOL_EVAL = 1e-5
EXACT = ("n_scenes", "found_rate", "empty_fp_rate", "hard_empty_fp_rate")


@pytest.fixture(scope="module")
def init():
    return jax.tree.map(np.asarray, pretrained.load("pose-ci-motions"))


def test_finetune_detector_matches_jax(init):
    kw = dict(n_steps=2, batch_size=4, yolo_width=0.25, yolo_input_size=128, seed=7)
    want = P.numpy_tree(jps.finetune_detector(init, jps.CI_FRAME_HW, jps.CI_INTRINSICS, **kw))
    got = P.numpy_tree(tps.finetune_detector(init, tps.CI_FRAME_HW, tps.CI_INTRINSICS,
                                             device="cpu", **kw))
    start = P.numpy_tree(init["yolo"])
    assert P.update_rel_l2(want["params"], got["params"], start["params"]) <= TOL_UPDATE
    assert P.max_abs(want["batch_stats"], got["batch_stats"]) <= TOL_STATS


def test_finetune_detector_casts_bf16_trunks_up(init):
    """A bf16-stored tree (the production bundle's layout) is fine-tuned in
    float32 master weights."""
    stored = tps._storage_cast_trunks({"yolo": init["yolo"]})
    out = tps.finetune_detector(stored, tps.CI_FRAME_HW, tps.CI_INTRINSICS, n_steps=1,
                                batch_size=2, yolo_width=0.25, yolo_input_size=128,
                                device="cpu")
    for _, leaf in jax.tree_util.tree_leaves_with_path(out):
        assert leaf.dtype == torch.float32


def test_evaluate_pose_stack_matches_jax(init):
    ev = dict(n_scenes=8, n_empty=4, n_hard_empty=4)
    jest = JaxEstimator(JaxHPEConfig(yolo_input_size=128, crop_size=128, compute_dtype="float32"),
                        jps.CI_INTRINSICS, params=init, backbone_stages=JAX_V2_TINY,
                        frame_shape=jps.CI_FRAME_HW, yolo_width=0.25)
    want = jps.evaluate_pose_stack(jest, jps.CI_FRAME_HW, jps.CI_INTRINSICS, **ev)
    est = HumanPoseEstimator(HPEConfig(yolo_input_size=128, crop_size=128,
                                       compute_dtype="float32"),
                             tps.CI_INTRINSICS, params=init, backbone_stages=V2_TINY,
                             frame_shape=tps.CI_FRAME_HW, yolo_width=0.25, device="cpu")
    got = tps.evaluate_pose_stack(est, tps.CI_FRAME_HW, tps.CI_INTRINSICS, **ev)
    assert set(got) == set(want)
    for k in want:
        if k in EXACT:
            assert got[k] == want[k], k
        else:
            assert abs(got[k] - want[k]) <= TOL_EVAL, (k, got[k], want[k])
    assert 0 < want["empty_fp_rate"] < 1  # the gate splits the empty scenes
