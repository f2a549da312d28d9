"""``train_pose_params`` of the port against the JAX package's on the CPU:
two detector and two pose steps at batch 2, both warm-started from the
bundled ``pose-ci-motions`` fit (the same ``init_params``), which also
holds the samplers' draw order, the person/empty draw, the INTER_AREA
resize and the box jitter: a batch that differed would move the update
by about its own size.

Compared: each branch's update (the parameters after the fit minus the
init) in relative L2, and the running stats. In float32 the two packages
part a little at every step (Adam's first steps are about lr * sign(g), and
gradient entries near zero can take either sign): this CPU reads an update
9.1e-5 apart for YOLO, 3.1e-3 for the backbone, 6.3e-4 for the head, and
running stats 7.4e-5 apart (limits 1e-2 and 3e-4).
"""

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import pretrained
from isbfsar_tpu.train import posestack as jps
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.train import posestack as tps
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_UPDATE, TOL_STATS = 1e-2, 3e-4
FIT = dict(n_steps_det=2, n_steps_pose=2, batch_size=2, seed=5)


def test_train_pose_params_matches_jax():
    init = jax.tree.map(np.asarray, pretrained.load("pose-ci-motions"))
    want = P.numpy_tree(jps.train_pose_params(jps.CI_FRAME_HW, jps.CI_INTRINSICS,
                                              init_params=init, **FIT))
    got = P.numpy_tree(tps.train_pose_params(tps.CI_FRAME_HW, tps.CI_INTRINSICS,
                                             init_params=init, device="cpu", **FIT))
    init = P.numpy_tree(init)
    assert set(got) == {"yolo", "bbone", "head"}
    for k in ("yolo", "bbone", "head"):
        err = P.update_rel_l2(want[k]["params"], got[k]["params"], init[k]["params"])
        assert err <= TOL_UPDATE, (k, err)
        if "batch_stats" in want[k]:
            assert P.max_abs(want[k]["batch_stats"], got[k]["batch_stats"]) <= TOL_STATS, k


def test_partial_pose_warm_start_is_refused():
    """A pose branch warm start needs both 'bbone' and 'head', as in JAX."""
    fit = weights.load_bundle("pose-ci-motions")
    with pytest.raises(ValueError, match="BOTH 'bbone' and 'head'"):
        tps.train_pose_params(n_steps_det=0, n_steps_pose=0, device="cpu",
                              init_params={"yolo": fit["yolo"], "bbone": fit["bbone"]})
