"""``train_focus_params`` of the port against the JAX package's on the CPU
at ``CI_FOCUS_CFG``: two steps of each phase at batch 2, the port's three
trainers started from JAX's own init (JAX draws its init from
``jax.random``; the test hands it to the port's trainers). This holds the
three samplers' draw order, the detector's resize, the refiner's crops and
jitter and the batched gaze crops and labels.

Compared: each net's update (the parameters after the fit minus JAX's
init) in relative L2, and the running stats. GazeNet's two steps at
batch 2 are ill-conditioned (its last stage normalizes 2x2 maps of 2
frames): uniform noise of 1e-4 on the crops moves its update by 33% in
relative L2 (``python -m tests.test_torch_focus_fit``), and the two
packages' crops differ by up to 1.7e-4 (``test_torch_gaze_train.py``),
so its limits are wider; a batch drawn in another order moves an update
by about its own size. This CPU reads the updates of BlazeFace, the
refiner and GazeNet 3.7e-5, 2.5e-4 and 4.5e-2 apart, and their running
stats 4.3e-6, 3.6e-6 and 1.1e-3 (``TOL_UPDATE``, ``TOL_STATS``).
"""

import functools

import jax
import numpy as np
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.train import gazefocus as jgf
from isbfsar_tpu_torch.train import gazefocus as tgf
from tests import torch_synth_parity as P

torch.set_num_threads(2)

TOL_UPDATE = {"face_det": 2e-4, "lm_refiner": 1e-3, "gaze_net": 0.2}
TOL_STATS = {"face_det": 2e-5, "lm_refiner": 2e-5, "gaze_net": 5e-3}
FIT = dict(n_steps_det=2, n_steps_gaze=2, n_steps_lm=2, batch_size=2, lr_det=1e-3,
           lr_gaze=5e-4)
NETS = {"face_det": ("BlazeFaceTrainer", "blaze"), "lm_refiner": ("LandmarkRefinerTrainer", "lm"),
        "gaze_net": ("GazeTrainer", "gaze")}


def test_train_focus_params_matches_jax(monkeypatch):
    jcfg = jc.FocusConfig(gaze_image_size=64, compute_dtype="float32")
    inits = {}
    for net, (cls, kind) in NETS.items():
        jt = getattr(jgf, cls)(jcfg, seed=0)
        inits[net] = P.numpy_tree(jax.tree.map(np.asarray, jt.variables))
        monkeypatch.setattr(tgf, cls, functools.partial(getattr(tgf, cls),
                                                        variables=inits[net]))
    want = P.numpy_tree(jax.tree.map(np.asarray, jgf.train_focus_params(jcfg, **FIT)))
    got = P.numpy_tree(tgf.train_focus_params(tgf.CI_FOCUS_CFG, device="cpu", **FIT))
    assert set(got) == set(NETS)
    for net in NETS:
        err = P.update_rel_l2(want[net]["params"], got[net]["params"], inits[net]["params"])
        stats = P.max_abs(want[net]["batch_stats"], got[net]["batch_stats"])
        print(net, "update", err, "stats", stats)
        assert err <= TOL_UPDATE[net], (net, err)
        assert stats <= TOL_STATS[net], (net, stats)


def crop_noise_sensitivity(noise: float = 1e-4) -> float:
    """The port's GazeNet update after two steps at batch 2, from JAX's
    init, with and without uniform noise of ``noise`` on the crops: their
    distance in relative L2."""
    init = P.init_variables("gaze")
    sampler = tgf.SyntheticFaceSampler(seed=1)
    crop_fn = tgf.make_normalized_crop_fn(tgf.CI_FOCUS_CFG, with_rnorm=True, device="cpu")
    batches = []
    for _ in range(2):
        frames, lms, gazes = tgf.gaze_batch(sampler, 2, 0.005)
        crops, r_norm = crop_fn(frames, lms)
        batches.append((crops.numpy(), tgf.gaze_labels(gazes, r_norm).numpy()))
    outs = []
    for scale in (0.0, noise):
        trainer = tgf.GazeTrainer(tgf.CI_FOCUS_CFG, lr=5e-4, variables=init, device="cpu")
        rng = np.random.default_rng(0)
        for crops, labels in batches:
            noisy = crops + scale * rng.uniform(-1, 1, crops.shape)
            trainer.train_step({"crop": noisy.astype(np.float32), "pitchyaw": labels})
        outs.append(P.numpy_tree(trainer.variables)["params"])
    return P.update_rel_l2(outs[0], outs[1], P.numpy_tree(init)["params"])


if __name__ == "__main__":
    torch.set_num_threads(2)
    print("GazeNet update with 1e-4 crop noise against without:", crop_noise_sensitivity())
