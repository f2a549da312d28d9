"""Shared set-up of the synthetic-trainer parity tests
(``tests/test_torch_yolo_train.py``, ``test_torch_heatmap_train.py``,
``test_torch_focus_train.py``): each of the five trainers at the CI size
built in both packages from JAX's own init (carried to the port through
``weights.convert_variables``), one batch made by the port's samplers
(which draw as JAX's do), and one ``train_step`` on each side.

What is compared after the step: the loss; Adam's first moment, which
after one step is ``0.1 * g`` with ``g`` the clipped gradient (so this
holds every gradient leaf, which the parameters alone would not: Adam's
first update is about ``lr * sign(g)`` whatever the scale of ``g``); the
parameters; and the running statistics.

In float64 (JAX under ``jax.enable_x64``) both packages compute one
function; the decodes stay float32 in both (JAX casts YOLO's raw output,
the backbone's features and the heatmaps to float32), so the float64
step agrees to about float32's rounding of those, not to 1e-15. The focus
trainers keep float32 parameters in float64 (JAX's ``param_dtype``), as
does the port. In float32 the port's step must be no farther from JAX's
float64 step than a stated multiple of JAX's own float32 step.

``python -m tests.torch_synth_parity`` prints the readings behind the
limits (``TOL_STEP_64`` and ``FLOAT32_RATIO``), for each trainer.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.train import gazefocus as jgf
from isbfsar_tpu.train import posestack as jps
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.train import gazefocus as tgf
from isbfsar_tpu_torch.train import posestack as tps
from isbfsar_tpu_torch.weights import to_flax_variables
from tests.torch_rgb_parity import max_abs, walk

BATCH = 2
LR = {"yolo": 1e-3, "heatmap": 1e-3, "blaze": 1e-3, "lm": 1e-3, "gaze": 5e-4}
KINDS = tuple(LR)

# One float64 step, each limit about four times the largest reading of
# ``python -m tests.torch_synth_parity`` over the five trainers: the loss
# (read 6.3e-7, GazeTrainer), Adam's first moment relative to its leaf
# (3.9e-6, HeatmapTrainer), the running stats (1.2e-7, BlazeFaceTrainer)
# and the parameters after the step (5.6e-5, LandmarkRefinerTrainer).
# Adam moves an entry by lr * g / (|g| + 1e-8): where the gradient lies
# within about 1e-8 of zero, the float32 decodes' rounding (1e-10 there)
# moves the parameter by some percent of lr, in either package.
TOL_STEP_64 = {"loss": 3e-6, "grad_rel": 2e-5, "params": 2e-4, "stats": 5e-7}
# a float32 step: the port's distance from JAX's float64 step at most this
# multiple of JAX's own float32 step's distance, per measure (or 1e-6 of
# absolute slack where JAX's own error reads 0)
FLOAT32_RATIO = 4.0


def numpy_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t,
                                            np.float64), tree)


def cast(tree, dtype: str):
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), tree)


def max_rel(want, got) -> float:
    """The largest leaf error relative to that leaf's largest entry, or to
    1e-6 of the whole tree's largest entry where the leaf's is smaller
    (a BatchNorm's bias that feeds another BatchNorm in training has a
    gradient of 1e-19, numerical noise: the next normalization removes any
    shift)."""
    floor = 1e-6 * max(float(np.max(np.abs(a))) for _, a, _ in walk(want, want))
    return max(float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(a))), floor)
               for _, a, b in walk(want, got))


def update_rel_l2(want: dict, got: dict, init: dict) -> float:
    """|| (got - init) - (want - init) || / || want - init || over a tree:
    how far two fits from one init moved apart, relative to the move."""
    num = den = 0.0
    for (_, w, g), (_, i, _) in zip(walk(want, got), walk(init, init)):
        num += float(((g - w) ** 2).sum())
        den += float(((w - i) ** 2).sum())
    return (num / den) ** 0.5


def _adam_mu(opt_state):
    """The first moment of a JAX trainer's optax chain state."""
    for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu
    raise AssertionError("no Adam state")


# --------------------------------------------------------------- batches


def batch(kind: str, seed: int = 1) -> dict:
    """The port's batch for ``kind`` at the CI size, numpy."""
    if kind == "yolo":
        sampler = tps.SyntheticHumanSampler(tps.CI_FRAME_HW, tps.CI_INTRINSICS, seed=seed)
        norm = np.asarray([320, 240, 320, 240], np.float32)
        # one scene with a person and one without (seed 1 draws them so)
        b = tps.detector_batch(sampler, BATCH, 128, norm, 0.5)
        assert b["has_person"].tolist() == [True, False], b["has_person"]
        return b
    if kind == "heatmap":
        sampler = tps.SyntheticHumanSampler(tps.CI_FRAME_HW, tps.CI_INTRINSICS, seed=seed)
        return tps.pose_batch(sampler, BATCH, 0.08)
    if kind == "blaze":
        return tgf.face_detector_batch(tgf.SyntheticFaceSampler(seed=seed), BATCH)
    sampler = tgf.SyntheticFaceSampler(seed=seed)
    if kind == "lm":
        return tgf.refiner_batch(sampler, BATCH)
    frames, lms, gazes = tgf.gaze_batch(sampler, BATCH, 0.005)
    crops, r_norm = tgf.make_normalized_crop_fn(tgf.CI_FOCUS_CFG, with_rnorm=True,
                                                device="cpu")(frames, lms)
    return {"crop": crops.numpy(), "pitchyaw": tgf.gaze_labels(gazes, r_norm).numpy()}


# -------------------------------------------------------------- trainers


def jax_trainer(kind: str, dtype: str, variables=None):
    """JAX's trainer for ``kind`` in ``dtype`` (call under ``enable_x64``
    for float64); the pose trainers from ``variables``, the focus trainers
    from their own init (seed 0)."""
    jdt = jnp.dtype(dtype)
    if kind == "yolo":
        return jps.YoloTrainer(width=0.25, input_size=128, seed=0, lr=LR[kind], dtype=jdt,
                               variables=variables)
    if kind == "heatmap":
        return jps.HeatmapTrainer(jps.CI_INTRINSICS, crop_size=128, seed=0, lr=LR[kind],
                                  dtype=jdt, variables=variables)
    cfg = jc.FocusConfig(gaze_image_size=64, compute_dtype=dtype)
    cls = {"blaze": jgf.BlazeFaceTrainer, "lm": jgf.LandmarkRefinerTrainer,
           "gaze": jgf.GazeTrainer}[kind]
    return cls(cfg, seed=0, lr=LR[kind])


def init_variables(kind: str) -> dict:
    """JAX's float32 init for ``kind``, numpy: the pose trainers' variables
    and the focus trainers' {"params", "batch_stats"}."""
    return numpy_tree(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   jax_trainer(kind, "float32").variables))


def port_trainer(kind: str, dtype: str, variables: dict):
    tdt = getattr(torch, dtype)
    if kind == "yolo":
        return tps.YoloTrainer(width=0.25, input_size=128, lr=LR[kind], dtype=tdt,
                               variables=cast(variables, dtype), device="cpu")
    if kind == "heatmap":
        return tps.HeatmapTrainer(tps.CI_INTRINSICS, crop_size=128, stages=V2_TINY,
                                  lr=LR[kind], dtype=tdt, variables=cast(variables, dtype),
                                  device="cpu")
    cfg = tgf.FocusConfig(gaze_image_size=64, compute_dtype=dtype)
    cls = {"blaze": tgf.BlazeFaceTrainer, "lm": tgf.LandmarkRefinerTrainer,
           "gaze": tgf.GazeTrainer}[kind]
    return cls(cfg, lr=LR[kind], variables=cast(variables, "float32"), device="cpu")


def port_modules(trainer) -> dict:
    return ({"bbone": trainer.bbone, "head": trainer.head}
            if isinstance(trainer, tps.HeatmapTrainer) else {"": trainer.net})


def port_params_tree(trainer, tensors) -> dict:
    """Tensors aligned with the trainer's optimizer parameters -> a Flax
    params tree (JAX's layout: {"bbone", "head"} for the heatmap trainer)."""
    out, it = {}, iter(tensors)
    for name, module in port_modules(trainer).items():
        names = [n for n, p in module.named_parameters() if p.requires_grad]
        tree = to_flax_variables({n: next(it) for n in names})["params"]
        if name:
            out[name] = tree
        else:
            out = tree
    return out


def port_stats_tree(trainer) -> dict:
    mods = port_modules(trainer)
    if "" in mods:
        return to_flax_variables(mods[""].state_dict())["batch_stats"]
    return to_flax_variables(mods["bbone"].state_dict())["batch_stats"]


def one_step(kind: str, dtype: str, variables: dict, b: dict) -> dict:
    """One train step in each package from ``variables``: {"jax", "port"},
    each {"loss", "mu", "params", "stats"} with float64 numpy leaves."""
    with jax.enable_x64(dtype == "float64"):
        if kind in ("yolo", "heatmap"):
            jt = jax_trainer(kind, dtype, cast(variables, dtype))
        else:
            jt = jax_trainer(kind, dtype)
            jt.params = jax.tree.map(jnp.asarray, cast(variables["params"], "float32"))
            jt.batch_stats = jax.tree.map(jnp.asarray,
                                          cast(variables["batch_stats"], "float32"))
        jb = {k: np.asarray(v, dtype) if np.asarray(v).dtype.kind == "f" and
              kind in ("blaze", "lm", "gaze") else v for k, v in b.items()}
        jloss = jt.train_step(jb)
        stats = jt.batch_stats
        jout = {"loss": jloss, "mu": numpy_tree(_adam_mu(jt.opt_state)),
                "params": numpy_tree(jt.params), "stats": numpy_tree(stats)}
    pt = port_trainer(kind, dtype, variables)
    ploss = pt.train_step(b)
    pout = {"loss": ploss, "mu": numpy_tree(port_params_tree(pt, pt.optimizer.mu)),
            "params": numpy_tree(port_params_tree(pt, pt.optimizer.params)),
            "stats": numpy_tree(port_stats_tree(pt))}
    return {"jax": jout, "port": pout}


def errors(want: dict, got: dict) -> dict:
    return {"loss": abs(want["loss"] - got["loss"]), "grad_rel": max_rel(want["mu"], got["mu"]),
            "params": max_abs(want["params"], got["params"]),
            "stats": max_abs(want["stats"], got["stats"])}


def readings(kind: str) -> dict:
    """The float64 step's errors, and each package's float32 step against
    JAX's float64 step."""
    variables, b = init_variables(kind), batch(kind)
    s64 = one_step(kind, "float64", variables, b)
    s32 = one_step(kind, "float32", variables, b)
    return {"float64": errors(s64["jax"], s64["port"]),
            "port32": errors(s64["jax"], s32["port"]),
            "jax32": errors(s64["jax"], s32["jax"]),
            "loss": s64["jax"]["loss"]}


def check_readings(r: dict) -> None:
    over = {k: v for k, v in r["float64"].items() if not v <= TOL_STEP_64[k]}
    assert not over, (over, r)
    for k, v in r["port32"].items():
        assert v <= FLOAT32_RATIO * r["jax32"][k] + 1e-6 * (k != "grad_rel"), (k, r)


def report(kinds=KINDS) -> None:
    for kind in kinds:
        t = time.perf_counter()
        r = readings(kind)
        print(kind, {k: v for k, v in r.items()}, f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    report(sys.argv[1:] or KINDS)
