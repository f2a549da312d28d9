"""Shared set-up of the focus-alternative trainer parity tests
(``tests/test_torch_mutualgaze_train.py``): ``DetectorTrainer`` (input 64,
batch 4, synthetic boxes with padding) and ``MutualGazeTrainer`` (ResNet-18
at a 32 crop, batch 4, ``MutualGazeConfig().lr`` 1e-6) built in both
packages from JAX's own init (carried to the port through
``weights.convert_variables``), one batch made from a seed, and one train
step on each side, compared as ``tests/torch_synth_parity.py`` compares the
synthetic trainers: the loss, Adam's first moment (the gradient, clipped
for the detector), the parameters and the running statistics.

JAX's trainers take no compute type (bf16 nets); both are traced at their
first step, so the parity runs hand them the same net in float64 (under
``jax.enable_x64``) or float32 before it: the port's ``dtype`` argument.
The parameters stay float32 in both, as Flax's ``param_dtype``. The
detector's trunk moves its running stats by momentum 0.99, the ResNet-18 by
0.9: the stats reading holds both.

``python -m tests.torch_mutual_parity`` prints the readings behind the
limits (``TOL_STEP_64``, ``FLOAT32_RATIO`` of ``tests/torch_synth_parity.py``).
"""

from __future__ import annotations

import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.models import detection as jdet_models
from isbfsar_tpu.models import resnet as jresnet
from isbfsar_tpu.train import detection as jdet
from isbfsar_tpu.train import mutualgaze as jmg
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.train import detection as tdet
from isbfsar_tpu_torch.train import mutualgaze as tmg
from tests.torch_synth_parity import _adam_mu, cast, errors, numpy_tree
from isbfsar_tpu_torch.weights import to_flax_variables

KINDS = ("detector", "mutual")
DET_SIZE, DET_BATCH, MAX_BOXES, DET_LR = 64, 4, 4, 1e-4
CROP, MG_BATCH = 32, 4


def mutual_config(**kw):
    return tc.MutualGazeConfig(crop_size=CROP, **kw)


def detector_batch(seed: int = 1) -> dict:
    """4 images with 1-3 valid boxes each of 4 slots, the rest zero padding;
    image 3 carries a box twice (two ground truths, one best prediction)."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (DET_BATCH, DET_SIZE, DET_SIZE, 3)).astype(np.float32)
    boxes = np.zeros((DET_BATCH, MAX_BOXES, 4), np.float32)
    valid = np.zeros((DET_BATCH, MAX_BOXES), bool)
    for i, n in enumerate((1, 3, 2, 2)):
        xy = rng.uniform(0.05, 0.6, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(0.1, 0.35, (n, 2))], -1)
        valid[i, :n] = True
    boxes[3, 1] = boxes[3, 0]
    return {"image": image, "boxes": boxes, "valid": valid}


def watching_batch(seed: int = 1) -> tuple:
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (MG_BATCH, CROP, CROP, 3)).astype(np.float32)
    return images, np.asarray([0, 1, 1, 0], np.float32)


def jax_mutual_trainer(log_dir: str, dtype: str = "bfloat16", lr: float = 1e-6):
    """JAX's trainer with its backbone swapped for one computing in
    ``dtype`` (before its step is traced)."""
    jt = jmg.MutualGazeTrainer(jc.MutualGazeConfig(crop_size=CROP, lr=lr), log_dir=log_dir)
    jt.backbone = jresnet.resnet18(dtype=jnp.dtype(dtype))
    return jt


def init_variables(kind: str, seed: int = 0) -> dict:
    """JAX's float32 init, numpy: the detector's {"params", "batch_stats"};
    the mutual-gaze trainer's {"params": {"backbone", "head"},
    "batch_stats": {"backbone"}} for ``reset(seed)``."""
    if kind == "detector":
        jt = jdet.DetectorTrainer(jc.MutualGazeConfig(), input_size=DET_SIZE, seed=seed)
        return numpy_tree(jt.variables)
    with tempfile.TemporaryDirectory() as tmp:
        jt = jmg.MutualGazeTrainer(jc.MutualGazeConfig(crop_size=CROP), log_dir=tmp)
        params, stats = jt._init(jax.random.key(seed))
        jt.logger.close()
    return numpy_tree({"params": params, "batch_stats": stats})


def _jax_step(kind: str, dtype: str, variables: dict, batch):
    f32 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)  # noqa: E731
    if kind == "detector":
        jt = jdet.DetectorTrainer(jc.MutualGazeConfig(), input_size=DET_SIZE, lr=DET_LR)
        jt.net = jdet_models.HeadDetectorNet(dtype=jnp.dtype(dtype))
        jt.params = {"params": f32(variables["params"])}
        jt.batch_stats = f32(variables["batch_stats"])
        jt.opt_state = jt.optimizer.init(jt.params)
        loss = jt.train_step(batch)
        return {"loss": loss, "mu": numpy_tree(_adam_mu(jt.opt_state)["params"]),
                "params": numpy_tree(jt.params["params"]), "stats": numpy_tree(jt.batch_stats)}
    with tempfile.TemporaryDirectory() as tmp:
        jt = jax_mutual_trainer(tmp, dtype)
        jt.logger.close()
    params, stats = f32(variables["params"]), f32(variables["batch_stats"])
    params, stats, opt_state, loss, _ = jt._step(params, stats, jt.optimizer.init(params),
                                                 jnp.asarray(batch[0]), jnp.asarray(batch[1]))
    return {"loss": float(loss), "mu": numpy_tree(_adam_mu(opt_state)),
            "params": numpy_tree(params), "stats": numpy_tree(stats)}


def port_trainer(kind: str, dtype: str, variables: dict, log_dir: str):
    tdt = getattr(torch, dtype)
    if kind == "detector":
        return tdet.DetectorTrainer(tc.MutualGazeConfig(), input_size=DET_SIZE, lr=DET_LR,
                                    dtype=tdt, variables=cast(variables, "float32"), device="cpu")
    pt = tmg.MutualGazeTrainer(mutual_config(), log_dir=log_dir, device="cpu", dtype=tdt)
    pt.reset(0, variables=cast(variables, "float32"))
    return pt


def port_tree(pt, tensors) -> dict:
    """Tensors aligned with the optimizer's parameters -> JAX's params tree."""
    it = iter(tensors)

    def tree(module):
        names = [n for n, _ in module.named_parameters()]
        return to_flax_variables({n: next(it) for n in names})["params"]

    if isinstance(pt, tdet.DetectorTrainer):
        return tree(pt.net)
    return {"backbone": tree(pt.backbone), "head": tree(pt.head)}


def port_stats(pt) -> dict:
    if isinstance(pt, tdet.DetectorTrainer):
        return to_flax_variables(pt.net.state_dict())["batch_stats"]
    return pt.variables["batch_stats"]


def one_step(kind: str, dtype: str, variables: dict, batch) -> dict:
    """One train step in each package from ``variables``: {"jax", "port"},
    each {"loss", "mu", "params", "stats"} with float64 numpy leaves."""
    with jax.enable_x64(dtype == "float64"):
        jout = _jax_step(kind, dtype, variables, batch)
    with tempfile.TemporaryDirectory() as tmp:
        pt = port_trainer(kind, dtype, variables, tmp)
        loss = pt.train_step(batch) if kind == "detector" else pt.train_step(*batch)
        pt_out = {"loss": loss, "mu": numpy_tree(port_tree(pt, pt.optimizer.mu)),
                  "params": numpy_tree(port_tree(pt, pt.optimizer.params)),
                  "stats": numpy_tree(port_stats(pt))}
        if kind == "mutual":
            pt.logger.close()
    return {"jax": jout, "port": pt_out}


def readings(kind: str) -> dict:
    """The float64 step's errors, and each package's float32 step against
    JAX's float64 step."""
    variables = init_variables(kind)
    batch = detector_batch() if kind == "detector" else watching_batch()
    s64 = one_step(kind, "float64", variables, batch)
    s32 = one_step(kind, "float32", variables, batch)
    return {"float64": errors(s64["jax"], s64["port"]),
            "port32": errors(s64["jax"], s32["port"]),
            "jax32": errors(s64["jax"], s32["jax"]),
            "loss": s64["jax"]["loss"]}


if __name__ == "__main__":
    torch.set_num_threads(2)
    for k in sys.argv[1:] or KINDS:
        t = time.perf_counter()
        print(k, readings(k), f"{time.perf_counter() - t:.1f} s", flush=True)
