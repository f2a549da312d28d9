"""Shared set-up of the rgb and hybrid training parity tests
(``tests/test_torch_rgb_train.py``, ``test_torch_hybrid_train.py``,
``test_torch_rgb_train_state.py``): one recognizer at the CI size
(``ARConfig.for_input(mode, rgb_size=32, batch_size=2)``: way 5, seq_len 8,
the ResNet-50 whole), its seeded init carried to the JAX package as a Flax
tree, one ``episodic_batch``, and the JAX loss with its gradients.

Why float64. At this size the ResNet-50's last stage sees 1x1 maps, so
each BatchNorm there normalizes 16 or 80 values per channel, and the
backward pass through batch statistics cancels: in float32 both packages
are far from the float64 result (one rgb step, disc on, ``report()``: the
few-shot loss 2.6e-3 of 4.54 off in the port and 7.1e-3 in JAX, the
gradient 1.7% and 5.3% in relative L2). The same function computed in
float64 on both sides
(``compute_dtype="float64"``, JAX under ``jax.enable_x64``) agrees to
float64's noise, which is what shows that the port computes JAX's
function; the float32 step is held to JAX's own float32 error
(``test_torch_hybrid_train.py``). Both packages round the pooled ResNet
features to float32 (JAX ``resnet.py:116``), so even in float64 the
losses agree to about 1e-7, not to 1e-15.

``TOL_STEP_64`` holds one float64 step, each limit four to five times the
larger of what this CPU reads in rgb and in hybrid: the losses 4e-7 (read
3.7e-8 of 6.3 / 8.7e-8 of 7.3), the open-set predictions 3e-9 (read
5.7e-10 / 6.1e-10), every gradient leaf 3e-7 of its largest entry (read
7.5e-8 / 7.6e-8), the running stats after the step 5e-13 (read 1.25e-13 /
1.03e-13). ``fs_correct`` and the gate ``w`` are equal exactly.
"""

import tempfile
import time

import jax
import numpy as np
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.models.trx import TRXOS as JaxTRXOS
from isbfsar_tpu.train import trainer as jtr
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.models.layers import init_random, update_running_stats
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.train import trainer as ttr
from isbfsar_tpu_torch.train.synthetic import episodic_batch
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables

RGB_SIZE, BATCH = 32, 2
KEYS = ("support_set", "target_set", "unknown_set", "support_classes", "target_class")
# a batch on which the few-shot head is right for one episode of the two in
# both modes, so that the discriminator's gate is exercised both ways
BATCH_SEED = 1
TOL_STEP_64 = {"loss": 4e-7, "pred": 3e-9, "grad_rel": 3e-7, "stats": 5e-13}


def configs(mode: str, dtype: str = "float32", **kw):
    """(JAX ARConfig, port ARConfig) at the CI size in ``dtype``."""
    kw = dict(rgb_size=RGB_SIZE, batch_size=BATCH, compute_dtype=dtype, **kw)
    return jc.ARConfig.for_input(mode, **kw), tc.ARConfig.for_input(mode, **kw)


def init_variables(mode: str, seed: int = 0) -> dict:
    """The port's seeded init as Flax variables {params, batch_stats}
    (float32 numpy leaves)."""
    model = TRXOS(configs(mode)[1])
    init_random(model, torch.Generator().manual_seed(seed))
    return jax.tree.map(lambda t: t.numpy(), to_flax_variables(model.state_dict()))


def cast(tree, dtype: str):
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), tree)


def batch(mode: str, seed: int = BATCH_SEED) -> dict:
    return episodic_batch(configs(mode)[1], BATCH, RGB_SIZE, mode, seed=seed)


def jax_batch(b: dict, dtype: str) -> dict:
    return {k: cast(b[k], dtype) if k.endswith("_set") else b[k] for k in KEYS}


def torch_batch(b: dict, dtype=torch.float32) -> dict:
    return {k: ({m: torch.from_numpy(v).to(dtype) for m, v in b[k].items()}
                if k.endswith("_set") else torch.from_numpy(np.asarray(b[k], np.int32)))
            for k in KEYS}


def jax_value_and_grads(mode: str, variables: dict, b: dict, dtype: str, discs=(False, True)):
    """JAX's ``make_loss_fn`` under ``jax.value_and_grad`` for each
    ``disc_on`` in ``discs``, one jit: {disc_on: ((total, metrics), grads)}
    with numpy leaves; metrics["batch_stats"] are the stats after the known
    episode's apply."""
    jcfg = configs(mode, dtype)[0]
    v = cast(variables, dtype)
    with jax.enable_x64(dtype == "float64"):
        vg = jax.value_and_grad(jtr.make_loss_fn(JaxTRXOS(jcfg), jcfg), has_aux=True)
        out = jax.jit(lambda p, s, bb: [vg(p, s, bb, d) for d in discs])(
            v["params"], v["batch_stats"], jax_batch(b, dtype))
        return dict(zip(discs, jax.tree.map(np.asarray, out)))


def port_model(mode: str, variables: dict, dtype: str = "float32", **kw) -> TRXOS:
    model = TRXOS(configs(mode, dtype, **kw)[1]).to(getattr(torch, dtype))
    model.load_state_dict(convert_variables(cast(variables, dtype)), strict=True)
    return model


def port_loss_step(model: TRXOS, b: dict, disc_on: bool, dtype=torch.float32):
    """The trainer's loss, its gradients and the running-stat update, as
    ``Trainer._train_step`` runs them: (total, metrics, grads as a Flax
    params tree, batch_stats after the update as a Flax tree), numpy."""
    stats = []
    total, metrics = ttr.make_loss_fn(model, model.config)(torch_batch(b, dtype), disc_on,
                                                           stats=stats)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    update_running_stats(stats)
    tree = jax.tree.map(lambda t: t.numpy(), to_flax_variables(dict(zip(names, grads))))
    state = jax.tree.map(lambda t: t.numpy(), to_flax_variables(model.state_dict()))
    metrics = {k: v.detach().numpy() for k, v in metrics.items()}
    return float(total.detach()), metrics, tree["params"], state["batch_stats"]


def steps(mode: str) -> dict:
    """The CI-size init and batch, and for disc off and on JAX's float64
    ``value_and_grad`` beside the port's float64 step:
    {"variables", "batch", False: (jax, port), True: (jax, port)}."""
    variables, b = init_variables(mode), batch(mode)
    jax64 = jax_value_and_grads(mode, variables, b, "float64")
    out = {"mode": mode, "variables": variables, "batch": b}
    for d in (False, True):
        out[d] = jax64[d], port_loss_step(port_model(mode, variables, "float64"), b, d,
                                          torch.float64)
    return out


def check_step(steps: dict, disc_on: bool) -> None:
    """Losses, gate, predictions and every gradient leaf within TOL_STEP_64."""
    ((jtotal, jmet), jgrads), (total, met, grads, _) = steps[disc_on]
    tol = TOL_STEP_64
    np.testing.assert_array_equal(met["fs_correct"], jmet["fs_correct"])
    assert 0 < met["fs_correct"].sum() < met["fs_correct"].size
    assert abs(total - float(jtotal)) <= tol["loss"], (total, float(jtotal))
    assert abs(float(met["fs_loss"]) - float(jmet["fs_loss"])) <= tol["loss"]
    if disc_on:
        np.testing.assert_array_equal(met["os_weights"], jmet["os_weights"])
        assert abs(float(met["os_loss"]) - float(jmet["os_loss"])) <= tol["loss"]
        for k in ("os_known_pred", "os_unknown_pred"):
            assert float(np.max(np.abs(met[k] - jmet[k]))) <= tol["pred"], k
    else:
        assert "os_loss" not in met
    err = max_rel(jgrads, grads)
    assert err <= tol["grad_rel"], err


def check_step_stats(steps: dict) -> None:
    """The running stats after one step (disc on) are JAX's: the query's
    statistics, then the support's, and nothing of the unknown episode's,
    which moves them far more than the tolerance when it is applied too."""
    (_, jmet), _ = steps[True][0]
    assert max_abs(jmet["batch_stats"], steps[True][1][3]) <= TOL_STEP_64["stats"]
    model = port_model(steps["mode"], steps["variables"], "float64")
    stats = []
    clips = torch_batch(steps["batch"], torch.float64)
    with torch.no_grad():
        for key in ("target_set", "support_set", "unknown_set"):
            model.extract_features(clips[key], True, stats)
    update_running_stats(stats)
    with_unknown = jax.tree.map(lambda t: t.numpy(),
                                to_flax_variables(model.state_dict())["batch_stats"])
    assert max_abs(jmet["batch_stats"], with_unknown) > 1e3 * TOL_STEP_64["stats"]


def float32_errors(fs_loss: float, grads, batch_stats, jmet, jgrads) -> dict:
    """A float32 step's distance from JAX's float64 step: the few-shot loss,
    the gradient as one vector (relative L2) and the running stats (the
    largest error relative to its leaf)."""
    ref = flat(jgrads)
    return {"loss": abs(fs_loss - float(jmet["fs_loss"])),
            "grad": float(np.linalg.norm(flat(grads) - ref) / np.linalg.norm(ref)),
            "stats": max_rel(jmet["batch_stats"], batch_stats)}


def numpy_tree(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def divergence(mode: str, n_steps: int = 3) -> list:
    """Two float32 port trainers from one init on the same batches, one on
    1 thread and one on 4 (other summation orders): the fs_loss difference
    after each free-running step."""
    cfg = configs(mode)[1]
    losses = []
    for threads in (1, 4):
        torch.set_num_threads(threads)
        with tempfile.TemporaryDirectory() as root:
            trainer = ttr.Trainer(cfg, log_dir=root, use_wandb=False, seed=1, device="cpu")
            losses.append([float(trainer.step(batch(mode, i))["fs_loss"])
                           for i in range(n_steps)])
    return [abs(a - b) for a, b in zip(*losses)]


def loader_frame_ms(repeats: int = 50) -> dict:
    """This CPU's time for one 224x224 crop written by the port: its PNG
    decode, and the rgb loader's whole frame (decode, whitening)."""
    from isbfsar_tpu_torch.train.dataloader import _load_frame_image
    from isbfsar_tpu_torch.train.synthetic import generate_dataset
    from isbfsar_tpu_torch.utils.png import read_png

    with tempfile.TemporaryDirectory() as root:
        generate_dataset(root, n_classes=1, clips_per_class=1, with_images=True)
        clip = f"{root}/action_00/0"
        out = {}
        for name, fn in (("decode", lambda i: read_png(f"{clip}/{i}.png")),
                         ("loader frame", lambda i: _load_frame_image(clip, i))):
            t = time.perf_counter()
            for r in range(repeats):
                fn(r % 16)
            out[name] = (time.perf_counter() - t) / repeats * 1e3
    return out


def report() -> None:
    """Print this CPU's PNG decode time, how far one float32 step (disc on)
    of the port and of JAX is from JAX's float64 step, per mode (the
    readings behind the float32 limits), and how fast two float32 runs
    part."""
    print("ms per 224x224 frame on this CPU:", loader_frame_ms())
    for mode in ("rgb", "hybrid"):
        print(mode, "free-running fs_loss, 1 thread against 4, after each step:",
              divergence(mode))
        variables, b = init_variables(mode), batch(mode)
        (_, jmet), jgrads = jax_value_and_grads(mode, variables, b, "float64", (True,))[True]
        (_, jmet32), jgrads32 = jax_value_and_grads(mode, variables, b, "float32", (True,))[True]
        _, met, grads, stats = port_loss_step(port_model(mode, variables), b, True)
        print(mode, "float32 vs JAX's float64 step, the port:",
              float32_errors(float(met["fs_loss"]), grads, stats, jmet, jgrads),
              "JAX:", float32_errors(float(jmet32["fs_loss"]), jgrads32,
                                     jmet32["batch_stats"], jmet, jgrads),
              f"(fs_loss {float(jmet['fs_loss']):.6g})")


def walk(a, b, path=""):
    """(path, a leaf, b leaf) over two trees of the same keys."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a, np.float64), np.asarray(b, np.float64)


def max_rel(want, got) -> float:
    """The largest leaf error relative to that leaf's largest entry."""
    return max(float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(a))), 1e-30)
               for _, a, b in walk(want, got))


def max_abs(want, got) -> float:
    return max(float(np.max(np.abs(a - b))) for _, a, b in walk(want, got))


def flat(tree) -> np.ndarray:
    return np.concatenate([a.ravel() for _, a, _ in walk(tree, tree)])


if __name__ == "__main__":
    report()
