"""The focus alternatives' trainers (``train/detection.py``,
``train/mutualgaze.py``) against the JAX package's on the CPU: one step of
each in float64 and in float32 from JAX's init (``tests/torch_mutual_parity.py``
says what is compared and why), the draw order of an epoch, the
evaluation, cross-validation from JAX's init of each fold, checkpoints that
both packages read, and the datasets.

Readings (``python -m tests.torch_mutual_parity``), float64 then float32
against JAX's float64 step: the detector loss 0 of 1.21, gradient 4.8e-6 of
its leaf, parameters 1.6e-7, running stats 6.0e-8 (momentum 0.99), and in
float32 the gradient 2.1e-5 (JAX's own 0.19); the mutual-gaze trainer loss
6.0e-8 of 0.86, gradient 4.8e-7, parameters 1.1e-6 (lr 1e-6), stats 5.9e-8
(momentum 0.9), and in float32 the loss 1.4e-5 (JAX's own 4.5e-6) and the
gradient 2.9e-4 (JAX's own 4.8e-4).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.train import detection as jdet
from isbfsar_tpu.train import mutualgaze as jmg
from isbfsar_tpu.utils import checkpoint as jckpt
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.train import detection as tdet
from isbfsar_tpu_torch.train import mutualgaze as tmg
from isbfsar_tpu_torch.utils import checkpoint as tckpt
from isbfsar_tpu_torch.utils.png import write_png
from tests import torch_mutual_parity as M
from tests import torch_synth_parity as P
from tests.torch_rgb_parity import max_abs, walk

torch.set_num_threads(2)

# cross_validate's best-F1 checkpoints after 2 float32 steps a fold from
# JAX's init, this package against JAX's: the parameters' update in relative
# L2 read 0.084 and the running stats 2.7e-3 on an x86 CPU (fold 0; fold 1
# below both); the limits are about 3.5 times that
TOL_CV_UPDATE, TOL_CV_STATS = 0.3, 1e-2


@pytest.fixture(scope="module", params=M.KINDS)
def step_readings(request):
    return request.param, M.readings(request.param)


def test_step_in_float64_matches_jax(step_readings):
    kind, r = step_readings
    over = {k: v for k, v in r["float64"].items() if not v <= P.TOL_STEP_64[k]}
    assert not over, (kind, over, r)


def test_step_in_float32_is_near_jax(step_readings):
    P.check_readings(step_readings[1])


@pytest.mark.parametrize("kind", M.KINDS)
def test_running_stats_move_by_the_nets_momentum(kind):
    """The stats limit sees the momentum: 0.99 in the detector's trunk,
    0.9 in the ResNet-18. One float32 step from JAX's init moves JAX's stats
    by far more than the limit, and a port whose every BatchNorm took the
    other momentum would move them ten times as far (or a tenth)."""
    variables = M.init_variables(kind)
    batch = M.detector_batch() if kind == "detector" else M.watching_batch()
    s = M.one_step(kind, "float32", variables, batch)
    moved = max_abs(variables["batch_stats"], s["jax"]["stats"])
    assert moved > 1e3 * P.TOL_STEP_64["stats"]
    assert max_abs(s["jax"]["stats"], s["port"]["stats"]) <= 1e-2 * moved
    with M.tempfile.TemporaryDirectory() as tmp:
        pt = M.port_trainer(kind, "float32", variables, tmp)
        nets = [pt.net] if kind == "detector" else [pt.backbone]
        momenta = {m.momentum for n in nets for m in n.modules() if hasattr(m, "momentum")}
        if kind == "mutual":
            pt.logger.close()
    assert momenta == ({0.99} if kind == "detector" else {0.9})


# ------------------------------------------------------------------- trees


def write_watching_tree(root: str, n_per: int = 3, size: int = 32, seed: int = 0) -> None:
    """root/<s0|s1>/<0|1>/<i>.png: label 1 bright, label 0 dark, with noise."""
    rng = np.random.default_rng(seed)
    for session in ("s0", "s1"):
        for label in (0, 1):
            d = os.path.join(root, session, str(label))
            os.makedirs(d, exist_ok=True)
            for i in range(n_per):
                img = np.clip(40 + 180 * label + rng.normal(0, 20, (size, size, 3)), 0, 255)
                write_png(os.path.join(d, f"{i}.png"), img.astype(np.uint8))


def test_watching_dataset_matches_jax(tmp_path):
    """PNG decode and INTER_LINEAR resize without cv2, equal to JAX's cv2
    reads, at the stored size and resized 40 -> 32."""
    for size in (32, 40):
        root = str(tmp_path / str(size))
        write_watching_tree(root, n_per=2, size=size)
        want, got = jmg.WatchingDataset(root, crop_size=32), tmg.WatchingDataset(root, crop_size=32)
        assert want.items == got.items and len(got) == 8
        for i in range(len(got)):
            (a, la), (b, lb) = want[i], got[i]
            assert la == lb and b.dtype == np.float32 and np.array_equal(a, b)


def test_session_splits():
    splits = list(tmg.session_splits(["a", "b", "c"]))
    assert len(splits) == 3 and splits[0] == (["b", "c"], ["a"])
    assert splits == list(jmg.session_splits(["a", "b", "c"]))


def test_augment_flip_draws_as_jax():
    img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(8):
        (x, lx), (y, ly) = jmg.augment_flip(img, 1, a), tmg.augment_flip(img, 1, b)
        assert np.array_equal(x, y) and lx == ly


def _recorded_epoch(trainer, dataset, step_attr: str, **kw):
    seen = []
    if step_attr == "_step":  # JAX: (params, stats, opt, images, labels)
        trainer._step = lambda p, s, o, x, y: (seen.append((np.asarray(x), np.asarray(y))),
                                               (p, s, o, 0.0, None))[1]
    else:
        trainer.train_step = lambda x, y: (seen.append((np.asarray(x), np.asarray(y))), 0.0)[1]
    trainer.train_epoch(dataset, **kw)
    return seen


def test_train_epoch_draws_in_jax_order(tmp_path):
    """The permutation, then one flip draw an item as it is loaded: the
    batches (images and labels) equal JAX's, augmented or not."""
    root = str(tmp_path / "data")
    write_watching_tree(root, n_per=3)
    ds = tmg.WatchingDataset(root, crop_size=32)
    jt = jmg.MutualGazeTrainer(jc.MutualGazeConfig(crop_size=32), log_dir=str(tmp_path / "j"))
    pt = tmg.MutualGazeTrainer(M.mutual_config(), log_dir=str(tmp_path / "p"), device="cpu")
    for kw in (dict(batch_size=4, seed=3), dict(batch_size=5, seed=0, augment=False)):
        want = _recorded_epoch(jt, ds, "_step", **kw)
        got = _recorded_epoch(pt, ds, "train_step", **kw)
        assert len(got) == len(want) == 12 // kw["batch_size"]
        for (a, la), (b, lb) in zip(want, got):
            assert np.array_equal(a, b) and np.array_equal(la, lb)
    jt.logger.close()
    pt.logger.close()


def _float32_pair(tmp_path, seed: int = 0):
    """JAX's trainer with a float32 backbone and the port's from JAX's init."""
    jt = M.jax_mutual_trainer(str(tmp_path / "j"), "float32", lr=1e-3)
    variables = M.init_variables("mutual", seed)
    pt = tmg.MutualGazeTrainer(M.mutual_config(lr=1e-3), log_dir=str(tmp_path / "p"),
                               device="cpu", dtype=torch.float32)
    pt.reset(seed, variables=variables)
    return jt, pt


def test_evaluate_matches_jax(tmp_path):
    root = str(tmp_path / "data")
    write_watching_tree(root, n_per=3)
    ds = tmg.WatchingDataset(root, crop_size=32)
    jt, pt = _float32_pair(tmp_path)
    images = np.stack([ds[i][0] for i in range(len(ds))])
    want = np.asarray(jt._predict(jt.params, jt.batch_stats, jnp.asarray(images)))
    got = pt.predict(images).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert pt.evaluate(ds, batch_size=5) == jt.evaluate(ds, batch_size=5)
    jt.logger.close()
    pt.logger.close()


def test_cross_validate_from_jax_inits_matches_jax(tmp_path):
    """Both packages' cross-validation, each fold from JAX's init of that
    fold (the port's ``reset(fold)`` handed it): one ``reset`` a fold, the
    folds' metrics equal, the best-F1 checkpoints close, and each package
    reads the other's."""
    root = str(tmp_path / "data")
    write_watching_tree(root, n_per=2)
    jt, pt = _float32_pair(tmp_path)
    inits = {fold: M.init_variables("mutual", fold) for fold in (0, 1)}
    resets, orig = [], pt.reset
    pt.reset = lambda seed=0: (resets.append(seed), orig(seed, variables=inits[seed]))[1]
    want = jt.cross_validate(root, n_epochs=2, batch_size=4, ckpt_dir=str(tmp_path / "jck"))
    got = pt.cross_validate(root, n_epochs=2, batch_size=4, ckpt_dir=str(tmp_path / "pck"))
    assert resets == [0, 1] and got == want
    for fold in (0, 1):
        template = jax.tree.map(np.asarray, jt.variables)
        jtree = jckpt.load_checkpoint(str(tmp_path / "pck" / f"{fold}.msgpack"), template)
        ptree = tckpt.load_checkpoint(str(tmp_path / "jck" / f"{fold}.msgpack"),
                                      jax.tree.map(lambda _: None, template))
        # float32 steps from one init: Adam's first updates are about lr *
        # sign(g), and entries whose gradient lies near zero part by 2 lr
        # a step (tests/torch_synth_parity.py), so the parameters are held
        # as one update vector, the running stats entry by entry
        init = P.numpy_tree(inits[fold])
        jtree, ptree = P.numpy_tree(jtree), P.numpy_tree(ptree)
        update = P.update_rel_l2(jtree["params"], ptree["params"], init["params"])
        stats = max_abs(jtree["batch_stats"], ptree["batch_stats"])
        assert update <= TOL_CV_UPDATE and stats <= TOL_CV_STATS, (fold, update, stats)
    jt.logger.close()
    pt.logger.close()


def test_checkpoint_bytes_equal_jax(tmp_path):
    """The same tree written by each package: the same bytes, and each reads
    the other's. The JAX trainer's ``variables`` puts "params" first."""
    variables = M.init_variables("mutual", 0)
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    jtree = {"params": f32["params"], "batch_stats": f32["batch_stats"]}
    pt = tmg.MutualGazeTrainer(M.mutual_config(), log_dir=str(tmp_path / "p"), device="cpu")
    pt.reset(0, variables=variables)
    jp = jckpt.save_checkpoint(str(tmp_path / "j"), 0, jtree, meta={"fold": 0})
    tp = tckpt.save_checkpoint(str(tmp_path / "t"), 0, pt.variables, meta={"fold": 0})
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    back = tckpt.load_checkpoint(jp, jax.tree.map(lambda _: None, jtree))
    for _, a, b in walk(jtree, P.numpy_tree(back)):
        assert np.array_equal(a, b)
    pt.logger.close()


def test_evaluate_gaze_heuristic():
    class FakeDetector:
        def estimate(self, frame):
            if frame.mean() < 5:
                return None
            return bool(frame.mean() > 128), None

    frames = [(np.full((8, 8, 3), 200, np.uint8), True), (np.full((8, 8, 3), 10, np.uint8), False),
              (np.full((8, 8, 3), 220, np.uint8), True), (np.zeros((8, 8, 3), np.uint8), True)]
    got = tmg.evaluate_gaze_heuristic(FakeDetector(), frames)
    assert got == jmg.evaluate_gaze_heuristic(FakeDetector(), frames)
    assert got["accuracy"] == 1.0 and got["f1"] == 1.0


def test_mutual_gaze_train_and_evaluate(tmp_path):
    """JAX's contract test: the loss falls on trivially separable labels."""
    root = str(tmp_path)
    write_watching_tree(root, size=32)
    cfg = dataclasses.replace(tc.MutualGazeConfig(), crop_size=32, lr=1e-3)
    trainer = tmg.MutualGazeTrainer(cfg, log_dir=str(tmp_path / "log"), device="cpu")
    ds = tmg.WatchingDataset(root, crop_size=32)
    assert len(ds) == 12
    first = trainer.train_epoch(ds, batch_size=4, seed=0)
    for e in range(1, 6):
        last = trainer.train_epoch(ds, batch_size=4, seed=e)
    assert last < first
    assert trainer.evaluate(ds, batch_size=4)["accuracy"] > 0.6
    trainer.logger.close()


# ---------------------------------------------------------------- detector


def _write_voc_sample(root, name, boxes, size=64):
    import cv2

    os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)
    objs = "".join(
        f"<object><name>head</name><bndbox><xmin>{x1 * size}</xmin><ymin>{y1 * size}</ymin>"
        f"<xmax>{x2 * size}</xmax><ymax>{y2 * size}</ymax></bndbox></object>"
        for x1, y1, x2, y2 in boxes)
    with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
        f.write(f"<annotation><size><width>{size}</width><height>{size}</height>"
                f"<depth>3</depth></size>{objs}</annotation>")
    img = np.zeros((size, size, 3), np.uint8)
    for x1, y1, x2, y2 in boxes:
        img[int(y1 * size): int(y2 * size), int(x1 * size): int(x2 * size)] = 255
    cv2.imwrite(os.path.join(root, "JPEGImages", f"{name}.jpg"), img)


def test_voc_dataset_matches_jax(tmp_path):
    root = str(tmp_path)
    _write_voc_sample(root, "a", [(0.1, 0.1, 0.4, 0.5), (0.6, 0.6, 0.9, 0.9)], size=80)
    _write_voc_sample(root, "b", [(0.2, 0.3, 0.5, 0.6)] * 6, size=80)
    want, got = jdet.VOCHeadDataset(root, 64, 4), tdet.VOCHeadDataset(root, 64, 4)
    assert len(got) == 2 and got.ids == want.ids
    for i in range(2):
        for k, v in want[i].items():
            assert got[i][k].dtype == v.dtype and np.array_equal(got[i][k], v), k
    np.testing.assert_allclose(got[0]["boxes"][0], [0.1, 0.1, 0.4, 0.5], atol=1e-6)
    assert got[0]["valid"].sum() == 2 and got[1]["valid"].all()


def test_detector_trainer_loss_decreases(tmp_path):
    """JAX's contract test on the port (bf16, as JAX's trainer)."""
    root = str(tmp_path)
    for i in range(4):
        _write_voc_sample(root, f"s{i}", [(0.2, 0.2, 0.6, 0.7)])
    ds = tdet.VOCHeadDataset(root, image_size=64, max_boxes=4)
    trainer = tdet.DetectorTrainer(tc.MutualGazeConfig(), input_size=64, lr=1e-4, device="cpu")
    losses = trainer.fit(ds, n_epochs=8, batch_size=4)
    assert min(losses[-3:]) < losses[0]
    assert np.isfinite(losses).all()
    assert set(trainer.variables) == {"params", "batch_stats"}
