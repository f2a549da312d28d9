"""The port's offline evaluation against the JAX package's, on the CPU: the
FSOS protocol (``evaluate_fsos`` with its raw triples, ``metrics_at_threshold``,
``calibrate_os_threshold``, ``summarize``), ``episodic_test`` and
``discriminator_confusion``.

Both packages hold the same recognizer: the JAX init (``jax.random.key(0)``)
after two JAX training steps on the training tree, carried across by the
weight bridge; the production ``ARConfig`` in float32. Its open-set scores
lie within 0.015 of 0.5. ``episodic_test`` draws its
episodes on the loader's thread pool, whose draw order depends on
scheduling in both packages, so both run with one loader thread here.

Tolerances, a few times what this CPU reads: the open-set scores 2.5e-7
(read 6.0e-8 of 0.51) and the confusion matrix's mean scores 2.5e-7 (read
3.0e-8).
``known``, ``fs_correct``, the FSOS metrics at every threshold and the
calibrated threshold are equal exactly; the scores' distance to each
threshold used is checked to exceed the score tolerance, so no comparison
of a score with a threshold can flip within it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.models.trx import TRXOS as JaxTRXOS
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.train import dataloader as jdl
from isbfsar_tpu.train import evals as jevals
from isbfsar_tpu.train import fsos as jfsos
from isbfsar_tpu.train import trainer as jtr
from isbfsar_tpu.train.synthetic import generate_dataset
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.train import dataloader as tdl
from isbfsar_tpu_torch.train import evals as tevals
from isbfsar_tpu_torch.train import fsos as tfsos

torch.set_num_threads(2)

JCFG = jc.ARConfig.for_input("skeleton")
TCFG = tc.ARConfig.for_input("skeleton")
TOL_SCORE = 2.5e-7
CALIB_GRID = np.linspace(0.02, 0.98, 97)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("fsos")
    generate_dataset(str(base / "train"), n_classes=8, clips_per_class=3, seed=0)
    generate_dataset(str(base / "held"), n_classes=7, clips_per_class=3, seed=1)
    generate_dataset(str(base / "small"), n_classes=4, clips_per_class=3, seed=2)
    return {k: str(base / k) for k in ("train", "held", "small")}


@pytest.fixture(scope="module")
def params(trees, tmp_path_factory):
    """The JAX init after two JAX training steps, numpy leaves."""
    cfg = dataclasses.replace(JCFG, n_task=16, batch_size=8)
    trainer = jtr.Trainer(cfg, mesh=make_mesh(1), use_wandb=False,
                          log_dir=str(tmp_path_factory.mktemp("fsos_log")))
    sampler = jdl.EpisodicSampler(trees["train"], k=5, n_task=16, l=16, seed=0)
    trainer.run_epoch(0, jdl.batch_iterator(sampler, 8, num_threads=1), train=True)
    return {"params": jax.tree.map(np.asarray, trainer.params)}


def _clear(scores, thresholds):
    """No score within TOL_SCORE of a threshold it is compared with."""
    gap = np.min(np.abs(np.asarray(scores, np.float64)[:, None] - np.asarray(thresholds)[None]))
    assert gap > TOL_SCORE, f"a score lies {gap} from a threshold: pick another seed"


@pytest.mark.parametrize("tree,k", [("held", 5), ("small", 5)])
def test_evaluate_fsos_matches_jax(trees, params, tree, k):
    """Raw triples per repeat and the metrics. On the 4-class tree k=5
    shrinks to k_eff=4, and the evaluation mask is 4 wide."""
    kw = dict(k=k, n_repeats=3, batch_size=4, seed=1, collect_raw=True)
    want = jfsos.evaluate_fsos(JCFG, params, trees[tree], trees[tree], **kw)
    got = tfsos.evaluate_fsos(TCFG, params, trees[tree], trees[tree], device="cpu", **kw)
    assert len(got["_raw"]) == len(want["_raw"]) == 3
    for w, g in zip(want["_raw"], got["_raw"]):
        np.testing.assert_array_equal(g["known"], w["known"])
        np.testing.assert_array_equal(g["fs_correct"], w["fs_correct"])
        assert g["scores"].shape == w["scores"].shape
        assert float(np.max(np.abs(g["scores"] - w["scores"]))) <= TOL_SCORE
        _clear(w["scores"], [0.5])
    n_known = sum(int(r["known"].sum()) for r in got["_raw"])
    n_all = sum(r["known"].size for r in got["_raw"])
    # with k_eff equal to the class count every query is known
    assert 0 < n_known < n_all if tree == "held" else n_known == n_all
    for key in ("FSOS-ACC", "FS-ACC", "OS-ACC"):
        assert got[key] == want[key], key
    assert tfsos.summarize(got) == jfsos.summarize(want)


def test_metrics_at_threshold_matches_jax(trees, params):
    raw = jfsos.evaluate_fsos(JCFG, params, trees["held"], trees["held"], k=5, n_repeats=2,
                              batch_size=8, collect_raw=True)["_raw"]
    for thr in (0.3, 0.5, 0.62, 0.9):
        assert tfsos.metrics_at_threshold(raw, thr) == jfsos.metrics_at_threshold(raw, thr)
    empty = [{"scores": np.zeros(0), "known": np.zeros(0, bool), "fs_correct": np.zeros(0, bool)}]
    assert tfsos.metrics_at_threshold(empty, 0.5) == jfsos.metrics_at_threshold(empty, 0.5)


def test_calibrate_os_threshold_matches_jax(trees, params):
    """The same procedure on the training tree (exemplars left out of the
    queries) picks the same threshold with the same balanced accuracy."""
    kw = dict(k=5, n_repeats=3, batch_size=8, seed=2)
    want = jfsos.calibrate_os_threshold(JCFG, params, trees["train"], **kw)
    got = tfsos.calibrate_os_threshold(TCFG, params, trees["train"], device="cpu", **kw)
    assert got == want
    raw = tfsos.evaluate_fsos(TCFG, params, trees["train"], trees["train"], device="cpu",
                              collect_raw=True, exclude_exemplar_queries=True, **kw)["_raw"]
    _clear(np.concatenate([r["scores"] for r in raw]), np.append(CALIB_GRID, 0.5))
    assert got["n_queries"] == 8 * 3 * 3 - 3 * 5  # each repeat leaves its 5 exemplars out


def test_episodic_test_matches_jax(trees, params, monkeypatch):
    one_thread = {"num_threads": 1}
    monkeypatch.setattr(jevals, "batch_iterator", functools.partial(jdl.batch_iterator,
                                                                    **one_thread))
    monkeypatch.setattr(tevals, "batch_iterator", functools.partial(tdl.batch_iterator,
                                                                    **one_thread))
    want = jevals.episodic_test(JCFG, params, trees["held"], n_task=12, batch_size=4, seed=3)
    got = tevals.episodic_test(TCFG, params, trees["held"], n_task=12, batch_size=4, seed=3,
                               device="cpu")
    assert got == want


def test_discriminator_confusion_matches_jax(trees, params):
    classes = tdl.list_classes(trees["small"])[:3]
    kw = dict(classes=classes, max_queries_per_class=2)
    want = jevals.discriminator_confusion(JCFG, params, trees["held"], trees["small"], **kw)
    got = tevals.discriminator_confusion(TCFG, params, trees["held"], trees["small"],
                                         device="cpu", **kw)
    assert got.shape == want.shape == (3, 3)
    assert float(np.max(np.abs(got - want))) <= TOL_SCORE


def test_bare_parameter_tree_is_accepted(trees, params):
    """``Trainer.params`` (no "params" level) evaluates as the variables do."""
    kw = dict(k=5, n_repeats=1, batch_size=8, device="cpu", collect_raw=True)
    a = tfsos.evaluate_fsos(TCFG, params, trees["small"], trees["small"], **kw)
    b = tfsos.evaluate_fsos(TCFG, params["params"], trees["small"], trees["small"], **kw)
    np.testing.assert_array_equal(a["_raw"][0]["scores"], b["_raw"][0]["scores"])


def test_evaluators_on_cuda_without_a_card_raise(trees, params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfsos.evaluate_fsos(TCFG, params, trees["small"], trees["small"], n_repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevals.episodic_test(TCFG, params, trees["small"], n_task=4)
