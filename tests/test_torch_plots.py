"""The port's offline plots against JAX's: ``evals.plot_fsos`` and
``plot_confusion`` write PNGs pixel-equal to JAX's, ``eval_cli --plot``
writes them from the CLI (fsos and confusion modes), and
``qualitative.qualitative_episodes`` gives JAX's records on the same tree
and weights (the same episodes, predictions and names exactly; the
softmax and the open-set scores within TOL_PROBS and TOL_IS_TRUE, float32,
read 7.5e-8 and 6e-8 on a CPU) and a grid PNG pixel-equal to JAX's where
the numbers it prints (two decimals) agree."""

import json

import jax
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)
cv2 = pytest.importorskip("cv2")

from isbfsar_tpu import configs as jc  # noqa: E402
from isbfsar_tpu.train import evals as jev  # noqa: E402
from isbfsar_tpu.train import qualitative as jq  # noqa: E402
from isbfsar_tpu_torch import configs as tc  # noqa: E402
from isbfsar_tpu_torch.models.layers import init_random  # noqa: E402
from isbfsar_tpu_torch.models.trx import TRXOS  # noqa: E402
from isbfsar_tpu_torch.train import eval_cli  # noqa: E402
from isbfsar_tpu_torch.train import evals as tev  # noqa: E402
from isbfsar_tpu_torch.train import qualitative as tq  # noqa: E402
from isbfsar_tpu_torch.train.synthetic import generate_dataset  # noqa: E402
from isbfsar_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from isbfsar_tpu_torch.weights import to_flax_variables  # noqa: E402

torch.set_num_threads(2)

TOL_PROBS = 3e-7
TOL_IS_TRUE = 2.5e-7
RESULTS = {"FSOS-ACC": [0.8, 0.7, 0.75], "FS-ACC": [0.9, 0.95, 0.85], "OS-ACC": [0.6, 0.7, 0.5]}


def _pixels(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None and img.size > 0, path
    return img


@pytest.mark.parametrize("results", [RESULTS, {"FSOS-ACC": [0.5], "OS-ACC": []}],
                         ids=["three", "partial"])
def test_plot_fsos_pixel_equal(tmp_path, results):
    tev.plot_fsos(results, str(tmp_path / "t.png"))
    jev.plot_fsos(results, str(tmp_path / "j.png"))
    assert np.array_equal(_pixels(tmp_path / "t.png"), _pixels(tmp_path / "j.png"))


def test_plot_confusion_pixel_equal(tmp_path):
    classes = [f"action_{i:02d}" for i in range(7)]
    matrix = np.random.default_rng(0).random((7, 7))
    matrix[2, 3] = np.nan
    tev.plot_confusion(matrix, classes, str(tmp_path / "t.png"))
    jev.plot_confusion(matrix, classes, str(tmp_path / "j.png"))
    assert np.array_equal(_pixels(tmp_path / "t.png"), _pixels(tmp_path / "j.png"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 6-class tree and a random recognizer's Flax variables and checkpoint."""
    root = tmp_path_factory.mktemp("plots")
    generate_dataset(str(root / "tree"), n_classes=6, clips_per_class=2, seed=1)
    model = TRXOS(tc.ARConfig())
    init_random(model, torch.Generator().manual_seed(2))
    params = jax.tree.map(lambda t: t.numpy(), to_flax_variables(model.state_dict())["params"])
    ckpt = save_checkpoint(str(root / "ckpt"), 0,
                           {"params": params, "batch_stats": {}, "opt_state": {"count": 0}})
    return root, params, ckpt


@pytest.mark.parametrize("mode", ["fsos", "confusion"])
def test_eval_cli_plot_writes_the_file(trained, capsys, mode):
    root, _, ckpt = trained
    out = root / f"{mode}.png"
    rc = eval_cli.main([mode, "--data", str(root / "tree"), "--checkpoint", ckpt, "--repeats",
                        "1", "--batch-size", "4", "--device", "cpu", "--plot", str(out)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert ("FSOS-ACC" in printed) if mode == "fsos" else (len(printed["classes"]) == 6)
    img = _pixels(out)
    assert img.ndim == 3 and img.shape[0] > 100 and len(np.unique(img)) > 10


def test_qualitative_episodes_equal_jax(trained, tmp_path):
    root, params, _ = trained
    got = tq.qualitative_episodes(tc.ARConfig(), params, str(root / "tree"), str(tmp_path / "t"),
                                  n_episodes=3, seed=5, device="cpu")
    want = jq.qualitative_episodes(jc.ARConfig(), params, str(root / "tree"), str(tmp_path / "j"),
                                   n_episodes=3, seed=5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g["pred"], g["true"]) == (w["pred"], w["true"])
        np.testing.assert_allclose(g["probs"], np.asarray(w["probs"]), rtol=0, atol=TOL_PROBS)
        assert abs(g["is_true"] - w["is_true"]) <= TOL_IS_TRUE
        assert abs(g["is_true_unknown"] - w["is_true_unknown"]) <= TOL_IS_TRUE
        printed = [f"{float(np.max(r['probs'])):.2f} {r['is_true']:.2f} "
                   f"{r['is_true_unknown']:.2f}" for r in (g, w)]
        if printed[0] == printed[1]:
            assert np.array_equal(_pixels(g["path"]), _pixels(w["path"]))
