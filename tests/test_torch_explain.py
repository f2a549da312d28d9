"""The port's explainability tools (``train/explain.py``) and the ResNet's
Grad-CAM capture and classifier head (``models/resnet.py``) against JAX's.

- ``top_attention_pairs``: exact.
- ``explain_episode`` in skeleton and rgb mode from one set of weights
  carried across (the port's seeded init, given to JAX by
  ``to_flax_variables``): logits within TOL_LOGITS, is_true within
  TOL_IS_TRUE, the chosen class and the top pairs' frames exact (the random
  episodes leave the runner-up class more than 1e-3 behind).
- ``grad_cam``: a ResNet-50 at 64 px with a 5-class head, float32, within
  TOL_CAM of JAX's (each CAM is normalised to [0, 1]); the head's
  ``fc/kernel`` and ``fc/bias`` load through ``convert_variables``.
- ``render_cam_overlay``: pixel-equal (both call cv2).
- ``enable_cam=False`` leaves every other ResNet user bit-equal: the
  features are the pre-change formula's, with and without remat.

The readings on a CPU (float32): logits 5.7e-6 of 19.4 (skeleton) and
4.3e-6 of 2.2 (rgb), is_true 1.2e-7 and 3.6e-7, pair scores 8.6e-8, CAM
2.9e-6; the limits are about four times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from isbfsar_tpu import configs as jc
from isbfsar_tpu.train import explain as jx
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.resnet import Bottleneck, ResNet, resnet50
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.train import explain as tx
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables

torch.set_num_threads(2)

TOL_LOGITS = {"skeleton": 2.5e-5, "rgb": 2e-5}
TOL_IS_TRUE = 1.5e-6
TOL_PAIR_SCORE = 4e-7
TOL_CAM = 1e-5
TIE_MARGIN = 1e-3


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_attention_pairs_exact(seed):
    rng = np.random.default_rng(seed)
    att = rng.random((5, 120, 120)).astype(np.float32)
    for cls in (0, 3):
        assert tx.top_attention_pairs(att, 16, cls, k=7) == jx.top_attention_pairs(att, 16, cls, k=7)


def _episode(cfg, rng):
    shapes = {"sk": (cfg.n_joints * 3,), "rgb": (cfg.rgb_size, cfg.rgb_size, 3)}
    keys = {"skeleton": ("sk",), "rgb": ("rgb",)}[cfg.input_type]
    support = {m: rng.normal(size=(1, cfg.way, cfg.seq_len) + shapes[m]).astype(np.float32)
               for m in keys}
    query = {m: rng.normal(size=(1, cfg.seq_len) + shapes[m]).astype(np.float32) for m in keys}
    return support, query


@pytest.mark.parametrize("mode", ["skeleton", "rgb"])
def test_explain_episode_equals_jax(mode):
    kw = {"rgb_size": 32} if mode == "rgb" else {}
    cfg_t, cfg_j = tc.ARConfig.for_input(mode, **kw), jc.ARConfig.for_input(mode, **kw)
    model = TRXOS(cfg_t)
    init_random(model, torch.Generator().manual_seed(3))
    variables = _np(to_flax_variables(model.state_dict()))
    support, query = _episode(cfg_t, np.random.default_rng(4))
    got = tx.explain_episode(cfg_t, variables, support, query, device="cpu")
    want = jx.explain_episode(cfg_j, variables, {k: jnp.asarray(v) for k, v in support.items()},
                              {k: jnp.asarray(v) for k, v in query.items()})
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=TOL_LOGITS[mode])
    assert abs(got["is_true"] - want["is_true"]) <= TOL_IS_TRUE
    top2 = np.sort(want["logits"])[-2:]
    assert top2[1] - top2[0] > TIE_MARGIN
    assert got["chosen_class"] == want["chosen_class"]
    assert len(got["top_attention_pairs"]) == 5
    for a, b in zip(got["top_attention_pairs"], want["top_attention_pairs"]):
        assert a["query_frames"] == b["query_frames"]
        assert a["support_frames"] == b["support_frames"]
        assert abs(a["score"] - b["score"]) <= TOL_PAIR_SCORE


@pytest.fixture(scope="module")
def cam_case():
    model = resnet50(torch.float32, num_classes=5, enable_cam=True)
    init_random(model, torch.Generator().manual_seed(5))
    variables = _np(to_flax_variables(model.state_dict()))
    assert variables["params"]["fc"]["kernel"].shape == (2048, 5)
    images = np.random.default_rng(6).random((2, 64, 64, 3)).astype(np.float32)
    return variables, images


@pytest.mark.parametrize("class_idx", [0, 3])
def test_grad_cam_equals_jax(cam_case, class_idx):
    variables, images = cam_case
    got = tx.grad_cam(variables, images, class_idx=class_idx, n_classes=5, device="cpu")
    jax_vars = {**variables, "perturbations": {"stage4": np.zeros((2, 2, 2, 2048), np.float32)}}
    want = jx.grad_cam(jax_vars, jnp.asarray(images), class_idx=class_idx, n_classes=5)
    assert got.shape == want.shape == (2, 2, 2)
    assert np.all(np.isfinite(got)) and got.max() > 0.99
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_CAM)
    # JAX's perturbation collection is ignored by the port
    again = tx.grad_cam(jax_vars, images, class_idx=class_idx, n_classes=5, device="cpu")
    assert np.array_equal(again, got)


def test_classifier_head_loads_through_convert_variables(cam_case):
    variables, images = cam_case
    model = ResNet((3, 4, 6, 3), Bottleneck, dtype=torch.float32, num_classes=5)
    model.load_state_dict(convert_variables(variables), strict=True)
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(),
                                  variables["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(model.fc.bias.detach().numpy(), variables["params"]["fc"]["bias"])
    cam = tx.cam_resnet50(variables, 5, "cpu")
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        logits, act = cam(x)
        assert act.dtype == torch.float32 and act.shape == (2, 2048, 2, 2)
        torch.testing.assert_close(logits, model.eval()(x), rtol=0, atol=1e-5)


def _pre_change_features(model, x):
    """The ResNet's forward as it was before enable_cam: the stem, the
    blocks, a float32 mean rounded to the compute type."""
    x = F.relu(model.bn1(model.conv1(x.to(model.dtype))))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for name in model.blocks:
        x = getattr(model, name)(x)
    return x.mean(dim=(2, 3), dtype=torch.float32).to(model.dtype).to(torch.float32)


@pytest.mark.parametrize("dtype,remat", [(torch.bfloat16, False), (torch.float32, True)])
def test_enable_cam_off_is_bit_equal(dtype, remat):
    model = resnet50(dtype, remat=remat)
    init_random(model, torch.Generator().manual_seed(7))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(8).random((2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
        assert torch.equal(out, _pre_change_features(model, x))
    assert model.fc is None and not any(k.startswith("fc.") for k in model.state_dict())


def test_render_cam_overlay_pixel_equal():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    image = rng.integers(0, 256, (64, 80, 3), np.uint8)
    cam = rng.random((2, 3)).astype(np.float32)
    a, b = tx.render_cam_overlay(image, cam), jx.render_cam_overlay(image, cam)
    assert a.dtype == np.uint8 and a.shape == (64, 80, 3) and np.array_equal(a, b)
