"""The rgb and hybrid building blocks of the PyTorch port against the JAX package.

The ResNet-50 (its Bottleneck and the whole net), the RGB extractor and
TRX-OS in rgb and hybrid mode (``embed_frame`` and the whole-episode
forward), the recognizer's rgb and hybrid ``inference`` and support-set
files, the fused step's square crop and whitening, and the module path's
host crop with its numpy twin of cv2's ``INTER_LINEAR`` resize.

Float32 on the CPU, 64x64 crops. The same weights go to both packages
through the weight bridge: the port's seeded init carried to Flax by
``weights.to_flax_variables`` (so no JAX init is compiled), and for the
ResNet blocks a Flax init whose BatchNorm statistics and affine parameters
are perturbed, so that inference-mode BatchNorm is not the identity it is
at init. A random ResNet-50's activations grow block by block, so its
features are held relative to their largest magnitude. The readings these
limits come from are beside each.
"""

import dataclasses

import cv2
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.models import resnet as jax_resnet
from isbfsar_tpu.ops import image as jax_image
from isbfsar_tpu.runtime.orchestrator import preprocess_ar_crop as jax_preprocess_ar_crop
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.models.layers import init_random
from isbfsar_tpu_torch.models.resnet import Bottleneck, resnet50
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.ops.image import (ar_rgb_preprocess, center_square_crop_resize,
                                         resize_linear_u8)
from isbfsar_tpu_torch.runtime.orchestrator import preprocess_ar_crop

torch.set_num_threads(2)

RGB = 64
# ResNet outputs relative to their largest magnitude: this CPU reads
# 1.5e-7-1.9e-7 for the Bottlenecks and 5.6e-7 for the ResNet-50 with
# perturbed BatchNorm; the per-frame features read 8.6e-7 (of 1.10, rgb)
# and 6.7e-7 (of 2.05, hybrid), the support features 1.1e-6, absolute.
# Summation order in float32 convolutions, XLA's against oneDNN's.
TOL_BLOCK_REL = 1e-6
TOL_RESNET_REL = 2e-6
TOL_FEATURES = 5e-6
# TRX-OS on those features: logits read 6.3e-8 (rgb) and 5.7e-6 (hybrid),
# is_true 6.0e-8; the recognizer's probs 2.4e-7, its is_true 1.2e-7.
TOL_LOGITS = 5e-5
TOL_PROBS = 2e-6
TOL_IS_TRUE = 2e-6


def _perturbed(variables, seed):
    """Flax ResNet variables with BatchNorm statistics and affine parameters
    drawn from a seed (mean N(0, 0.1), var U(0.5, 2), scale U(0.5, 1.5),
    bias N(0, 0.1)): the conv kernels stay Flax's."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        leaf = np.asarray(leaf)
        if name == "mean" or (name == "bias" and leaf.ndim == 1):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("cin,filters,stride", [(16, 8, 2), (32, 8, 1), (64, 16, 1)])
def test_bottleneck_matches_jax(cin, filters, stride):
    """Projected shortcut (stride 2, and a channel change at stride 1) and
    the identity shortcut."""
    conv = lambda *a, **kw: nn.Conv(*a, use_bias=False, dtype=jnp.float32, **kw)
    norm = lambda name: nn.BatchNorm(use_running_average=True, epsilon=1e-5, dtype=jnp.float32,
                                     name=name)
    block = jax_resnet.Bottleneck(filters=filters, strides=(stride, stride), conv=conv, norm=norm)
    x = np.random.default_rng(1).normal(size=(2, 12, 12, cin)).astype(np.float32)
    variables = _perturbed(block.init(jax.random.key(0), x), seed=2)
    want = np.asarray(block.apply(variables, x))

    ours = Bottleneck(cin, filters, stride)
    ours.load_state_dict(weights.convert_variables(variables), strict=True)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert (ours.downsample_conv is None) == (cin == filters * 4 and stride == 1)
    assert got.shape == want.shape
    assert _rel_err(got, want) < TOL_BLOCK_REL


def test_resnet50_matches_jax():
    net = jax_resnet.resnet50(dtype=jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, RGB, RGB, 3)).astype(np.float32)
    variables = _perturbed(net.init(jax.random.key(0), x), seed=4)
    want = np.asarray(jax.jit(net.apply)(variables, x))

    ours = resnet50(torch.float32)
    ours.load_state_dict(weights.convert_variables(variables), strict=True)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert _rel_err(got, want) < TOL_RESNET_REL


@pytest.fixture(scope="module", params=["rgb", "hybrid"])
def trx(request):
    """A seeded port TRXOS in ``request.param`` mode and the JAX module with
    the same weights (carried to Flax by the weight bridge)."""
    jcfg = dataclasses.replace(jc.ARConfig.for_input(request.param), rgb_size=RGB)
    tcfg = dataclasses.replace(tc.ARConfig.for_input(request.param), rgb_size=RGB)
    model = init_random(TRXOS(tcfg), torch.Generator().manual_seed(5)).eval()
    variables = jax.tree.map(lambda t: t.numpy(), weights.to_flax_variables(model.state_dict()))
    assert set(variables) == {"params", "batch_stats"}
    return JaxRecognizer(jcfg, params=variables), model, tcfg


def _clips(cfg, lead, seed):
    """Whitened random crops and normal skeletons, (*lead, L, ...)."""
    rng = np.random.default_rng(seed)
    data = {"rgb": (rng.integers(0, 256, lead + (cfg.seq_len, RGB, RGB, 3)) / 255.0 * 0.22
                    + 0.45).astype(np.float32)}
    if cfg.input_type == "hybrid":
        data["sk"] = rng.normal(size=lead + (cfg.seq_len, 90)).astype(np.float32)
    return data


def test_trx_embed_frame_matches_jax(trx):
    jar, model, cfg = trx
    frames = {k: v[0, :3] for k, v in _clips(cfg, (1,), seed=6).items()}
    want = np.asarray(jax.jit(jax.vmap(
        lambda f: jar.model.apply(jar.params, method="embed_frame", **f)))(frames))
    with torch.no_grad():
        got = model.embed_frame(**{k: torch.from_numpy(v) for k, v in frames.items()}).numpy()
    assert got.shape == want.shape == (3, cfg.trans_linear_in_dim)
    np.testing.assert_allclose(got, want, atol=TOL_FEATURES, rtol=0)
    if cfg.input_type == "hybrid":  # the rgb features come first
        with torch.no_grad():
            sk_only = model.sk_extractor(torch.from_numpy(frames["sk"])).numpy()
        np.testing.assert_array_equal(got[:, 256:], sk_only)


def test_trx_episode_forward_matches_jax(trx):
    jar, model, cfg = trx
    query, support = _clips(cfg, (1,), seed=7), _clips(cfg, (1, cfg.way), seed=8)
    mask = np.array([[True, True, False, True, False]])
    want = jax.jit(lambda q, s: jar.model.apply(jar.params, q, mask, support_data=s))(query, support)
    T = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.no_grad():
        got = model(T(query), torch.from_numpy(mask), support_data=T(support))
    np.testing.assert_allclose(got["support_features"].numpy(), want["support_features"],
                               atol=TOL_FEATURES, rtol=0)
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], atol=TOL_LOGITS, rtol=0)
    np.testing.assert_allclose(got["is_true"].numpy(), want["is_true"], atol=TOL_IS_TRUE, rtol=0)
    assert int(got["logits"].argmax()) == int(np.argmax(want["logits"]))


def test_recognizer_inference_matches_jax(trx, tmp_path):
    """Two classes learned from the same clips, then frames one by one:
    nothing until the window holds seq_len frames, then the same scores;
    and a support set saved by either package loads in the other."""
    jar, model, cfg = trx
    ours = ActionRecognizer(cfg, params=jax.tree.map(np.asarray, jar.params), device="cpu")
    jar = JaxRecognizer(jar.config, params=jar.params)  # a fresh support set
    keys = {"rgb": "imgs", "sk": "poses"}
    for i, seed in enumerate((9, 10)):
        clip = {keys[m]: v[0] for m, v in _clips(cfg, (1,), seed).items()}
        for r in (jar, ours):
            r.train({"flag": f"a{i}", "data": clip, "requires_focus": i == 1})
    frames = _clips(cfg, (1,), seed=11)
    stream = [{m: v[0, j % cfg.seq_len] for m, v in frames.items()} for j in range(cfg.seq_len + 1)]
    for j, frame in enumerate(stream):
        (got, got_true, got_focus), (want, want_true, want_focus) = (
            ours.inference(frame), jar.inference(frame))
        assert got.keys() == want.keys() and got_focus == want_focus
        if j < cfg.seq_len - 1:
            assert got == {} and got_true == 0
            continue
        assert set(got) == {"a0", "a1"}
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=TOL_PROBS)
        assert abs(got_true - want_true) < TOL_IS_TRUE
    with pytest.raises(ValueError, match="missing modalities"):
        ours.inference({"sk": np.zeros(90, np.float32)} if cfg.input_type == "rgb" else
                       {"rgb": np.zeros((RGB, RGB, 3), np.float32)})

    ours.save_support_set(str(tmp_path / "port"))
    jar.save_support_set(str(tmp_path / "jax"))
    for loader, src in ((JaxRecognizer(jar.config, params=jar.params), "port"),
                        (ActionRecognizer(cfg, params=jax.tree.map(np.asarray, jar.params),
                                          device="cpu"), "jax")):
        assert loader.load_support_set(str(tmp_path / src)) == 2
        assert loader.class_order[:2] == ["a0", "a1"] and loader.requires_focus["a1"]
        for m in loader.modalities:
            np.testing.assert_array_equal(loader.support_data[m], ours.support_data[m])
    assert ours.support_data["rgb"].shape == (cfg.way, cfg.seq_len, RGB, RGB, 3)
    other = "hybrid" if cfg.input_type == "rgb" else "rgb"
    with pytest.raises(ValueError, match="input_type"):
        ActionRecognizer(dataclasses.replace(tc.ARConfig.for_input(other), rgb_size=RGB),
                         device="cpu").load_support_set(str(tmp_path / "jax"))


# ------------------------------------------------------------------ crops

FRAME_HW = (120, 160)
# (x1, y1, x2, y2) boxes in the crop's order: off-centre and far from
# square (tall, wide), touching each edge, past the right and bottom edges
# (the detector clamps only at 0), a one-pixel box and a degenerate one
# (half side 0, raised to 1).
BOXES = [(100, 10, 130, 110), (5, 70, 150, 100), (0, 0, 40, 60), (120, 80, 160, 120),
         (140, 100, 190, 150), (150, 5, 159, 119), (30, 40, 31, 41), (60, 60, 60, 60)]


def test_center_square_crop_matches_jax():
    """The fused step's gather, batched over frames, against the JAX
    function on each frame: bit-equal, at the CI crop (64) and at 224;
    then the whitening."""
    rng = np.random.default_rng(12)
    frames = rng.uniform(0, 255, (len(BOXES),) + FRAME_HW + (3,)).astype(np.float32)
    boxes = np.array(BOXES, np.int32)
    for out in (64, 224):
        want = np.stack([np.asarray(jax_image.center_square_crop_resize(
            jnp.asarray(f), tuple(jnp.int32(v) for v in b), out)) for f, b in zip(frames, boxes)])
        got = center_square_crop_resize(torch.from_numpy(frames),
                                        tuple(torch.from_numpy(boxes[:, i]) for i in range(4)), out)
        assert got.shape == (len(BOXES), out, out, 3)
        np.testing.assert_array_equal(got.numpy(), want)
    # the box order matters: the transposed boxes take other pixels
    swapped = center_square_crop_resize(
        torch.from_numpy(frames), tuple(torch.from_numpy(boxes[:, i]) for i in (1, 0, 3, 2)), 224)
    assert not np.array_equal(swapped.numpy(), want)

    whitened = np.asarray(jax.jit(jax_image.ar_rgb_preprocess)(want))
    # XLA and torch round the scale-then-shift alike but for 6.0e-8 (one ulp)
    np.testing.assert_allclose(ar_rgb_preprocess(got).numpy(), whitened, atol=1e-6, rtol=0)


# Sizes of the module path's slice around 224: above, below, non-square,
# an exact 2x downscale (cv2 hands that to its area resize), thin strips
# and one pixel. Bit-equal with this repository's cv2 (5.0.0) on every
# size, and on 700 random sizes tried while writing it.
RESIZE_SIZES = [(300, 250), (448, 448), (224, 224), (100, 60), (37, 500), (500, 37),
                (150, 151), (223, 225), (112, 112), (128, 128), (2, 3), (1, 1)]


@pytest.mark.parametrize("out", [224, RGB])
@pytest.mark.parametrize("h,w", RESIZE_SIZES)
def test_resize_linear_u8_matches_cv2(h, w, out):
    img = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3), np.uint8)
    got, want = resize_linear_u8(img, out, out), cv2.resize(img, (out, out))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    sat = np.full((h, w, 3), 255, np.uint8)  # saturation at the top of the range
    np.testing.assert_array_equal(resize_linear_u8(sat, out, out), cv2.resize(sat, (out, out)))


def test_preprocess_ar_crop_matches_jax():
    """The module path's host crop (the JAX function calls cv2.resize) on a
    uint8 frame: the same slice, resize and whitening, bit for bit. At the
    frame's edges the slice is not square."""
    img = np.random.default_rng(13).integers(0, 256, FRAME_HW + (3,), np.uint8)
    for x1, y1, x2, y2 in BOXES:
        bbox = (x1, x2, y1, y2)  # the estimator's order
        for out in (RGB, 224):
            got, want = preprocess_ar_crop(img, bbox, out), jax_preprocess_ar_crop(img, bbox, out)
            assert got.dtype == np.float32 and got.shape == (out, out, 3)
            np.testing.assert_array_equal(got, want)
