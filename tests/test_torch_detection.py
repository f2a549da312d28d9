"""The head detector's nets (``isbfsar_tpu_torch/models/detection.py``) and
the detection loss (``train/detection.py``) against the JAX package's on
the CPU, from JAX's init carried over by ``weights.convert_variables``.

Tolerances (float32, read on an x86 CPU): boxes 1.2e-7 and 2.8e-7 and
scores 8.3e-7 and 1.1e-6 at input 64 and 100, held at 2e-6 and 1e-5; the
FPN's maps 1.4e-6 of their largest value, held at 1e-5; the argmax anchor
equal. The loss within 1e-6 and its gradients within 1e-7 (float32
roundings). Input 100 makes levels of 13, 7 and 4: JAX's
nearest upsample takes half-pixel centres there, which
``F.interpolate(mode="nearest")`` does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from isbfsar_tpu.models import detection as jd
from isbfsar_tpu.train import detection as jtd
from isbfsar_tpu_torch.models import detection as td
from isbfsar_tpu_torch.models.layers import BN_MOMENTUM, FLAX_BN_MOMENTUM
from isbfsar_tpu_torch.train import detection as ttd
from isbfsar_tpu_torch.weights import convert_variables
from tests import torch_focus_alt_parity as A

torch.set_num_threads(2)

TOL_BOX, TOL_SCORE, TOL_FPN, TOL_LOSS = 2e-6, 1e-5, 1e-5, 1e-6


@pytest.fixture(scope="module", params=[64, 100])
def detector_case(request):
    size = request.param
    jnet = jd.HeadDetectorNet(dtype=jnp.float32)
    variables = A.perturbed(jax.jit(lambda k: jnet.init(k, jnp.zeros((1, size, size, 3))))(
        jax.random.key(0)), 1)
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    jb, js = jax.jit(jnet.apply)(variables, x)
    tnet = td.HeadDetectorNet(torch.float32)
    tnet.load_state_dict(convert_variables(variables), strict=True)
    with torch.no_grad():
        tb, ts = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    return size, (np.asarray(jb), np.asarray(js)), (tb.numpy(), ts.numpy())


def test_head_detector_net_matches_jax(detector_case):
    size, (jb, js), (tb, ts) = detector_case
    levels = [-(-size // s) for s in (8, 16, 32)] if size == 64 else [13, 7, 4]
    assert tb.shape == jb.shape == (2, 3 * sum(n * n for n in levels), 4)
    assert np.abs(tb - jb).max() <= TOL_BOX
    assert np.abs(ts - js).max() <= TOL_SCORE


def test_head_detector_anchor_order_matches_jax(detector_case):
    """The (h, w, anchor) flattening: the best anchor and its box are JAX's."""
    _, (jb, js), (tb, ts) = detector_case
    assert np.array_equal(ts.argmax(1), js.argmax(1))
    best = js.argmax(1)
    assert np.abs(tb[np.arange(2), best] - jb[np.arange(2), best]).max() <= TOL_BOX


def test_fpn_matches_jax_at_odd_sizes():
    rng = np.random.default_rng(3)
    feats = [rng.normal(0, 1, (2, n, n, c)).astype(np.float32)
             for n, c in ((13, 128), (7, 256), (4, 512))]
    jfpn = jd.FPN(128, dtype=jnp.float32)
    variables = jfpn.init(jax.random.key(1), feats)
    want = jfpn.apply(variables, feats)
    tfpn = td.FPN((128, 256, 512), 128)
    tfpn.load_state_dict(convert_variables(variables), strict=True)
    with torch.no_grad():
        got = tfpn([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(g.permute(0, 2, 3, 1).numpy() - w).max() <= TOL_FPN * np.abs(w).max()


@pytest.mark.parametrize("n_in,n_out", [(7, 13), (4, 7), (2, 4), (32, 64)])
def test_nearest_indices_take_half_pixel_centres(n_in, n_out):
    x = np.arange(n_in, dtype=np.float32)[None, :, None, None]
    want = np.asarray(jax.image.resize(x, (1, n_out, 1, 1), "nearest"))[0, :, 0, 0]
    got = td.nearest_indices(n_in, n_out, "cpu").numpy()
    assert np.array_equal(got, want.astype(np.int64))
    legacy = F.interpolate(torch.from_numpy(x).permute(0, 2, 1, 3), size=(n_out, 1),
                           mode="nearest")[0, 0, :, 0].numpy()
    # plain nearest agrees only at integer ratios
    assert np.array_equal(legacy, want) == (n_out % n_in == 0)


def test_dense_heads_match_jax():
    rng = np.random.default_rng(4)
    for jmod, tmod, x in ((jd.BinaryGazeClassifier(), td.BinaryGazeClassifier(512),
                           rng.normal(0, 1, (3, 512))),
                          (jd.EyeKeypointMLP(), td.EyeKeypointMLP(28),
                           rng.uniform(0, 1, (3, 14, 2)))):
        x = x.astype(np.float32)
        variables = jmod.init(jax.random.key(2), x)
        tmod.load_state_dict(convert_variables(variables), strict=True)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x)).numpy()
        assert got.shape == (3, 1)
        assert np.abs(got - np.asarray(jmod.apply(variables, x))).max() <= 1e-6


def test_trunk_momentum_is_flax_default():
    """The trunk's BatchNorms move by 0.99 (JAX passes no momentum), the
    other ResNets by 0.9."""
    from isbfsar_tpu_torch.models.layers import BatchNorm
    from isbfsar_tpu_torch.models.resnet import resnet18

    trunk = {m.momentum for m in td.HeadDetectorNet().modules() if isinstance(m, BatchNorm)}
    other = {m.momentum for m in resnet18().modules() if isinstance(m, BatchNorm)}
    assert trunk == {FLAX_BN_MOMENTUM} == {0.99} and other == {BN_MOMENTUM} == {0.9}


def test_pairwise_iou_matches_jax():
    a = np.asarray([[0.0, 0.0, 1.0, 1.0]], np.float32)
    b = np.asarray([[0.0, 0.0, 0.5, 1.0], [2.0, 2.0, 3.0, 3.0]], np.float32)
    got = ttd.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got[0], [0.5, 0.0], atol=1e-6)
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 0.7, (2, 30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.01, 0.3, (2, 30, 2))], -1).astype(np.float32)
    want = np.asarray(jtd.pairwise_iou(boxes[0], boxes[1]))
    got = ttd.pairwise_iou(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1])).numpy()
    assert np.abs(got - want).max() <= 1e-7


def _loss_case(seed: int, n: int = 40, m: int = 5):
    """4 images of n predictions and m ground-truth slots: image 0 all
    valid; image 1 two padding slots; image 2 one valid box off every
    prediction (all IoUs 0: the argmax ties at prediction 0) and the rest
    padding; image 3 duplicated best predictions (a tie to the lower
    index) and a ground truth given twice."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.7, (4, n, 2))
    pred = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (4, n, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (4, n)).astype(np.float32)
    gt = pred[np.arange(4)[:, None], rng.integers(0, n, (4, m))] + rng.normal(
        0, 0.01, (4, m, 4)).astype(np.float32)
    valid = np.ones((4, m), bool)
    valid[1, 3:] = False
    gt[1, 3:] = 0.0
    gt[2, 0] = [2.0, 2.0, 2.5, 2.5]
    valid[2, 1:] = False
    pred[3, 9] = pred[3, 4] = gt[3, 0]
    gt[3, 1] = gt[3, 0]
    return pred, scores, gt.astype(np.float32), valid


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_matches_jax(seed):
    case = _loss_case(seed)
    want_total, want_aux = jax.vmap(jtd.detection_loss)(*case)
    total, aux = ttd.detection_loss(*(torch.from_numpy(a) for a in case))
    assert np.abs(total.numpy() - np.asarray(want_total)).max() <= TOL_LOSS
    for k, v in aux.items():
        assert np.abs(v.numpy() - np.asarray(want_aux[k])).max() <= TOL_LOSS, k


def test_detection_loss_positives_and_ties():
    """Padding ground truths mark nothing; ties go to the lower index."""
    pred, scores, gt, valid = _loss_case(0)
    iou = ttd.pairwise_iou(torch.from_numpy(pred), torch.from_numpy(gt))
    iou = torch.where(torch.from_numpy(valid)[:, None, :], iou, -1.0)
    best = torch.argmax(iou, dim=1)
    assert best[3, 0] == 4 and best[2, 0] == 0  # the lower of the tied, and all-zero IoUs
    # the positives, through the loss's own gradient on the scores
    s = torch.from_numpy(scores).requires_grad_()
    ttd.detection_loss(torch.from_numpy(pred), s, torch.from_numpy(gt),
                       torch.from_numpy(valid))[0].sum().backward()
    jg = jax.grad(lambda sc: jnp.sum(jax.vmap(jtd.detection_loss)(pred, sc, gt, valid)[0]))(scores)
    assert np.abs(s.grad.numpy() - np.asarray(jg)).max() <= 1e-6
    assert s.grad[3, 4] < 0 and s.grad[3, 9] >= 0  # prediction 4 positive, its twin not


def test_detection_loss_gradient_matches_jax():
    pred, scores, gt, valid = _loss_case(2)
    jg = jax.grad(lambda b, s: jnp.mean(jax.vmap(jtd.detection_loss)(b, s, gt, valid)[0]),
                  argnums=(0, 1))(pred, scores)
    ts = [torch.from_numpy(a).requires_grad_() for a in (pred, scores)]
    ttd.detection_loss(*ts, torch.from_numpy(gt), torch.from_numpy(valid))[0].mean().backward()
    for t, want in zip(ts, jg):
        assert np.abs(t.grad.numpy() - np.asarray(want)).max() <= 1e-7
