"""The full YOLO postprocessing and the offline One-Euro filter of the
PyTorch port against the JAX package, exactly: ``ops/nms.py``
(``iou_matrix``, ``top_candidates``, ``nms_fixed``, ``postprocess_yolo``,
batched over frames where JAX runs one) on random detections and on tied
scores, where ``jax.lax.top_k`` takes the lower index first; and
``ops/smooth.py::one_euro``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isbfsar_tpu.ops import nms as jn
from isbfsar_tpu.ops import smooth as js
from isbfsar_tpu_torch.ops import nms as tn
from isbfsar_tpu_torch.ops import smooth as ts

T = torch.from_numpy


def _detections(rng, b, n, ties: bool):
    """YOLO-shaped outputs: (b, n, 1, 4) boxes and (b, n, 80) scores with
    the person class boosted; with ``ties`` scores on a coarse grid and
    every 7th box a copy of the first."""
    xy = rng.uniform(0, 0.8, (b, n, 2))
    wh = rng.uniform(0.05, 0.3, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)[:, :, None]
    conf = rng.uniform(0, 1, (b, n, 80)).astype(np.float32)
    conf[:, :, 0] *= 3
    if ties:
        conf = (np.round(conf * 4) / 4).astype(np.float32)
        boxes[:, ::7] = boxes[:, :1]
    return boxes, conf


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("conf_thresh, nms_thresh, max_det", [(0.3, 0.7, 64), (0.3, 0.5, 64),
                                                                (0.9, 0.3, 16)])
def test_postprocess_yolo_matches_jax(ties, conf_thresh, nms_thresh, max_det):
    rng = np.random.default_rng(int(ties) * 10 + max_det)
    boxes, conf = _detections(rng, 3, 300, ties)
    dets, keep = tn.postprocess_yolo(T(boxes), T(conf), conf_thresh, nms_thresh, max_det)
    fn = jax.jit(jn.postprocess_yolo, static_argnums=(2, 3, 4))
    for b in range(3):
        jd, jk = fn(jnp.asarray(boxes[b]), jnp.asarray(conf[b]), conf_thresh, nms_thresh, max_det)
        np.testing.assert_array_equal(dets[b].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jk))
    assert keep.any() and not keep.all()


def test_top_candidates_breaks_ties_by_the_lower_index():
    scores = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 1]], bool)
    boxes = np.arange(24, dtype=np.float32).reshape(1, 6, 4)
    got = tn.top_candidates(T(boxes), T(scores), T(mask), 5)
    want = jn.top_candidates(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                             jnp.asarray(mask[0]), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][0, :, 0].numpy(), [4, 12, 0, 8, 20])


def test_nms_fixed_and_iou_matrix_match_jax():
    rng = np.random.default_rng(3)
    boxes, conf = _detections(rng, 2, 40, ties=False)
    boxes = boxes[:, :, 0]
    scores = np.sort(conf[:, :, 0], axis=1)[:, ::-1].copy()
    valid = rng.random((2, 40)) < 0.8
    np.testing.assert_array_equal(tn.iou_matrix(T(boxes)).numpy()[1],
                                  np.asarray(jn.iou_matrix(jnp.asarray(boxes[1]))))
    keep = tn.nms_fixed(T(boxes), T(scores), T(valid), 0.4)
    for b in range(2):
        ref = jn.nms_fixed(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(valid[b]),
                           0.4)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(40, 30, 3), (1, 122, 3), (17, 5)])
def test_one_euro_equals_jax(shape):
    xs = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    out = ts.one_euro(xs)
    ref = js.one_euro(xs)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0], xs[0])
    np.testing.assert_array_equal(ts.one_euro(xs, min_cutoff=0.2, beta=0.5, fs=30.0),
                                  js.one_euro(xs, min_cutoff=0.2, beta=0.5, fs=30.0))
