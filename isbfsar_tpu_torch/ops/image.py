"""Frame preprocessing ops (port of ``isbfsar_tpu/ops/image.py``).

Plain PyTorch versions of the I420 decode and the YOLO input: they are the
reference the CUDA kernel in ``ops/fused_input.py`` is held against, and
what that wrapper runs for CPU tensors. The recognizer's RGB input: the
fused step's square crop (:func:`center_square_crop_resize`, a gather on
the device) and whitening (:func:`ar_rgb_preprocess`); and, for the
module path's host crop, :func:`resize_linear_u8`, a numpy twin of cv2's
``INTER_LINEAR`` resize of uint8 images (the card's machine has no cv2).
The synthetic trainers' host inputs, numpy twins of cv2 5.0.0 on uint8
images: :func:`resize_area_u8` (``INTER_AREA`` downscale) and
:func:`warp_affine_linear_u8` (``warpAffine`` at ``INTER_LINEAR``, border 0).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

IMAGENET_SCALE = (0.229, 0.224, 0.225)
IMAGENET_SHIFT = (0.485, 0.456, 0.406)


@functools.lru_cache(maxsize=None)
def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) exact INTER_AREA box-overlap weight matrix (downscale)."""
    scale = src / dst
    w = np.zeros((dst, src), np.float32)
    for i in range(dst):
        lo, hi = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, src)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap / scale
    return w


@functools.lru_cache(maxsize=None)
def _area_weights_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    """``_area_weights`` on ``device``, copied there once: a copy from the
    host memory waits for the card, and a CUDA graph cannot hold it."""
    return torch.from_numpy(_area_weights(src, dst)).to(device)


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Exact cv2.INTER_AREA downscale ``W_rows @ img @ W_colsᵀ`` in float32.

    img: (..., h, w, c) -> float32 (..., out_h, out_w, c). The contraction
    order (rows first) is the JAX function's.
    """
    h, w = img.shape[-3], img.shape[-2]
    wr = _area_weights_on(h, out_h, img.device)
    wc = _area_weights_on(w, out_w, img.device)
    chw = img.to(torch.float32).movedim(-1, -3)  # (..., c, h, w)
    x = torch.matmul(wr, chw)
    out = torch.matmul(x, wc.t())
    return out.movedim(-3, -1)


def yolo_preprocess(frame_bgr: torch.Tensor, size: int = 256) -> torch.Tensor:
    """(..., H, W, 3) BGR frame -> (..., 1, size, size, 3) RGB float32 in [0, 1]."""
    small = resize_area(frame_bgr, size, size)
    return (small.flip(-1) / 255.0).unsqueeze(-4)


@functools.lru_cache(maxsize=None)
def _whitening_on(device: torch.device):
    """(scale, shift) float32 on ``device``, copied there once (as
    ``_area_weights_on``: a CUDA graph cannot hold a host copy)."""
    return (torch.tensor(IMAGENET_SCALE, dtype=torch.float32).to(device),
            torch.tensor(IMAGENET_SHIFT, dtype=torch.float32).to(device))


def ar_rgb_preprocess(crop_bgr: torch.Tensor) -> torch.Tensor:
    """(..., S, S, 3) BGR crop -> float32 ``crop / 255 * scale + shift``.

    Scale-then-shift, not ``(x - mean) / std``: the reference whitens so,
    and its recognizer checkpoints were trained on it. BGR order, NHWC."""
    scale, shift = _whitening_on(crop_bgr.device)
    return crop_bgr.to(torch.float32) / 255.0 * scale + shift


def center_square_crop_resize(img: torch.Tensor, box, out: int = 224) -> torch.Tensor:
    """A square around each box's center, sampled at ``out`` x ``out``
    nearest points: (B, H, W, C) frames and int32 boxes (x1, y1, x2, y2),
    each (B,) -> (B, out, out, C).

    The JAX function's integer arithmetic, in int32 tensors on the device
    (no host value, so a CUDA graph holds it): center ``(x1 + x2) // 2``,
    half side ``max(xm - x1, ym - y1, 1)``, the square's origin clipped at
    0, sample ``i`` at ``origin + i * side // out``, indices clipped to the
    frame."""
    h, w = img.shape[-3], img.shape[-2]
    x1, y1, x2, y2 = box
    xm = torch.div(x1 + x2, 2, rounding_mode="floor")
    ym = torch.div(y1 + y2, 2, rounding_mode="floor")
    half = torch.clamp(torch.maximum(xm - x1, ym - y1), min=1)
    y_lo = torch.clamp(ym - half, min=0)
    x_lo = torch.clamp(xm - half, min=0)
    steps = torch.arange(out, dtype=torch.int32, device=img.device)[None] * (2 * half)[:, None]
    steps = torch.div(steps, out, rounding_mode="floor")
    ys = torch.clamp(y_lo[:, None] + steps, 0, h - 1).long()
    xs = torch.clamp(x_lo[:, None] + steps, 0, w - 1).long()
    rows = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[rows, ys[:, :, None], xs[:, None, :]]


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR source index and float32 fraction for each of
    ``dst`` samples of ``src``: ``(i + 0.5) * scale - 0.5`` with cv2's
    ``scale = 1 / (dst / src)`` in float64, rounded to float32."""
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    return lo, (pos - lo.astype(np.float32)).astype(np.float32)


def _coef(frac: np.ndarray) -> tuple:
    """11-bit fixed-point weights ``(1 - f, f) * 2048``, each rounded to
    nearest even on its own, as cv2's ``saturate_cast<short>`` does."""
    one = np.float32(1.0)
    return (np.rint((one - frac) * np.float32(2048)).astype(np.int32),
            np.rint(frac * np.float32(2048)).astype(np.int32))


def resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h)) with ``INTER_LINEAR`` on (h, w, c)
    uint8, in numpy: cv2's fixed-point arithmetic step by step.

    Along each row first: source columns clamped at the edges (fraction 0
    there), exact integer sums ``S0 * a0 + S1 * a1`` with 11-bit weights;
    from the first column whose right neighbour lies outside, ``S * 2048``.
    Then down each column: the source rows are clipped but the weights are
    not clamped (at the top and bottom of an upscale both taps read the
    edge row, and their separately rounded weights need not sum to 2048),
    and each pair is combined as cv2's vector loop does:
    ``(((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2``,
    saturated to uint8. An exact 2x downscale, which cv2 hands to its area
    resize, gives the same pixels by this formula."""
    h, w = img.shape[:2]
    sx, fx = _linear_taps(w, out_w)
    edge = (sx < 0) | (sx >= w - 1)
    fx = np.where(edge, np.float32(0.0), fx)
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _coef(fx)
    src = img.astype(np.int32)
    rows = src[:, sx] * a0[:, None] + src[:, np.minimum(sx + 1, w - 1)] * a1[:, None]
    past = np.flatnonzero(sx + 1 >= w)
    if past.size:
        rows[:, past[0]:] = src[:, sx[past[0]:]] * 2048
    sy, fy = _linear_taps(h, out_h)
    b0, b1 = _coef(fy)
    s0 = rows[np.clip(sy, 0, h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    y = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    return np.clip((y + 2) >> 2, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _area_taps(src: int, dst: int):
    """cv2's ``computeResizeAreaTab`` for a downscale of ``src`` to ``dst``,
    as (k, dst) source indices and float32 weights: each output sample's
    taps in cv2's order, padded with weight 0 (which adds an exact 0)."""
    scale = 1.0 / (dst / src)
    taps = []
    for d in range(dst):
        lo = d * scale
        hi = lo + scale
        cell = min(scale, src - lo)
        s1, s2 = math.ceil(lo), math.floor(hi)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        t = []
        if s1 - lo > 1e-3:
            t.append((s1 - 1, (s1 - lo) / cell))
        t += [(s, 1.0 / cell) for s in range(s1, s2)]
        if hi - s2 > 1e-3:
            t.append((s2, min(min(hi - s2, 1.0), cell) / cell))
        taps.append(t)
    idx = np.zeros((max(map(len, taps)), dst), np.int64)
    wgt = np.zeros(idx.shape, np.float32)
    for d, t in enumerate(taps):
        for k, (s, a) in enumerate(t):
            idx[k, d], wgt[k, d] = s, a
    return idx, wgt


def resize_area_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), interpolation=INTER_AREA) on (h, w, c)
    uint8 for a downscale by a factor that is not a whole number: cv2's
    float32 sums, along each row first (``buf += S * alpha`` in tap order),
    then down the columns (``sum += beta * buf``), each product and sum
    rounded to float32, and the result rounded half to even and saturated.
    (A whole factor takes cv2's other, integer path, which this does not
    follow.)"""
    h, w = img.shape[:2]
    xi, xw = _area_taps(w, out_w)
    yi, yw = _area_taps(h, out_h)
    src = img.astype(np.float32)
    rows = src[:, xi[0]] * xw[0][:, None]
    for k in range(1, len(xi)):
        rows = rows + src[:, xi[k]] * xw[k][:, None]
    out = rows[yi[0]] * yw[0][:, None, None]
    for k in range(1, len(yi)):
        out = out + rows[yi[k]] * yw[k][:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine_linear_u8(img: np.ndarray, m: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.warpAffine(img, m, (out_w, out_h), flags=INTER_LINEAR) on (h, w, c)
    uint8 with a constant border of 0, as cv2 5.0.0 computes it (in float32,
    not in the fixed point of older releases): the 2x3 ``m`` is inverted in
    double and rounded to float32; the source point of output pixel (x, y)
    is ``fma(M0, x, y * M1 + M2)`` (and likewise for y); each of the four
    neighbours outside the frame reads 0; the blend is
    ``fma(a, p01 - p00, p00)`` along x, then the same along y, rounded half
    to even and saturated."""
    fwd = np.asarray(m, np.float64).reshape(6)
    det = fwd[0] * fwd[4] - fwd[1] * fwd[3]
    det = 1.0 / det if det != 0 else 0.0
    inv = np.empty(6)
    inv[0], inv[4] = fwd[4] * det, fwd[0] * det
    inv[1], inv[3] = fwd[1] * -det, fwd[3] * -det
    inv[2] = -inv[0] * fwd[2] - inv[1] * fwd[5]
    inv[5] = -inv[3] * fwd[2] - inv[4] * fwd[5]
    inv = inv.astype(np.float32)
    xs = np.arange(out_w, dtype=np.float32)[None, :]
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    shape = (out_h, out_w)
    sx = _fma32(np.broadcast_to(xs, shape), inv[0], np.broadcast_to(ys * inv[1] + inv[2], shape))
    sy = _fma32(np.broadcast_to(xs, shape), inv[3], np.broadcast_to(ys * inv[4] + inv[5], shape))
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = img.shape[:2]
    src = img.astype(np.float32)

    def pixel(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01 = pixel(y0, x0), pixel(y0, x0 + 1)
    p10, p11 = pixel(y0 + 1, x0), pixel(y0 + 1, x0 + 1)
    ax, ay = np.broadcast_to(ax, p00.shape), np.broadcast_to(ay, p00.shape)
    top = _fma32(ax, p01 - p00, p00)
    bot = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, bot - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def i420_to_bgr(yuv: torch.Tensor, height: int) -> torch.Tensor:
    """Planar I420 (..., height*3/2, width) uint8 -> BGR float32 (..., height, width, 3).

    Studio-range BT.601 (Y in [16, 235], scale 1.164), nearest 2x chroma
    upsample, clipped to [0, 255].
    """
    width = yuv.shape[-1]
    lead = yuv.shape[:-2]
    y = (yuv[..., :height, :].to(torch.float32) - 16.0) * 1.164
    q = height // 4
    u_plane = yuv[..., height:height + q, :].reshape(*lead, height // 2, width // 2)
    v_plane = yuv[..., height + q:, :].reshape(*lead, height // 2, width // 2)

    def up2(p):  # nearest 2x upsample
        return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1).to(torch.float32)

    u = up2(u_plane) - 128.0
    v = up2(v_plane) - 128.0
    r = y + 1.596 * v
    g = y - 0.391 * u - 0.813 * v
    b = y + 2.018 * u
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0.0, 255.0)


# cv2's fixed-point BT.601 studio-range encoder (COLOR_BGR2YUV_I420):
# coefficients scaled by 2**20; chroma from the top-left pixel of each 2x2.
_SHIFT = 20
_CY = (269484, 528482, 102760)  # r, g, b -> Y
_CU = (-155188, -305135, 460324)  # r, g, b -> U
_CV = (460324, -385875, -74448)  # r, g, b -> V


def bgr_to_i420(bgr: np.ndarray) -> np.ndarray:
    """Host-side (H, W, 3) uint8 BGR -> (H*3/2, W) uint8 planar I420, numpy only.

    In int32, in place: every sum stays under 2**28, and ``>>`` on a signed
    integer floors as cv2's fixed point does (the serve loop encodes every
    frame, so this is on its per-frame host path)."""
    h, w, _ = bgr.shape
    half = 1 << (_SHIFT - 1)

    def mix(coef, px, offset):
        v = px[..., 2] * np.int32(coef[0])
        v += px[..., 1] * np.int32(coef[1])
        v += px[..., 0] * np.int32(coef[2])
        v += np.int32((offset << _SHIFT) + half)
        v >>= _SHIFT
        return np.clip(v, 0, 255).astype(np.uint8)

    px = bgr.astype(np.int32)
    y = mix(_CY, px, 16)
    top_left = px[::2, ::2]
    u = mix(_CU, top_left, 128).reshape(h // 4, w)
    v = mix(_CV, top_left, 128).reshape(h // 4, w)
    return np.concatenate([y, u, v], axis=0)
