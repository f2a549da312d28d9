"""Frame preprocessing ops (port of ``isbfsar_tpu/ops/image.py``).

Plain PyTorch versions of the I420 decode and the YOLO input: they are the
reference the CUDA kernel in ``ops/fused_input.py`` is held against, and
what that wrapper runs for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Exact cv2.INTER_AREA downscale ``W_rows @ img @ W_colsᵀ`` in float32.

    img: (..., h, w, c) -> float32 (..., out_h, out_w, c). The contraction
    order (rows first) is the JAX function's.
    """
    h, w = img.shape[-3], img.shape[-2]
    wr = torch.from_numpy(_area_weights(h, out_h)).to(img.device)
    wc = torch.from_numpy(_area_weights(w, out_w)).to(img.device)
    chw = img.to(torch.float32).movedim(-1, -3)  # (..., c, h, w)
    x = torch.matmul(wr, chw)
    out = torch.matmul(x, wc.t())
    return out.movedim(-3, -1)


def yolo_preprocess(frame_bgr: torch.Tensor, size: int = 256) -> torch.Tensor:
    """(..., H, W, 3) BGR frame -> (..., 1, size, size, 3) RGB float32 in [0, 1]."""
    small = resize_area(frame_bgr, size, size)
    return (small.flip(-1) / 255.0).unsqueeze(-4)


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
    """Host-side (H, W, 3) uint8 BGR -> (H*3/2, W) uint8 planar I420, numpy only."""
    h, w, _ = bgr.shape
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    half = 1 << (_SHIFT - 1)

    def mix(coef, rr, gg, bb, offset):
        v = (coef[0] * rr + coef[1] * gg + coef[2] * bb + (offset << _SHIFT) + half) >> _SHIFT
        return np.clip(v, 0, 255).astype(np.uint8)

    y = mix(_CY, r, g, b, 16)
    rs, gs, bs = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = mix(_CU, rs, gs, bs, 128).reshape(h // 4, w)
    v = mix(_CV, rs, gs, bs, 128).reshape(h // 4, w)
    return np.concatenate([y, u, v], axis=0)
