"""Projective crop warps (port of ``isbfsar_tpu/ops/warp.py``).

``warp_image``, the pose crop: for each output pixel (x, y), with H
normalized so H[2, 2] == 1,

    k  = H20*x + H21*y + 1
    xi = trunc((H00*x + H01*y + H02) / k)
    yi = trunc((H10*x + H11*y + H12) / k)
    out[y, x] = img[yi, xi]  if in bounds else 0

Truncation toward zero, not floor, as the reference.

``warp_image_bilinear``, the focus crops: the same source coordinates,
sampled bilinearly with zeros outside the frame.
"""

from __future__ import annotations

from typing import Optional

import torch


def _source_coords(transform: torch.Tensor, out_h: int, out_w: int):
    t = transform / transform[:, 2:3, 2:3]
    x = torch.arange(out_w, dtype=torch.float32, device=t.device)[None, :]
    y = torch.arange(out_h, dtype=torch.float32, device=t.device)[:, None]
    t = t.reshape(-1, 9)[:, :, None, None]  # (b, 9, 1, 1)
    k = t[:, 6] * x + t[:, 7] * y + 1.0
    sx = (t[:, 0] * x + t[:, 1] * y + t[:, 2]) / k
    sy = (t[:, 3] * x + t[:, 4] * y + t[:, 5]) / k
    return sx, sy


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero, as XLA's ``astype(int32)``:
    XLA saturates and maps NaN to 0, where a plain torch cast of such
    values is undefined."""
    return torch.nan_to_num(v, nan=0.0).clamp(-1e9, 1e9).to(torch.int32)


def warp_image(img: torch.Tensor, transform: torch.Tensor, out_size: int = 256,
               frame_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """img (b, h, w, c) frames, transform (n, 3, 3) output->source homographies.

    ``frame_index`` (n,) int64 names the frame each crop reads (several
    crops of one frame read its pixels in place, with no copy of the
    frame); None: crop i reads frame i (n == b).
    Returns (n, out_size, out_size, c) in the input dtype, zeros out of bounds.
    """
    b, h, w, c = img.shape
    n = transform.shape[0]
    sx, sy = _source_coords(transform.to(torch.float32), out_size, out_size)
    xi = to_int32(sx)
    yi = to_int32(sy)
    in_bounds = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat_idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()  # (n, s, s)
    if frame_index is None:
        flat = img.reshape(b, h * w, c)
    else:
        flat = img.reshape(1, b * h * w, c)
        flat_idx = flat_idx + frame_index[:, None, None] * (h * w)
    out = torch.gather(flat, 1, flat_idx.reshape(flat.shape[0], -1, 1).expand(-1, -1, c))
    out = out.reshape(n, out_size, out_size, c)
    return torch.where(in_bounds[..., None], out, torch.zeros((), dtype=img.dtype, device=img.device))


def warp_image_bilinear(img: torch.Tensor, transform: torch.Tensor, out_size: int = 256,
                        packed: bool = True) -> torch.Tensor:
    """Bilinear projective warp, one transform per frame.

    img (b, h, w, c), transform (b, 3, 3) output->source homographies.
    Returns (b, out_size, out_size, c) float32; each corner outside the
    frame reads 0. ``packed=True`` (the default) gathers the four corners
    at once from a 1-px zero-padded copy whose channels hold each pixel's
    2x2 block, with a mask for sample points with no support
    (outside [-1, w] x [-1, h]); ``packed=False`` gathers each corner
    separately. The two give the same values.
    """
    b, h, w, c = img.shape
    sx, sy = _source_coords(transform.to(torch.float32), out_size, out_size)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i, y0i = to_int32(x0), to_int32(y0)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)

    def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """table (b, n, k), idx (b, s, s) -> (b, s, s, k)."""
        k = table.shape[-1]
        out = torch.gather(table, 1, idx.reshape(b, -1, 1).expand(-1, -1, k).long())
        return out.reshape(b, out_size, out_size, k)

    if not packed:
        flat = img.to(torch.float32).reshape(b, h * w, c)

        def fetch(xi, yi):
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            vals = gather(flat, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
            return torch.where(ok[..., None], vals, zero)

        v00, v01 = fetch(x0i, y0i), fetch(x0i + 1, y0i)
        v10, v11 = fetch(x0i, y0i + 1), fetch(x0i + 1, y0i + 1)
    else:
        padded = torch.nn.functional.pad(img.to(torch.float32), (0, 0, 1, 1, 1, 1))
        # pack[y, x] holds the 2x2 block whose top-left pixel is (y - 1, x - 1)
        pack = torch.cat([padded[:, :-1, :-1], padded[:, :-1, 1:],
                          padded[:, 1:, :-1], padded[:, 1:, 1:]], dim=-1)
        support = (sx >= -1.0) & (sx <= w) & (sy >= -1.0) & (sy <= h)
        px = (x0i + 1).clamp(0, w)
        py = (y0i + 1).clamp(0, h)
        corners = gather(pack.reshape(b, (h + 1) * (w + 1), 4 * c), py * (w + 1) + px)
        corners = torch.where(support[..., None], corners, zero)
        v00, v01, v10, v11 = corners.split(c, dim=-1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
