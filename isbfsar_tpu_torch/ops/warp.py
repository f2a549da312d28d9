"""Projective crop warp (port of ``isbfsar_tpu/ops/warp.py::warp_image``).

For each output pixel (x, y), with H normalized so H[2, 2] == 1,

    k  = H20*x + H21*y + 1
    xi = trunc((H00*x + H01*y + H02) / k)
    yi = trunc((H10*x + H11*y + H12) / k)
    out[y, x] = img[yi, xi]  if in bounds else 0

Truncation toward zero, not floor, as the reference.
"""

from __future__ import annotations

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


def warp_image(img: torch.Tensor, transform: torch.Tensor, out_size: int = 256) -> torch.Tensor:
    """img (b, h, w, c) frames, transform (b, 3, 3) output->source homographies.

    Returns (b, out_size, out_size, c) in the input dtype, zeros out of bounds.
    """
    b, h, w, c = img.shape
    sx, sy = _source_coords(transform.to(torch.float32), out_size, out_size)
    xi = to_int32(sx)
    yi = to_int32(sy)
    in_bounds = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat_idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (b, s, s)
    flat = img.reshape(b, h * w, c)
    out = torch.gather(flat, 1, flat_idx.reshape(b, -1, 1).expand(-1, -1, c).long())
    out = out.reshape(b, out_size, out_size, c)
    return torch.where(in_bounds[..., None], out, torch.zeros((), dtype=img.dtype, device=img.device))
