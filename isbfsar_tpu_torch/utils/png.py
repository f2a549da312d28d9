"""PNG input and output in numpy and the standard library's ``zlib``, in
place of cv2's (the machine with the card has no cv2).

- :func:`read_png` reads 8-bit, non-interlaced PNGs of colour types 0, 2
  and 6 (grey, RGB, RGBA) with any of the five row filters and returns BGR
  uint8 (H, W, 3), as ``cv2.imread(path)`` does with ``IMREAD_COLOR``:
  grey is repeated over the three channels and alpha is dropped. Palette,
  16-bit and interlaced files are refused with an error naming the file.
- :func:`write_png` writes BGR uint8 (H, W, 3) as an 8-bit RGB PNG, every
  row with the Up filter.

Rows with the None, Sub or Up filter are decoded a run of equal filters at
a time, each run a few numpy operations (an image this module writes is
one run of Up rows). Average and Paeth read the pixel to the left, which is being
decoded, so an image with such rows is decoded along anti-diagonals
instead: pixel (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), all on
earlier anti-diagonals, so each anti-diagonal is one vector step over every
row it crosses, whatever each row's filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3); ``path`` names the file in errors."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit samples; only 8-bit PNGs are read")
    if colour not in CHANNELS:
        what = "palette" if colour == 3 else f"colour type {colour}"
        raise ValueError(f"{path}: {what} PNG; only grey, RGB and RGBA are read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG; only non-interlaced PNGs are read")
    bpp = CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(raw) != height * (1 + width * bpp):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {width}x{height}x{bpp}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + width * bpp)
    filters = rows[:, 0]
    if filters.max(initial=0) > PAETH:
        raise ValueError(f"{path}: unknown row filter {int(filters.max())}")
    filtered = rows[:, 1:].reshape(height, width, bpp)
    if (filters >= AVERAGE).any():
        img = _unfilter_diagonals(filtered, filters)
    else:
        img = _unfilter_rows(filtered, filters)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def _unfilter_rows(filtered: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Rows filtered with None, Sub or Up, a run of rows with one filter at
    a time (uint8 sums wrap modulo 256): a run of Up rows adds up down the
    columns from the row above it, each Sub row along itself."""
    out = np.empty_like(filtered)
    starts = np.flatnonzero(np.diff(filters.astype(np.int16), prepend=-1))
    for y, end in zip(starts, [*starts[1:], len(filters)]):
        rows = filtered[y:end]
        if filters[y] == SUB:
            out[y:end] = np.cumsum(rows, axis=1, dtype=np.uint8)
        elif filters[y] == UP:
            out[y:end] = np.cumsum(rows, axis=0, dtype=np.uint8)
            if y:
                out[y:end] += out[y - 1]
        else:
            out[y:end] = rows
    return out


def _unfilter_diagonals(filtered: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Any filters, one anti-diagonal y + x = t at a time.

    The image is skewed so that pixel (y, x) sits at row y + 1, column
    y + x + 2 of ``rec``, behind a zero row and two zero columns (the PNG
    neighbours outside the image are 0): its left neighbour is then column
    t + 1 of row y + 1, its upper neighbour column t + 1 of row y and its
    upper-left neighbour column t of row y, so every step reads and writes
    slices."""
    h, w, bpp = filtered.shape
    ys, xs = np.mgrid[0:h, 0:w]
    skew = np.zeros((h, h + w, bpp), np.int16)
    skew[ys, ys + xs] = filtered
    rec = np.zeros((h + 1, h + w + 2, bpp), np.int16)
    kinds = filters.astype(np.int16)[:, None]
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h, t + 1)
        a = rec[lo + 1:hi + 1, t + 1]
        b = rec[lo:hi, t + 1]
        c = rec[lo:hi, t]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = kinds[lo:hi]
        pred = np.where(kind == SUB, a, np.where(kind == UP, b, np.where(
            kind == AVERAGE, (a + b) >> 1, np.where(kind == PAETH, paeth, 0))))
        rec[lo + 1:hi + 1, t + 2] = (skew[lo:hi, t] + pred) & 0xFF
    return rec[ys + 1, ys + xs + 2].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG file as BGR uint8 (H, W, 3); a missing file raises
    ``FileNotFoundError``, an unreadable one ``ValueError``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(bgr: np.ndarray) -> bytes:
    """BGR uint8 (H, W, 3) -> the bytes of an 8-bit RGB PNG."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"expected BGR uint8 (H, W, 3), got {bgr.dtype} {bgr.shape}")
    h, w = bgr.shape[:2]
    rgb = bgr[:, :, ::-1].reshape(h, w * 3)
    rows = np.empty((h, 1 + w * 3), np.uint8)
    rows[:, 0] = UP
    rows[0, 1:] = rgb[0]
    rows[1:, 1:] = rgb[1:] - rgb[:-1]  # uint8 differences wrap modulo 256
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, bgr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(bgr))
