"""A numpy rasterizer for the OpenCV primitives the synthetic renderers
draw, pixel for pixel as ``cv2`` 5.0.0 draws them with its defaults
(``LINE_8``, shift 0), so that rendering needs no cv2:

- :func:`rectangle`, filled (``cv2.rectangle(img, p1, p2, color, -1)``);
- :func:`circle`, filled (``cv2.circle(img, center, radius, color, -1)``);
- :func:`line` at any thickness (``cv2.line(img, p1, p2, color, thickness)``);
- :func:`fill_convex_poly` (``cv2.fillConvexPoly(img, pts, color)``);
- :func:`ellipse`, filled and whole (``cv2.ellipse(img, center, axes, 0, 0,
  360, color, -1)``).

Each follows OpenCV's own integer algorithm: a thick line is a quad in
16-bit fixed point, filled scanline by scanline after its outline is
drawn, with round caps drawn as filled circles; a polygon's outline is an
8-connected Bresenham line clipped to the frame; a filled circle is the
midpoint walk; a filled ellipse is the polygon of ``ellipse2Poly`` (cv2's
float table of sines at whole degrees, a point every ``delta`` degrees)
rounded to 16-bit fixed point and filled as a convex polygon. The polygon fill does what OpenCV's does on a quad that is
not convex (a turning torso): it follows one left and one right chain from
the top vertex. Colors are per-channel tuples (or a scalar); ``img`` is
written in place.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1
# cv2's SinTable: float32 sines of 0..450 whole degrees, each written with
# seven decimals
_SIN_TABLE = np.asarray([round(math.sin(math.radians(k)), 7) for k in range(451)], np.float32)


def _tdiv(a: int, b: int) -> int:
    """C integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img: np.ndarray, color):
    """The color as a value to assign to a run of pixels of ``img``."""
    if np.ndim(color) == 0 or img.ndim == 2:
        return np.asarray(color).ravel()[0] if np.ndim(color) else color
    return np.asarray(color[:img.shape[2]], img.dtype)


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to [0, width) x [0, height): returns (inside,
    x1, y1, x2, y2), the ends moved onto the border by double-precision
    interpolation truncated toward zero."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2

    def code(x, y, vertical=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8 if vertical else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_int(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's ``Line``: an 8-connected Bresenham line between integer
    points, clipped to the frame, walked left to right."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    n = dx + 1
    # the minor axis steps where the running error is negative
    err = dx - 2 * dy
    minor = np.zeros(n, np.int64)
    for i in range(1, n):
        if err < 0:
            minor[i] = 1
            err += 2 * dx - 2 * dy
        else:
            err -= 2 * dy
    major = np.arange(n)
    minor = np.cumsum(minor)
    xs, ys = (x1 + minor, y1 + sy * major) if vert else (x1 + major, y1 + sy * minor)
    img[ys, xs] = color


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's ``Line2``: the outline of a thick line's quad, between
    points in XY_SHIFT fixed point, clipped to the frame scaled alike."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += HALF
    y1 += HALF
    _put(img, (x2 + HALF) >> XY_SHIFT, (y2 + HALF) >> XY_SHIFT, color)
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _fill_poly(img: np.ndarray, pts: Sequence[Tuple[int, int]], color, shift: int) -> None:
    """OpenCV's ``FillConvexPoly`` at LINE_8: the outline, then one span a
    row between a left and a right edge chain walked from the top vertex."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in pts]
    n = len(v)
    delta = 1 << shift >> 1
    up = XY_SHIFT - shift
    xs_all = [p[0] for p in v]
    ys_all = [p[1] for p in v]
    imin = min(range(n), key=lambda i: (ys_all[i], i))
    px, py = v[-1][0] << up, v[-1][1] << up
    for x, y in v:
        qx, qy = x << up, y << up
        if shift == 0:
            _line_int(img, px >> XY_SHIFT, py >> XY_SHIFT, qx >> XY_SHIFT, qy >> XY_SHIFT, color)
        else:
            _line_fixed(img, px, py, qx, qy, color)
        px, py = qx, qy
    xmin = (min(xs_all) + delta) >> shift
    xmax = (max(xs_all) + delta) >> shift
    ymin = (ys_all[imin] + delta) >> shift
    ymax = (max(ys_all) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [index, direction, x, dx, y end]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + HALF) >> XY_SHIFT
            xx2 = (edge[right][2] + HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def fill_convex_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillConvexPoly(img, pts, color)`` (LINE_8, shift 0)."""
    _fill_poly(img, [tuple(p) for p in np.asarray(pts).reshape(-1, 2)], _color(img, color), 0)


def rectangle(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.rectangle(img, p1, p2, color, -1)``: filled."""
    (x1, y1), (x2, y2) = p1, p2
    _fill_poly(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], _color(img, color), 0)


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    h, w = img.shape[:2]
    dx, dy, err, plus, minus = radius, 0, 0, 1, 2 * radius - 1
    while dx >= dy:
        for half, rows in ((dx, (cy - dy, cy + dy)), (dy, (cy - dx, cy + dx))):
            x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
            for y in rows:
                if 0 <= y < h and x0 <= x1:
                    img[y, x0:x1 + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (filled, LINE_8, shift
    0): cv2's midpoint walk from (radius, 0), which fills the horizontal
    spans cx ± dx at rows cy ± dy and cx ± dy at rows cy ± dx, each clipped
    to the image."""
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    _circle(img, int(center[0]), int(center[1]), int(radius), _color(img, color))


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """``cv2.line(img, p1, p2, color, thickness)`` at LINE_8, shift 0."""
    if not 0 < thickness <= 32767:
        raise ValueError(f"thickness {thickness} outside (0, 32767]")
    color = _color(img, color)
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if thickness == 1:
        _line_int(img, x1, y1, x2, y2, color)
        return
    # a thick line is first clipped, in whole pixels, to the frame grown by
    # the thickness on every side; a segment wholly outside draws nothing
    h, w = img.shape[:2]
    m = thickness
    inside, x1, y1, x2, y2 = clip_line(w + 2 * m, h + 2 * m, x1 + m, y1 + m, x2 + m, y2 + m)
    if not inside:
        return
    x1, y1, x2, y2 = x1 - m, y1 - m, x2 - m, y2 - m
    x1, y1, x2, y2 = (v << XY_SHIFT for v in (x1, y1, x2, y2))
    dx = (x1 - x2) / XY_ONE
    dy = (y2 - y1) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half_t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_t + odd * XY_ONE * 0.5) / np.sqrt(r)
        px, py = round(dy * r), round(dx * r)  # half to even, as cvRound
        _fill_poly(img, [(x1 + px, y1 + py), (x1 - px, y1 - py), (x2 - px, y2 - py),
                         (x2 + px, y2 + py)], color, XY_SHIFT)
    cap = (half_t + HALF) >> XY_SHIFT
    for x, y in ((x1, y1), (x2, y2)):
        _circle(img, (x + HALF) >> XY_SHIFT, (y + HALF) >> XY_SHIFT, cap, color)


def ellipse(img: np.ndarray, center, axes, color) -> None:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, color, -1)``: a whole,
    filled, unrotated ellipse (LINE_8, shift 0). cv2's ``EllipseEx``: the
    center and axes in XY_SHIFT fixed point, ``ellipse2Poly`` in double
    from the float sine table with a step of 90, 30, 18 or 5 degrees by the
    larger axis, each point rounded half to even, repeats dropped, then
    the convex fill."""
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    aw, ah = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    step = (max(aw, ah) + HALF) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    pts = []
    for i in range(0, 360 + step, step):
        a = min(i, 360)
        # the rotation by angle 0 is cos 1, sin 0: x - y * 0 and x * 0 + y
        x = float(aw) * float(_SIN_TABLE[450 - a])
        y = float(ah) * float(_SIN_TABLE[a])
        px, py = cx + x - y * 0.0, cy + x * 0.0 + y
        qx = round(px / XY_ONE) << XY_SHIFT
        qy = round(py / XY_ONE) << XY_SHIFT
        pt = (qx + round(px - qx), qy + round(py - qy))
        if not pts or pts[-1] != pt:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(cx, cy), (cx, cy)]
    _fill_poly(img, pts, _color(img, color), XY_SHIFT)
