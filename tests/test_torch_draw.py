"""``utils/draw.py``, the port's numpy rasterizer, against cv2 5.0.0
pixel for pixel over seeded sweeps: filled rectangles, filled circles
(radii 0-100), lines at thickness 1 and 2-60 and convex-polygon fills
(random quads, so many are not convex), with end points off the frame,
degenerate lines and shapes larger than the frame. cv2 is imported
inside the tests: the port never imports it."""

import numpy as np
import pytest

from isbfsar_tpu_torch.utils import draw

SIZES = [(120, 160), (480, 640)]
N_CASES = 400


def _sweep(kind: str, hw, seed: int):
    """Seeded (args, cv2 call, port call) cases of one primitive."""
    import cv2

    h, w = hw
    rng = np.random.default_rng(seed)
    m = w // 2  # how far off the frame a point may lie

    def pt():
        return int(rng.integers(-m, w + m)), int(rng.integers(-m, h + m))

    for _ in range(N_CASES):
        color = tuple(int(v) for v in rng.integers(1, 255, 3))
        if kind in ("line", "thick_line"):
            p1, p2 = pt(), pt()
            if rng.random() < 0.1:
                p2 = p1  # degenerate
            t = 1 if kind == "line" else int(rng.integers(2, 61))
            yield ((p1, p2, t), lambda img: cv2.line(img, p1, p2, color, t),
                   lambda img: draw.line(img, p1, p2, color, t))
        elif kind == "poly":
            pts = np.array([pt() for _ in range(4)], np.int32)
            yield (pts.tolist(), lambda img: cv2.fillConvexPoly(img, pts, color),
                   lambda img: draw.fill_convex_poly(img, pts, color))
        elif kind == "rectangle":
            p1, p2 = pt(), pt()
            yield ((p1, p2), lambda img: cv2.rectangle(img, p1, p2, color, -1),
                   lambda img: draw.rectangle(img, p1, p2, color))
        else:
            c, r = pt(), int(rng.integers(0, 101))
            yield ((c, r), lambda img: cv2.circle(img, c, r, color, -1),
                   lambda img: draw.circle(img, c, r, color))


KINDS = ["line", "thick_line", "poly", "rectangle", "circle"]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_primitive_is_pixel_equal_to_cv2(kind, hw):
    for args, theirs, ours in _sweep(kind, hw, seed=KINDS.index(kind) * 1000 + hw[0]):
        want = np.full(hw + (3,), 7, np.uint8)
        got = want.copy()
        theirs(want)
        ours(got)
        assert np.array_equal(got, want), (kind, args, int((got != want).any(-1).sum()))


def test_edge_cases_are_pixel_equal_to_cv2():
    """A torso quad that turns non-convex, a degenerate thick line, radius 0
    and 1, and shapes larger than the frame or wholly outside it."""
    import cv2

    cases = [
        ("fillConvexPoly", [(40, 10), (120, 30), (60, 60), (110, 100)]),  # self-crossing
        ("fillConvexPoly", [(80, 20), (60, 50), (100, 50), (80, 40)]),  # dent
        ("fillConvexPoly", [(-500, -400), (900, -300), (700, 800), (-300, 600)]),
        ("line", ((50, 50), (50, 50), 9)), ("line", ((-900, 40), (1200, 90), 60)),
        ("line", ((-300, -300), (-200, -250), 20)), ("line", ((10, 10), (150, 110), 2)),
        ("circle", ((30, 30), 0)), ("circle", ((30, 30), 1)), ("circle", ((80, 60), 400)),
        ("rectangle", ((-50, -50), (500, 500))), ("rectangle", ((30, 20), (30, 20))),
    ]
    for name, args in cases:
        want = np.zeros((120, 160, 3), np.uint8)
        got = want.copy()
        if name == "fillConvexPoly":
            cv2.fillConvexPoly(want, np.array(args, np.int32), (200, 100, 50))
            draw.fill_convex_poly(got, args, (200, 100, 50))
        elif name == "line":
            cv2.line(want, *args[:2], (200, 100, 50), args[2])
            draw.line(got, *args[:2], (200, 100, 50), args[2])
        elif name == "circle":
            cv2.circle(want, *args, (200, 100, 50), -1)
            draw.circle(got, *args, (200, 100, 50))
        else:
            cv2.rectangle(want, *args, (200, 100, 50), -1)
            draw.rectangle(got, *args, (200, 100, 50))
        assert np.array_equal(got, want), (name, args)


def test_bad_arguments_raise():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError):
        draw.circle(img, (2, 2), -1, 255)
    with pytest.raises(ValueError):
        draw.line(img, (0, 0), (4, 4), 255, 0)
