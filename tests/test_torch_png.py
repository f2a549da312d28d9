"""The port's PNG codec (``utils/png.py``) against cv2, and the rgb data
path against the JAX package's, on the CPU. Everything is compared
exactly: the decoder to ``cv2.imread`` on files cv2 writes (grey, BGR and
BGRA at several sizes) and on files built here with each of the five row
filters; the encoder through ``cv2.imread``; ``generate_dataset(
with_images=True)`` to the JAX generator's pixels (cv2's filled circle) and
``.npy`` bytes; ``_load_frame_image`` to the JAX loader's (cv2's decode and
INTER_LINEAR resize) on 224x224 and 64x64 files; rgb and hybrid episodes to
the JAX sampler's, also when a frame is missing."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from isbfsar_tpu.train import dataloader as jdl
from isbfsar_tpu.train.synthetic import generate_dataset as jax_generate_dataset
from isbfsar_tpu_torch.train import dataloader as tdl
from isbfsar_tpu_torch.train.synthetic import generate_dataset
from isbfsar_tpu_torch.utils.draw import circle
from isbfsar_tpu_torch.utils import png

SIZES = [(1, 1), (5, 7), (33, 17), (64, 48)]
CHANNELS = {0: 1, 2: 3, 6: 4}


def images(h, w, c, seed=0):
    """A random image and a smooth one (long runs of small differences, the
    case the filters are for)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    smooth = (ys[..., None] * 3 + xs[..., None] * 5 + 40 * np.arange(c)) % 256
    return [rng.integers(0, 256, (h, w, c), dtype=np.uint8), smooth.astype(np.uint8)]


def as_bgr(img):
    """What cv2.imread returns for a PNG holding ``img`` in PNG channel order."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def build_png(img, filters, colour=None, depth=8, interlace=0, extra=b""):
    """A PNG of ``img`` (H, W, C uint8 in PNG channel order) with row ``y``
    filtered by ``filters[y]``, the filters applied as the PNG standard
    writes them (on whole rows: the encoder needs no serial loop)."""
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c] if colour is None else colour
    raw = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        prior = raw[y - 1] if y else np.zeros_like(raw[y])
        left = np.concatenate([np.zeros(c, np.int32), raw[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        pred = [0, left, prior, (left + prior) // 2, paeth(left, prior, upleft)][filters[y]]
        rows.append(bytes([filters[y]]) + ((raw[y] - pred) % 256).astype(np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", header) + extra
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw", SIZES)
def test_decoder_matches_cv2_on_cv2_files(tmp_path, hw, channels):
    path = str(tmp_path / "img.png")
    for img in images(*hw, channels):
        assert cv2.imwrite(path, img[..., 0] if channels == 1 else img)
        np.testing.assert_array_equal(png.read_png(path), cv2.imread(path))


@pytest.mark.parametrize("colour", [0, 2, 6])
@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_decoder_reads_every_filter(tmp_path, colour, filters):
    path = str(tmp_path / "img.png")
    for img in images(23, 31, CHANNELS[colour], seed=1):
        kinds = (np.arange(23) % 5 if filters == "mixed"
                 else np.full(23, ["none", "sub", "up", "average", "paeth"].index(filters)))
        with open(path, "wb") as f:
            f.write(build_png(img, [int(k) for k in kinds]))
        want = cv2.imread(path)
        np.testing.assert_array_equal(want, as_bgr(img))
        np.testing.assert_array_equal(png.read_png(path), want)


@pytest.mark.parametrize("hw", SIZES + [(224, 224)])
def test_encoder_round_trips_through_cv2(tmp_path, hw):
    path = str(tmp_path / "img.png")
    for img in images(*hw, 3, seed=2):
        png.write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path), img)
        np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("kind,match", [
    ("palette", "palette"), ("16-bit", "16-bit"), ("interlaced", "interlaced"),
    ("grey+alpha", "colour type 4"), ("corrupt", "corrupt image data"), ("crc", "bad CRC"),
    ("not a png", "not a PNG")])
def test_refusals_name_the_file(tmp_path, kind, match):
    path = str(tmp_path / f"{kind}.png")
    img = images(4, 6, 3)[0]
    if kind == "palette":
        data = build_png(img[..., :1], [0] * 4, colour=3,
                         extra=chunk(b"PLTE", bytes(range(256)) * 3))
    elif kind == "16-bit":
        assert cv2.imwrite(path, img.astype(np.uint16) * 257)
        with open(path, "rb") as f:
            data = f.read()
    elif kind == "interlaced":
        data = build_png(img, [0] * 4, interlace=1)
    elif kind == "grey+alpha":
        data = build_png(img[..., :2], [0] * 4, colour=4)
    elif kind == "corrupt":  # CRCs right, so that the zlib stream is what fails
        data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 4, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", b"not a zlib stream") + chunk(b"IEND", b""))
    elif kind == "crc":
        data = bytearray(png.encode_png(img))
        data[-5] ^= 1  # the IEND chunk's CRC
        data = bytes(data)
    else:
        data = b"GIF89a" + bytes(40)
    if kind != "16-bit":
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match=match) as info:
        png.read_png(path)
    assert path in str(info.value)
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("size", [32, 64, 224])
def test_generate_dataset_with_images_matches_jax(tmp_path, size):
    """The same ``.npy`` bytes and the same pixels as the JAX generator,
    which draws with ``cv2.circle`` and writes with ``cv2.imwrite``."""
    for root, gen in (("jax", jax_generate_dataset), ("port", generate_dataset)):
        gen(str(tmp_path / root), n_classes=3, clips_per_class=1, with_images=True,
            image_size=size, seed=4)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 3 * 16 * 2
    for f in files:
        a, b = str(tmp_path / "jax" / f), str(tmp_path / "port" / f)
        if f.endswith(".npy"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
        else:
            np.testing.assert_array_equal(cv2.imread(b), cv2.imread(a), err_msg=f)


def test_fill_circle_is_cv2s_circle():
    """Filled circles at every radius and centre the generator can use,
    and at the image's edges, where the spans are clipped."""
    for size in (16, 48, 100):
        for cx in range(-size // 4, size + size // 4, 3):
            for cy, r in ((size // 2, size // 8), (0, size // 3), (size - 1, 5), (-2, 3)):
                want = np.full((size, size + 3, 3), 9, np.uint8)
                got = want.copy()
                cv2.circle(want, (cx, cy), r, (255, 255, 255), -1)
                circle(got, (cx, cy), r, 255)
                np.testing.assert_array_equal(got, want, err_msg=str((size, cx, cy, r)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """6 classes x 2 clips with 64x64 crops: a 5-way episode and its
    unknown class, with a second clip to retry on."""
    root = str(tmp_path_factory.mktemp("rgb_tree"))
    jax_generate_dataset(root, n_classes=6, clips_per_class=2, with_images=True, image_size=64,
                         seed=5)
    return root


@pytest.mark.parametrize("size", [64, 224])
def test_load_frame_image_matches_jax(tmp_path, tree, size):
    if size == 64:
        clip = os.path.join(tree, "action_02", "1")
    else:
        jax_generate_dataset(str(tmp_path), n_classes=1, clips_per_class=1, with_images=True,
                             seed=6)
        clip = str(tmp_path / "action_00" / "0")
    for i in (0, 7, 15):
        want = jdl._load_frame_image(clip, i)
        got = tdl._load_frame_image(clip, i)
        assert got.dtype == want.dtype == np.float64 and got.shape == (224, 224, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tdl._load_frame_image(clip, 16)


@pytest.mark.parametrize("mode", ["rgb", "hybrid"])
def test_episodes_match_jax(tree, tmp_path, mode):
    """With one loader thread the port's rgb and hybrid episodes are the JAX
    sampler's, array for array; and so they are when a clip lacks a frame,
    which both samplers skip by retrying another clip."""
    import shutil

    def episodes(root):
        want = list(jdl.batch_iterator(
            jdl.EpisodicSampler(root, k=5, n_task=4, max_l=16, l=8, input_type=mode, seed=3), 2,
            num_threads=1, seed=1))
        got = list(tdl.batch_iterator(
            tdl.EpisodicSampler(root, k=5, n_task=4, max_l=16, l=8, input_type=mode, seed=3), 2,
            num_threads=1, seed=1))
        assert len(want) == len(got) == 2
        for w, g in zip(want, got):
            assert sorted(w) == sorted(g)
            for k in w:
                for m, a in (w[k].items() if isinstance(w[k], dict) else [("", w[k])]):
                    b = g[k][m] if m else g[k]
                    assert a.dtype == b.dtype, (k, m)
                    np.testing.assert_array_equal(a, b, err_msg=f"{k}/{m}")
        return got

    got = episodes(tree)
    assert got[0]["target_set"]["rgb"].shape == (2, 8, 224, 224, 3)
    broken = str(tmp_path / "broken")
    shutil.copytree(tree, broken)
    for c in range(6):
        os.remove(os.path.join(broken, f"action_{c:02d}", "0", "9.png"))
    assert not all(np.array_equal(a["target_set"]["rgb"], b["target_set"]["rgb"])
                   for a, b in zip(got, episodes(broken)))
