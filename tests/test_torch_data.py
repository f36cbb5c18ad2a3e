"""gstk_torch's data path against gstk_tpu's and its libraries on the CPU.

  * The PNG codec (``utils/io.py``) reads what Pillow writes and writes
    what Pillow reads, bit for bit: 8-bit grey, RGB and RGBA, 16-bit grey,
    and a file whose rows use all five filter types.
  * The coarse-to-fine downscale (``train/trainer.py::area_downscale``)
    against ``cv2.resize(INTER_AREA)``, for sizes divisible by the factor
    and sizes that are not: within 5e-7 absolute (values in [0, 1]; a few
    ulps, the rounding of weighted sums of up to 16 values).
  * The dataparser's and datamanager's outputs and the camera order equal
    gstk_tpu's on the fixture dataset of ``tests/test_data.py``.
"""

import dataclasses
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from gstk_tpu.data.datamanager import FullImageDatamanager as JDatamanager
from gstk_tpu.data.dataparser import DataparserConfig as JDataparserConfig
from gstk_tpu.data.dataparser import parse_transforms as jparse
from gstk_tpu.utils import io as jio
from gstk_torch.data.datamanager import FullImageDatamanager
from gstk_torch.data.dataparser import DataparserConfig, parse_transforms
from gstk_torch.train.trainer import area_downscale
from gstk_torch.utils import io as tio

from tests.test_data import _make_dataset

DOWNSCALE_ATOL = 5e-7


def _png_content(kind, rng, h=37, w=53):
    """Noise beside smooth ramps, so Pillow's adaptive filtering picks
    several filter types."""
    shape, dtype = {
        "grey8": ((h, w), np.uint8), "rgb8": ((h, w, 3), np.uint8),
        "rgba8": ((h, w, 4), np.uint8), "grey16": ((h, w), np.uint16),
    }[kind]
    top = np.iinfo(dtype).max + 1
    noise = rng.integers(0, top, shape)
    ramp = np.cumsum(rng.integers(0, 9, shape), axis=1) * (top // 256)
    rows = np.arange(h).reshape((h,) + (1,) * (len(shape) - 1))
    return np.where(rows < h // 2, noise, ramp % top).astype(dtype)


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16"])
def test_png_codec_matches_pillow(kind, tmp_path):
    arr = _png_content(kind, np.random.default_rng(0))
    path = tmp_path / "pillow.png"
    Image.fromarray(arr).save(path)
    got = tio.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
    path = tmp_path / "port.png"
    tio.write_png(path, arr)
    back = np.asarray(Image.open(path))
    assert back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    assert tio.image_size(path) == Image.open(path).size


def _filter_row(kind, row, prior, bpp):
    """PNG filter ``kind`` applied to one scanline (ints, mod 256)."""
    row, prior = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


def test_png_reads_every_filter_type(tmp_path):
    """Rows filtered None, Sub, Up, Average and Paeth in turn; Pillow
    decodes the file as the reference."""
    rng = np.random.default_rng(1)
    h, w, bpp = 20, 11, 3
    img = rng.integers(0, 256, (h, w, bpp)).astype(np.uint8)
    rows, prior = [], np.zeros(w * bpp, np.uint8)
    for y in range(h):
        line = img[y].reshape(-1)
        rows.append(bytes([y % 5]) + _filter_row(y % 5, line, prior, bpp).tobytes())
        prior = line
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data)))
    path = tmp_path / "filters.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(tio.read_png(path), img)


def _photo(rng, h, w, channels, top=256):
    """Photo-like content: smooth sinusoidal shading with mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    field = sum(rng.uniform(20, 60) * np.sin(rng.uniform(0.02, 0.2) * xx
                                             + rng.uniform(0.02, 0.2) * yy
                                             + rng.uniform(0, 6))
                for _ in range(4))
    tint = rng.uniform(0.5, 1.0, channels)
    img = 128 + field[..., None] * tint + rng.normal(0, 1, (h, w, channels))
    img = np.clip(img * (top // 256), 0, top - 1)
    return img[..., 0] if channels == 1 else img


def _filter_types(path):
    """The filter type of every row of a PNG file."""
    data = path.read_bytes()
    width, height, depth, colour = struct.unpack(">IIBB", data[16:26])
    idat = b"".join(body for tag, body in tio._png_chunks(data) if tag == b"IDAT")
    stride = width * {0: 1, 2: 3, 4: 2, 6: 4}[colour] * depth // 8
    return np.frombuffer(zlib.decompress(idat), np.uint8)[::stride + 1][:height]


def test_png_reads_pillow_photo_with_paeth_rows(tmp_path):
    """800x600 photo-like RGB: Pillow's adaptive filtering writes most rows
    Paeth; the file reads bit-exact."""
    img = _photo(np.random.default_rng(3), 600, 800, 3).astype(np.uint8)
    path = tmp_path / "photo.png"
    Image.fromarray(img).save(path)
    kinds = _filter_types(path)
    assert (kinds == 4).sum() > len(kinds) // 2
    got = tio.read_png(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("layout", ["rgb8", "rgba8", "grey16"])
@pytest.mark.parametrize("rows", ["average", "paeth", "mixed"])
def test_png_reads_average_and_paeth_rows(tmp_path, layout, rows):
    """Photo-like images filtered by hand (Pillow does not choose Average):
    every row Average, every row Paeth, or all five types in random order
    after rows of None, Sub and Up; Pillow decodes the file as the
    reference."""
    rng = np.random.default_rng(4)
    h, w = 45, 67
    channels, depth, colour = {"rgb8": (3, 8, 2), "rgba8": (4, 8, 6),
                               "grey16": (1, 16, 0)}[layout]
    dtype = np.uint16 if depth == 16 else np.uint8
    img = _photo(rng, h, w, channels, 1 << depth).astype(dtype)
    lines = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    lines = lines.view(np.uint8).reshape(h, -1)
    bpp = channels * depth // 8
    kinds = {"average": [3] * h, "paeth": [4] * h,
             "mixed": [0, 1, 2] + list(rng.integers(0, 5, h - 3))}[rows]
    out, prior = [], np.zeros(lines.shape[1], np.uint8)
    for y in range(h):
        out.append(bytes([kinds[y]])
                   + _filter_row(kinds[y], lines[y], prior, bpp).tobytes())
        prior = lines[y]
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data)))
    path = tmp_path / "filtered.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  colour, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(out)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(_filter_types(path), kinds)
    got = tio.read_png(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("loader", ["load_image", "load_depth", "load_mask"])
def test_loaders_match_jax(loader, tmp_path):
    rng = np.random.default_rng(2)
    if loader == "load_depth":
        arr = rng.integers(500, 3000, (24, 31)).astype(np.uint16)
    elif loader == "load_mask":
        arr = (rng.uniform(size=(24, 31)) < 0.5).astype(np.uint8) * 255
    else:
        arr = rng.integers(0, 256, (24, 31)).astype(np.uint8)  # grey -> RGB
    path = tmp_path / "x.png"
    Image.fromarray(arr).save(path)
    got, want = getattr(tio, loader)(path), getattr(jio, loader)(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,c,d", [
    (48, 64, 3, 2), (48, 64, 4, 4),  # divisible
    (49, 65, 3, 2), (50, 67, 4, 3), (37, 53, 3, 2),  # not divisible
])
def test_area_downscale_matches_cv2(h, w, c, d):
    rng = np.random.default_rng(h * w + d)
    img = (rng.integers(0, 256, (h, w, c)) / 255.0).astype(np.float32)
    want = cv2.resize(img, (w // d, h // d), interpolation=cv2.INTER_AREA)
    got = area_downscale(torch.from_numpy(img), d).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DOWNSCALE_ATOL)
    # a stack of images downscales image by image
    both = area_downscale(torch.from_numpy(np.stack([img, img[::-1].copy()])), d)
    np.testing.assert_array_equal(both[0].numpy(), got)


def _equal(a, b, name):
    if isinstance(a, list):
        assert [str(x) for x in a] == [str(x) for x in b], name
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, name


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataparser_matches_jax(split, tmp_path):
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    kw = dict(data=data, eval_mode="interval", eval_interval=3)
    got = parse_transforms(DataparserConfig(**kw), split)
    want = jparse(JDataparserConfig(**kw), split)
    for f in dataclasses.fields(want):
        _equal(getattr(got, f.name), getattr(want, f.name), f.name)


def test_datamanager_matches_jax(tmp_path):
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    kw = dict(data=data, eval_mode="interval", eval_interval=3)
    got = FullImageDatamanager(DataparserConfig(**kw), seed=7)
    want = JDatamanager(JDataparserConfig(**kw), seed=7)
    assert got.image_size == want.image_size
    assert got.num_train == want.num_train == 4
    for a, b in zip(got.train_frames + got.eval_frames,
                    want.train_frames + want.eval_frames):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    for s in (got.seed_points(), want.seed_points()):
        assert s[0].shape == (50, 3)
    np.testing.assert_array_equal(got.seed_points()[0], want.seed_points()[0])
    # the same camera order over five epochs
    order = lambda dm: [dm.next_train()[0] for _ in range(5 * dm.num_train)]
    assert order(got) == order(want)
