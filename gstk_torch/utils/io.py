"""File IO: PLY point clouds, PNG images, depth maps and masks (port of
``gstk_tpu/utils/io.py``).

The PLY codec is gstk_tpu's (ascii and binary little/big endian, arbitrary
vertex properties). PNG is read and written here with ``zlib`` and numpy
alone: non-interlaced, 8- and 16-bit, grey, grey + alpha, RGB and RGBA, all
five filter types on read; the writer uses filter 0 on every row. Other
formats (JPEG, ...), PNG variants the codec does not decode (palette,
interlaced) and resizing on load go through Pillow, imported only then.
"""

from __future__ import annotations

import io as _io
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY file; returns {element_name: structured array}.

    List properties (e.g. face vertex_indices) are returned as object arrays.
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing ply magic")
    fmt = None
    elements: List[Tuple[str, int, List]] = []  # (name, count, props)
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        text_rows = body.decode("ascii").split("\n")
        row_i = 0
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            rows = []
            for _ in range(count):
                vals = text_rows[row_i].split()
                row_i += 1
                rec, vi = [], 0
                for pname, ptype in props:
                    if isinstance(ptype, tuple):
                        n = int(vals[vi]); vi += 1
                        rec.append(np.asarray(vals[vi:vi + n], _PLY_DTYPES[ptype[2]]))
                        vi += n
                    else:
                        rec.append(np.dtype(_PLY_DTYPES[ptype]).type(vals[vi]))
                        vi += 1
                rows.append(tuple(rec))
            dtype = [
                (pname, object if isinstance(pt, tuple) else _PLY_DTYPES[pt])
                for pname, pt in props
            ]
            out[name] = np.array(rows, dtype=dtype)
    elif fmt in ("binary_little_endian", "binary_big_endian"):
        endian = "<" if fmt == "binary_little_endian" else ">"
        buf = _io.BytesIO(body)
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if not has_list:
                dtype = np.dtype(
                    [(pname, endian + _PLY_DTYPES[pt]) for pname, pt in props]
                )
                out[name] = np.frombuffer(
                    buf.read(dtype.itemsize * count), dtype=dtype
                ).copy()
            else:
                rows = []
                for _ in range(count):
                    rec = []
                    for pname, pt in props:
                        if isinstance(pt, tuple):
                            cnt_dt = np.dtype(endian + _PLY_DTYPES[pt[1]])
                            n = int(np.frombuffer(buf.read(cnt_dt.itemsize), cnt_dt)[0])
                            it_dt = np.dtype(endian + _PLY_DTYPES[pt[2]])
                            rec.append(
                                np.frombuffer(buf.read(it_dt.itemsize * n), it_dt).copy()
                            )
                        else:
                            dt = np.dtype(endian + _PLY_DTYPES[pt])
                            rec.append(np.frombuffer(buf.read(dt.itemsize), dt)[0])
                    rows.append(tuple(rec))
                dtype = [
                    (pname, object if isinstance(pt, tuple) else _PLY_DTYPES[pt])
                    for pname, pt in props
                ]
                out[name] = np.array(rows, dtype=dtype)
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return out


def read_ply_points(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read (xyz float32 (N,3), rgb uint8 (N,3) or None) from a PLY."""
    ply = read_ply(path)
    v = ply["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    names = v.dtype.names
    rgb = None
    if all(c in names for c in ("red", "green", "blue")):
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=-1)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return xyz, rgb


def write_ply(
    path,
    elements: Dict[str, Dict[str, np.ndarray]],
    fmt: str = "binary_little_endian",
    comments: Optional[List[str]] = None,
) -> None:
    """Write a PLY: {element: {property: (N,) array}} (insertion ordered)."""
    lines = ["ply", f"format {fmt} 1.0"]
    for c in comments or []:
        lines.append(f"comment {c}")
    rev = {v: k for k, v in _PLY_DTYPES.items()}
    for ename, props in elements.items():
        n = len(next(iter(props.values())))
        lines.append(f"element {ename} {n}")
        for pname, arr in props.items():
            lines.append(f"property {rev[arr.dtype.str[1:]]} {pname}")
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        for ename, props in elements.items():
            arrs = list(props.values())
            n = len(arrs[0])
            if fmt == "ascii":
                for i in range(n):
                    f.write(
                        (" ".join(str(a[i]) for a in arrs) + "\n").encode("ascii")
                    )
            else:
                endian = "<" if fmt == "binary_little_endian" else ">"
                rec = np.empty(
                    n,
                    dtype=[
                        (pname, endian + a.dtype.str[1:])
                        for pname, a in props.items()
                    ],
                )
                for pname, a in props.items():
                    rec[pname] = a
                f.write(rec.tobytes())


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (grey, RGB, grey + alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _PNG_SIGNATURE


def _pil_image():
    """Pillow's ``Image`` module, for what the PNG codec does not cover."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "this image needs Pillow (a format other than PNG, a palette or "
            "interlaced PNG, or a resize on load), and Pillow is not installed"
        ) from e
    return Image


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_row(kind: int, line: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One reconstructed scanline (uint8) from its filtered bytes, for the
    filter types that need no left-to-right walk (None, Sub, Up)."""
    if kind == 0:  # None
        return line
    if kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
        return line.reshape(-1, bpp).cumsum(0, dtype=np.uint8).reshape(-1)
    return line + prior  # Up


def _predict(kind: int, a, b, c):
    """PNG filter ``kind``'s predictor from the left, up and up-left bytes
    (int16 arrays)."""
    if kind == 0:
        return 0
    if kind == 1:
        return a
    if kind == 2:
        return b
    if kind == 3:
        return (a + b) >> 1
    # Paeth: p = a + b - c; the byte of a, b, c nearest p, in that order
    bc, ac = b - c, a - c  # p - a, p - b
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(kinds: np.ndarray, lines: np.ndarray,
                        prior: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstructed rows (uint8, (H, stride)) of any filter types after
    the row ``prior``, in H + W numpy steps.

    Byte (r, x) of pixel x depends on (r, x - 1), (r - 1, x) and (r - 1,
    x - 1) only, so every pixel of an anti-diagonal r + x = s can be
    reconstructed at once from the two diagonals before it. The rows are
    stored skewed, cell (r, x) at ``grid[r + x, r]`` (with the prior row
    as r = 0 and a zero column as x = 0), so that each diagonal and its
    three neighbours are plain slices; each row's filter type selects its
    predictor, and only the predictors of the types present are
    computed."""
    height, stride = lines.shape
    width = stride // bpp
    rr = np.arange(1, height + 1)[:, None]
    xx = np.arange(1, width + 1)[None, :]
    grid = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    raw = np.zeros_like(grid)
    raw[rr + xx, rr] = lines.reshape(height, width, bpp)
    grid[np.arange(1, width + 1), 0] = prior.reshape(width, bpp)
    kind = np.concatenate([[0], kinds])[:, None]
    used = [int(k) for k in np.unique(kinds)]
    for s in range(2, height + width + 1):
        lo, hi = max(1, s - width), min(height, s - 1) + 1
        a = grid[s - 1, lo:hi]  # left
        b = grid[s - 1, lo - 1:hi - 1]  # up
        c = grid[s - 2, lo - 1:hi - 1]  # up-left
        if len(used) == 1:
            pred = _predict(used[0], a, b, c)
        else:
            pred = 0
            for k in used:
                pred = np.where(kind[lo:hi] == k, _predict(k, a, b, c), pred)
        grid[s, lo:hi] = (raw[s, lo:hi] + pred) & 0xFF
    return grid[rr + xx, rr].astype(np.uint8).reshape(height, stride)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The image bytes (H, stride) from the filtered scanlines (H, 1 +
    stride): row by row up to the first Average or Paeth row, whose
    left-to-right dependence a row-at-a-time numpy pass cannot follow, and
    from there by :func:`_unfilter_wavefront`."""
    kinds = rows[:, 0]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"PNG filter type {int(kinds.max())} is not defined")
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    walk = np.flatnonzero(kinds >= 3)
    first = int(walk[0]) if walk.size else rows.shape[0]
    prior = np.zeros(out.shape[1], np.uint8)
    for y in range(first):
        prior = out[y] = _unfilter_row(int(kinds[y]), rows[y, 1:], prior, bpp)
    if first < rows.shape[0]:
        out[first:] = _unfilter_wavefront(kinds[first:], rows[first:, 1:],
                                          prior, bpp)
    return out


def read_png(path) -> np.ndarray:
    """A PNG as uint8 or uint16: (H, W) grey, else (H, W, channels).

    Raises ``NotImplementedError`` for palette, interlaced and sub-byte
    images, which :func:`load_image` hands to Pillow."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{path}: PNG colour type {colour}, bit depth {depth}, "
            f"interlace {interlace}"
        )
    channels = _PNG_CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    out = _unfilter(rows, bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape((height, width) if channels == 1
                       else (height, width, channels))


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 or uint16 image, (H, W) or (H, W, 1|2|3|4), as PNG."""
    arr = np.asarray(image)
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(arr.dtype)
    if depth is None:
        raise ValueError(f"PNG holds uint8 or uint16, got {arr.dtype}")
    channels = 1 if arr.ndim == 2 else arr.shape[-1]
    if arr.ndim not in (2, 3) or channels not in (1, 2, 3, 4):
        raise ValueError(f"PNG image must be (H, W[, 1-4]), got {arr.shape}")
    colour = {1: 0, 3: 2, 2: 4, 4: 6}[channels]
    h, w = arr.shape[:2]
    body = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8)
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), body.view(np.uint8).reshape(h, -1)], axis=1
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def image_size(path) -> Tuple[int, int]:
    """(width, height) of an image file, from a PNG's header without
    decoding it."""
    if _is_png(path):
        with open(path, "rb") as f:
            head = f.read(24)
        return struct.unpack(">II", head[16:24])
    with _pil_image().open(path) as img:
        return img.size


def _read_image(path, scale_factor: float = 1.0, resample: str = "NEAREST"
                ) -> np.ndarray:
    """An image file as an array; PNG through :func:`read_png` unless it
    must be resized."""
    if scale_factor == 1.0 and _is_png(path):
        try:
            return read_png(path)
        except NotImplementedError:
            pass
    Image = _pil_image()
    with Image.open(path) as img:
        if scale_factor != 1.0:
            w, h = img.size
            img = img.resize(
                (round(w * scale_factor), round(h * scale_factor)),
                getattr(Image, resample),
            )
        return np.asarray(img)


def load_image(path, scale_factor: float = 1.0) -> np.ndarray:
    """uint8 (H, W, 3|4) image; grey images are repeated to 3 channels."""
    arr = _read_image(path, scale_factor, resample="BILINEAR")
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr


def load_depth(path, depth_unit_scale_factor: float = 1e-3,
               scale_factor: float = 1.0) -> np.ndarray:
    """float32 (H, W) depth in meters: a 16-bit PNG in mm, or .npy."""
    path = Path(path)
    if path.suffix == ".npy":
        depth = np.load(path).astype(np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        if scale_factor != 1.0:
            import cv2

            depth = cv2.resize(
                depth, None, fx=scale_factor, fy=scale_factor,
                interpolation=cv2.INTER_NEAREST,
            )
        return depth
    img = _read_image(path, scale_factor)
    return img.astype(np.float32) * depth_unit_scale_factor


def load_mask(path, scale_factor: float = 1.0) -> np.ndarray:
    """bool (H, W) mask."""
    arr = _read_image(path, scale_factor)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr > 0
