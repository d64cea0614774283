"""PNG files and a bilinear resize in numpy and ``zlib`` alone.

The serving CLI reads images on machines that have neither cv2 nor PIL, so
the port carries its own PNG codec and the resize that ``cv2.resize(...,
interpolation=cv2.INTER_LINEAR)`` computes:

  * :func:`read_png` — 8-bit, non-interlaced PNG of colour type 0 (grey),
    2 (RGB), 4 (grey + alpha) or 6 (RGBA), every row filter, any number of
    IDAT chunks, each chunk's CRC checked; uint8 ``[H, W, 3]`` RGB out
    (alpha dropped, as ``cv2.imread`` drops it). Anything else raises and
    names what it does not take.
  * :func:`write_png` — uint8 ``[H, W]``, ``[H, W, 1]``, ``[H, W, 3]`` or
    ``[H, W, 4]`` to a PNG (filter 0 on every row).
  * :func:`read_png_gray` — the same files as uint8 ``[H, W]`` grey, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` reads them.
  * :func:`read_image` / :func:`read_mask` — any image file as RGB / grey:
    a PNG through the codec above, a JPEG (found by its FFD8FF magic, not
    its suffix) through ``ops/kernels/jpeg.py::read_jpeg`` (bit for bit
    with ``cv2.imread``, on the card by default, on the CPU with
    ``device="cpu"``), other formats through cv2, else PIL, and without
    either an ``ImportError``.
  * :func:`resize_bilinear_u8` / :func:`resize_nearest_u8` — cv2's
    ``INTER_LINEAR`` (geometry and fixed-point arithmetic) and
    ``INTER_NEAREST``.

"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..ops.kernels.jpeg import read_jpeg
from .jpeg import is_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, n: int) -> np.ndarray:
    """Undo the five row filters. Each byte depends on its left, upper and
    upper-left neighbours, so the pixels are reconstructed one anti-diagonal
    (x + y constant) at a time, every row of the diagonal with its own
    filter: H + W - 1 vector steps instead of a loop over the pixels."""
    rows = raw.reshape(h, 1 + w * n)
    types = rows[:, 0].astype(np.int32)
    if types.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(types.max())}")
    filt = rows[:, 1:].reshape(h, w, n).astype(np.int32)
    if not types.any():
        return filt.astype(np.uint8)
    rec = np.zeros((h + 1, w + 1, n), np.int32)  # row 0 and column 0 are the zero border
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        t = types[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def _decode_png(path) -> np.ndarray:
    """The PNG at ``path`` as uint8 ``[H, W, n]``, n its samples per pixel."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, str(path)):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit samples are read")
    if ctype not in _CHANNELS:
        what = "palette (colour type 3)" if ctype == 3 else f"colour type {ctype}"
        raise ValueError(f"{path}: {what} PNG; only grey, RGB, grey+alpha and RGBA are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG; only non-interlaced images are read")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression {comp} or filter method {filt}")
    n = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * n):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, want {h * (1 + w * n)}")
    return _unfilter(raw, h, w, n)


def read_png(path) -> np.ndarray:
    """The PNG at ``path`` as uint8 ``[H, W, 3]`` RGB (grey repeated to three
    channels, alpha dropped)."""
    img = _decode_png(path)
    if img.shape[2] <= 2:  # grey (+ alpha)
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png_gray(path) -> np.ndarray:
    """The PNG at ``path`` as uint8 ``[H, W]`` grey: a grey PNG's samples, a
    colour one converted as cv2's ``COLOR_RGB2GRAY`` does (fixed point,
    (4899 R + 9617 G + 1868 B + 2^13) >> 14), alpha dropped."""
    img = _decode_png(path)
    if img.shape[2] <= 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.int32)
    return ((rgb @ np.asarray([4899, 9617, 1868], np.int32) + (1 << 13)) >> 14).astype(np.uint8)


def _other_format(path: str, gray: bool) -> np.ndarray:
    """An image that is neither PNG nor JPEG through cv2, else PIL; without
    either it raises: there is no substitute decoder."""
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(
                f"{path}: reading a {Path(path).suffix or 'suffix-less'} image needs cv2 or "
                "PIL, and neither is installed; the port reads PNG and JPEG itself "
                "(data/imageio.py::read_png, ops/kernels/jpeg.py::read_jpeg)") from None
        return np.asarray(Image.open(path).convert("L" if gray else "RGB"))
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"Image not found or corrupted: {path}")
    return img if gray else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_image(path, device="cuda") -> np.ndarray:
    """uint8 ``[H, W, 3]`` RGB. A ``.png`` is read by the port's own codec and
    a JPEG by ``ops/kernels/jpeg.py::read_jpeg`` (on ``device``: the card by default, where
    there is none it raises unless given "cpu") on every machine; any other
    file by cv2, else PIL."""
    path = str(path)
    if Path(path).suffix.lower() == ".png":
        return read_png(path)
    if is_jpeg(path):
        return read_jpeg(path, device=device)
    return _other_format(path, gray=False)


def read_mask(path, device="cuda") -> np.ndarray:
    """uint8 ``[H, W]`` grey, as :func:`read_image` picks the decoder (a
    JPEG's grey read is libjpeg's: the Y plane of a colour file)."""
    path = str(path)
    if Path(path).suffix.lower() == ".png":
        return read_png_gray(path)
    if is_jpeg(path):
        return read_jpeg(path, gray=True, device=device)
    return _other_format(path, gray=True)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray, level: int = 6) -> None:
    """Write uint8 ``img`` (``[H, W]`` or ``[H, W, 1]`` grey, ``[H, W, 3]``
    RGB, ``[H, W, 4]`` RGBA) as a PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png takes [H, W], [H, W, 1|3|4], got {img.shape}")
    h, w, n = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[n]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * n)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def _taps(dst: int, src: int):
    """cv2's INTER_LINEAR source index and fixed-point weights per output
    position: half-pixel centres, the border clamped."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f = np.where(i0 < 0, 0.0, f)
    i0 = np.maximum(i0, 0)
    f = np.where(i0 >= src - 1, 0.0, f)
    i0 = np.minimum(i0, src - 1)
    scale = 1 << _COEF_BITS
    w1 = np.rint(f.astype(np.float32) * scale).astype(np.int64)
    w0 = np.rint((1.0 - f.astype(np.float32)) * scale).astype(np.int64)
    return i0, np.minimum(i0 + 1, src - 1), w0, w1


def resize_bilinear_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``img`` (uint8 ``[H, W]`` or ``[H, W, C]``) resized to ``h`` x ``w`` as
    ``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` does it:
    source position ``(x + 0.5) * W / w - 0.5``, clamped to the image,
    weights rounded to 11 bits, a horizontal pass in integers, then cv2's
    vector vertical pass (each row's sum shifted right by 4, times its
    weight, shifted right by 16; the two added and rounded off two bits).
    Against cv2 5.0 it is within 1 LSB everywhere and equal on 99.85-100 %
    of the values of the cases in ``tests/test_torch_imageio.py`` (the rest
    fall in the rows that cv2 finishes with its scalar loop, which rounds
    once)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear_u8 takes uint8, got {img.dtype}")
    src_h, src_w = img.shape[:2]
    x0, x1, a0, a1 = _taps(w, src_w)
    y0, y1, b0, b1 = _taps(h, src_h)
    v = img.astype(np.int64)
    extra = (None,) * (img.ndim - 2)
    hor = (slice(None),) + extra
    row = v[:, x0] * a0[hor] + v[:, x1] * a1[hor]
    ver = (slice(None), None) + extra
    out = (((row[y0] >> 4) * b0[ver]) >> 16) + (((row[y1] >> 4) * b1[ver]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize_nearest_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``img`` (``[H, W]`` or ``[H, W, C]``) resized to ``h`` x ``w`` as
    ``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` does it:
    output x takes source ``min(floor(x / (w / W)), W - 1)`` (the scale's
    inverse in double, as cv2 computes it), and the same in y."""
    img = np.asarray(img)
    src_h, src_w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))).astype(np.int64), src_w - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))).astype(np.int64), src_h - 1)
    return np.ascontiguousarray(img[ys][:, xs])
