"""JPEG pixels on the card (kernel K6): the wrappers of ``csrc/jpeg.cu`` and
their plain versions.

K6 replaces no TPU kernel: it is the counterpart of the libjpeg-turbo decode
that the JAX package runs on the host through cv2. ``data/jpeg.py`` parses
the file and lays out its coefficients (``Layout``); here:

  * :func:`entropy_decode` — the C entropy decoder of ``csrc/jpeg.cu``
    (host code, called through ctypes, which releases the GIL), one call per
    scan, into int16 ``[blocks, 64]`` coefficients (pinned memory when asked).
  * :func:`jpeg_idct` (K6a) — dequantisation and libjpeg's ``JDCT_ISLOW``
    inverse DCT per 8x8 block into each component's uint8 plane. CUDA
    tensor: one launch; CPU tensor: :func:`jpeg_idct_plain`.
  * :func:`jpeg_color` (K6b) — upsampling (libjpeg-turbo's "fancy" filters)
    and colour conversion into uint8 ``[H, W, 3]`` RGB or ``[H, W]`` grey.
    CUDA tensor: one launch; CPU tensor: :func:`jpeg_color_plain`.
  * :func:`decode_on_card` — the card route of :func:`decode_jpeg`: the C
    decoder into pinned memory, the upload, K6a and K6b on a CUDA stream of
    the calling thread's own, and the download; numpy out.
  * :func:`decode_jpeg` / :func:`read_jpeg` — a JPEG's pixels, bit for bit
    with ``cv2.imread``: the one place that picks the route, the card
    (:func:`decode_on_card`) or the CPU (the Python entropy decoder of
    ``data/jpeg.py`` and the plain versions).

The plain versions compute in int64 torch on any device, step by step as
libjpeg does; the kernels give the same bits. Launch counts:
``jpeg_idct.launches`` and ``jpeg_color.launches`` are plain integers that
each wrapper raises by one at each launch, and nowhere else (under a lock:
the loader's threads decode at once).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...data import jpeg as codec
from ...utils.profiling import register_kernels
from .build import load_library


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("jpeg")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jpeg_entropy_scan.argtypes = [vp, cll, cll, ci, vp, vp, ci, ci, ci, vp]
    lib.jpeg_entropy_scan.restype = ci
    lib.jpeg_idct.argtypes = [vp, vp, vp, vp, vp]
    lib.jpeg_color.argtypes = [vp, vp, vp, vp]
    lib.jpeg_idct.restype = lib.jpeg_color.restype = ci
    return lib


def _params(lay: codec.Layout) -> np.ndarray:
    """The int32 parameter array of ``csrc/jpeg.cu::make_params``."""
    a = [lay.mode, lay.ncomp, lay.height, lay.width, lay.blocks]
    for c in range(3):
        if c < len(lay.bw):
            a += [lay.block_off[c], lay.bw[c], lay.bh[c], lay.cw[c], lay.ch[c], lay.up[c],
                  lay.plane_off[c] // 64]
        else:
            a += [0] * 7
    return np.asarray(a, np.int32)


# --------------------------------------------------------------- entropy
_ERRORS = {1: "truncated scan (the entropy-coded data ends early)",
           2: "corrupt or truncated scan (no Huffman code matches)",
           3: "bad Huffman table"}


def entropy_decode(data: bytes, frame: codec.Frame, pin: bool = False) -> torch.Tensor:
    """The C entropy decoder: int16 ``[blocks, 64]`` natural-order
    coefficients of every component (``data/jpeg.py::entropy_decode_py``'s
    layout and values), in pinned host memory with ``pin``."""
    lib = _library()
    total = sum(c.bw * c.bh for c in frame.comps)
    out = torch.zeros((total, 64), dtype=torch.int16, pin_memory=pin)
    base, offs = out.data_ptr(), []
    for c in frame.comps:
        offs.append(base)
        base += c.bw * c.bh * 128
    for scan in frame.scans:
        ns = len(scan.comps)
        comp = []
        for ci in scan.comps:
            c = frame.comps[ci]
            comp += [c.h, c.v, c.bw, -(-c.width // 8), -(-c.height // 8)]
        tables = b"".join(bits + vals.ljust(256, b"\0")
                          for d, a in zip(scan.dc, scan.ac) for bits, vals in (d, a))
        comp_a = np.asarray(comp, np.int32)
        outs = np.asarray([offs[ci] for ci in scan.comps], np.int64)
        rc = lib.jpeg_entropy_scan(data, scan.begin, scan.end, ns, comp_a.ctypes.data, tables,
                                   frame.mcux, frame.mcuy, scan.restart, outs.ctypes.data)
        if rc:
            raise ValueError(f"JPEG: {_ERRORS.get(rc, f'entropy decoder error {rc}')}")
    return out


# ------------------------------------------------------------- K6a: IDCT
def _idct_pass(d: torch.Tensor, dim: int, shift: int) -> torch.Tensor:
    """One pass of jidctint.c's ``jpeg_idct_islow`` along ``dim`` of int64
    ``[N, 8, 8]``: columns first (``shift`` 11), then rows (18)."""
    k = codec.ISLOW
    x = [d.select(dim, i) for i in range(8)]
    z1 = (x[2] + x[6]) * k["c0541"]
    tmp2 = z1 - x[6] * k["c1847"]
    tmp3 = z1 + x[2] * k["c0765"]
    tmp0, tmp1 = (x[0] + x[4]) * 8192, (x[0] - x[4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * k["c1175"]
    t0, t1, t2, t3 = t0 * k["c0298"], t1 * k["c2053"], t2 * k["c3072"], t3 * k["c1501"]
    z1, z2 = -z1 * k["c0899"], -z2 * k["c2562"]
    z3, z4 = -z3 * k["c1961"] + z5, -z4 * k["c0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    out = [t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3]
    return torch.stack([(o + half) >> shift for o in out], dim=dim)


def _range_limit(x: torch.Tensor) -> torch.Tensor:
    """libjpeg's IDCT range-limit table: ``x & 1023`` as a signed 10-bit
    value, plus the level shift of 128, clamped to 0-255."""
    v = x & 1023
    v = torch.where(v < 512, v, v - 1024)
    return (v + 128).clamp(0, 255).to(torch.uint8)


def jpeg_idct_plain(coefs: torch.Tensor, qt, lay: codec.Layout) -> torch.Tensor:
    """K6a's plain version: the planes (uint8, :class:`Layout`'s
    ``plane_bytes``) of the needed components' blocks of ``coefs`` (int16
    ``[blocks, 64]``) under the int32 ``[3, 64]`` tables ``qt``."""
    dev = coefs.device
    q = torch.as_tensor(np.asarray(qt), dtype=torch.int64, device=dev)
    planes = []
    for c in range(lay.ncomp):
        n = lay.bw[c] * lay.bh[c]
        blk = coefs[lay.block_off[c]:lay.block_off[c] + n].to(torch.int64) * q[c]
        ws = _idct_pass(blk.view(n, 8, 8), 1, 11)
        px = _range_limit(_idct_pass(ws, 2, 18))
        planes.append(px.view(lay.bh[c], lay.bw[c], 8, 8).permute(0, 2, 1, 3).reshape(-1))
    return torch.cat(planes)


def check_args(coefs: torch.Tensor, lay: codec.Layout) -> None:
    if coefs.device.type != "cuda":
        raise ValueError(f"jpeg_idct: unsupported device {coefs.device}")
    if coefs.dtype != torch.int16 or coefs.dim() != 2 or coefs.shape[1] != 64:
        raise ValueError(f"jpeg_idct: coefs must be int16 [blocks, 64], got {coefs.dtype} "
                         f"{tuple(coefs.shape)}")
    if not coefs.is_contiguous() or coefs.data_ptr() % 16 or coefs.shape[0] < lay.blocks:
        raise ValueError("jpeg_idct: coefs must be contiguous, 16-byte aligned, with every "
                         "block of the layout")


def jpeg_idct(coefs: torch.Tensor, qt, lay: codec.Layout) -> torch.Tensor:
    """K6a. CUDA tensor: one launch on the current stream (raises on what it
    does not take); CPU tensor: :func:`jpeg_idct_plain`."""
    if coefs.device.type == "cpu":
        return jpeg_idct_plain(coefs, qt, lay)
    check_args(coefs, lay)
    planes = torch.empty(lay.plane_bytes, dtype=torch.uint8, device=coefs.device)
    q = np.ascontiguousarray(qt, np.int32)
    p = _params(lay)
    with torch.cuda.device(coefs.device):
        stream = torch.cuda.current_stream(coefs.device).cuda_stream
        rc = _library().jpeg_idct(coefs.data_ptr(), planes.data_ptr(), p.ctypes.data,
                                  q.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"jpeg_idct kernel launch failed: CUDA error {rc}")
    with _count_lock:
        jpeg_idct.launches += 1
    return planes


# ------------------------------------------------ K6b: upsampling and colour
def _sample(planes: torch.Tensor, lay: codec.Layout, c: int) -> torch.Tensor:
    """Component ``c`` at full size ``[H, W]`` (int64), upsampled as
    libjpeg-turbo's jdsample.c does (edges repeated at its width/height)."""
    dev = planes.device
    pitch, cw, ch, up = lay.bw[c] * 8, lay.cw[c], lay.ch[c], lay.up[c]
    n = lay.bh[c] * 8 * pitch
    p = planes[lay.plane_off[c]:lay.plane_off[c] + n].view(-1, pitch).to(torch.int64)
    ys = torch.arange(lay.height, device=dev)
    xs = torch.arange(lay.width, device=dev)
    oy, ox = ys & 1, xs & 1
    r, cc = ys >> 1, xs >> 1
    rn = torch.where(oy == 1, (r + 1).clamp(max=ch - 1), (r - 1).clamp(min=0))
    cn = torch.where(ox == 1, (cc + 1).clamp(max=cw - 1), (cc - 1).clamp(min=0))
    if up == codec.UP_COPY:
        return p[ys][:, xs]
    if up == codec.UP_H2V1:
        row = p[ys]
        return (3 * row[:, cc] + row[:, cn] + 1 + ox) >> 2
    if up == codec.UP_H1V2:
        return (3 * p[r][:, xs] + p[rn][:, xs] + 1 + oy[:, None]) >> 2
    if up == codec.UP_H2V2:
        near, far = p[r], p[rn]
        s0 = 3 * near[:, cc] + far[:, cc]
        s1 = 3 * near[:, cn] + far[:, cn]
        return (3 * s0 + s1 + 8 - ox) >> 4
    if up == codec.UP_H2V1_BOX:
        return p[ys][:, cc]
    return p[r][:, cc]  # UP_H2V2_BOX


def jpeg_color_plain(planes: torch.Tensor, lay: codec.Layout) -> torch.Tensor:
    """K6b's plain version: uint8 ``[H, W, 3]`` RGB or ``[H, W]`` grey from
    the planes of :func:`jpeg_idct_plain` (jdcolor.c's fixed point)."""
    v = [_sample(planes, lay, c) for c in range(lay.ncomp)]
    if lay.mode == codec.MODE_GRAY:
        return v[0].to(torch.uint8)
    if lay.mode == codec.MODE_RGB_GRAY:
        y = (codec.fix(0.299) * v[0] + codec.fix(0.587) * v[1] + codec.fix(0.114) * v[2] + 32768) >> 16
        return y.to(torch.uint8)
    if lay.mode == codec.MODE_YCC_RGB:
        cb, cr = v[1] - 128, v[2] - 128
        rgb = [v[0] + ((codec.fix(1.402) * cr + 32768) >> 16),
               v[0] + ((-codec.fix(0.34414) * cb + 32768 - codec.fix(0.71414) * cr) >> 16),
               v[0] + ((codec.fix(1.772) * cb + 32768) >> 16)]
    elif lay.mode == codec.MODE_RGB_RGB:
        rgb = v
    else:  # MODE_GRAY_RGB
        rgb = [v[0]] * 3
    return torch.stack(rgb, -1).clamp(0, 255).to(torch.uint8)


def jpeg_color(planes: torch.Tensor, lay: codec.Layout) -> torch.Tensor:
    """K6b. CUDA tensor: one launch on the current stream; CPU tensor:
    :func:`jpeg_color_plain`."""
    if planes.device.type == "cpu":
        return jpeg_color_plain(planes, lay)
    if planes.device.type != "cuda" or planes.dtype != torch.uint8 or \
            planes.numel() < lay.plane_bytes or not planes.is_contiguous():
        raise ValueError(f"jpeg_color: planes must be contiguous uint8 [{lay.plane_bytes}] "
                         f"on a card, got {planes.dtype} {tuple(planes.shape)} on "
                         f"{planes.device}")
    shape = (lay.height, lay.width) + ((3,) if lay.channels == 3 else ())
    out = torch.empty(shape, dtype=torch.uint8, device=planes.device)
    p = _params(lay)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = _library().jpeg_color(planes.data_ptr(), out.data_ptr(), p.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"jpeg_color kernel launch failed: CUDA error {rc}")
    with _count_lock:
        jpeg_color.launches += 1
    return out


_count_lock = threading.Lock()
jpeg_idct.launches = 0
jpeg_color.launches = 0
register_kernels({"K6a": jpeg_idct, "K6b": jpeg_color})


# ------------------------------------------------------------- card route
_streams = threading.local()


def _stream(dev: torch.device) -> torch.cuda.Stream:
    """The calling thread's own decode stream on ``dev``."""
    per = getattr(_streams, "by_device", None)
    if per is None:
        per = _streams.by_device = {}
    if dev.index not in per:
        per[dev.index] = torch.cuda.Stream(dev)
    return per[dev.index]


def decode_on_card(data: bytes, frame: codec.Frame, lay: codec.Layout, qt: np.ndarray,
                   dev: torch.device, times: Optional[dict] = None) -> np.ndarray:
    """The pixels of a parsed JPEG through the card: the C entropy decoder
    into pinned memory, then on this thread's decode stream the upload, K6a,
    K6b and the download into pinned memory; returns uint8 numpy ``[H, W, 3]``
    or ``[H, W]``. With ``times`` (a dict) it records the milliseconds of each
    part: ``entropy`` (host clock), ``upload``, ``kernels`` and ``download``
    (CUDA events on the stream)."""
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    coefs = entropy_decode(data, frame, pin=True)
    t_entropy = time.perf_counter() - t0
    stream = _stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    shape = (lay.height, lay.width) + ((3,) if lay.channels == 3 else ())
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    with torch.cuda.stream(stream):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if times is not None \
            else None
        if ev:
            ev[0].record(stream)
        dcoefs = coefs.to(dev, non_blocking=True)
        if ev:
            ev[1].record(stream)
        planes = jpeg_idct(dcoefs, qt, lay)
        out = jpeg_color(planes, lay)
        if ev:
            ev[2].record(stream)
        host.copy_(out, non_blocking=True)
        if ev:
            ev[3].record(stream)
    stream.synchronize()
    if times is not None:
        times["entropy"] = t_entropy * 1e3
        times["upload"] = ev[0].elapsed_time(ev[1])
        times["kernels"] = ev[1].elapsed_time(ev[2])
        times["download"] = ev[2].elapsed_time(ev[3])
    return host.numpy()


def decode_jpeg(data: bytes, gray: bool = False, device="cuda") -> np.ndarray:
    """The JPEG in ``data`` as uint8 ``[H, W, 3]`` RGB, or ``[H, W]`` with
    ``gray``, equal to ``cv2.imread`` (+ BGR->RGB) of the same file.

    ``device`` "cuda" (or a CUDA device): the C entropy decoder and K6's
    kernels on that card; raises where there is none. "cpu": the Python
    entropy decoder and K6's plain version."""
    frame = codec.parse(data)
    dev = torch.device(device)
    lay = codec.layout(frame, gray)
    qt = codec.quant_tables(frame)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("decode_jpeg: no CUDA device; pass device='cpu' to decode on "
                               "the CPU")
        img = decode_on_card(data, frame, lay, qt, dev)
    else:
        coefs = torch.from_numpy(codec.entropy_decode_py(data, frame))
        planes = jpeg_idct(coefs, torch.from_numpy(qt), lay)
        img = jpeg_color(planes, lay).numpy()
    return codec.orient(img, frame.orientation)


def read_jpeg(path, gray: bool = False, device="cuda") -> np.ndarray:
    """:func:`decode_jpeg` of the file at ``path``."""
    return decode_jpeg(Path(path).read_bytes(), gray=gray, device=device)
