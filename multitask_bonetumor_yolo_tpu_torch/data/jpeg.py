"""Baseline JPEG: a reader bit for bit with ``cv2.imread`` and a writer that
follows ``cv2.imwrite``'s defaults, in numpy, torch and the standard library
(the card's machine has neither cv2 nor PIL).

Reading (``ops/kernels/jpeg.py::read_jpeg`` and ``decode_jpeg``, which
route a file parsed here to the card or the CPU) takes every file that
libjpeg-turbo decodes in the sequential Huffman modes: SOF0 and SOF1 at 8
bits, 1 or 3 components with sampling factors up to 2x2, any number of DQT
and DHT tables and scans, DRI / RST restart intervals, the Adobe APP14
marker (transform 0: RGB). It reproduces libjpeg-turbo's default decode as
cv2 asks for it: the ``JDCT_ISLOW`` inverse DCT, "fancy" upsampling and the
fixed-point YCbCr->RGB conversion; a grey read of a colour file is its Y
plane (libjpeg's ``JCS_GRAYSCALE`` output, as cv2 reads it), a grey read of
an RGB file libjpeg's ``rgb_gray_convert``; the Exif orientation tag (1-8)
is applied as ``cv2.imread`` applies it. Anything else (progressive,
lossless, arithmetic-coded, hierarchical, 12-bit, 2- or 4-component files, a
truncated or corrupt scan) raises a ``ValueError`` that names it.

The work is split as libjpeg splits it. This module parses the markers
(:func:`parse`) and lays out the coefficients (:class:`Layout`); the entropy
decode is serial, so it runs on the host: :func:`entropy_decode_py` here
(the plain version), or the C decoder of ``csrc/jpeg.cu`` on the card's
machine. Dequantisation, the IDCT, upsampling and colour conversion are
kernel K6 (``ops/kernels/jpeg.py``): on a card its two CUDA kernels, on the
CPU its plain integer torch version. ``device="cuda"`` (the default) takes
the C decoder and the kernels and raises where there is no card;
``device="cpu"`` takes the Python decoder and the plain version. This
module imports nothing of ``ops/``.

Writing (:func:`encode_jpeg`, :func:`write_jpeg`) follows ``cv2.imencode``
at its defaults: baseline, quality 95 by default, 4:2:0 for colour, the
fixed-point ``rgb_ycc_convert``, ``h2v2_downsample`` with its alternating
bias, libjpeg's edge padding and dummy blocks, the ``jfdctint`` forward DCT,
libjpeg-turbo's reciprocal quantisation, the standard Huffman tables and the
JFIF APP0 as libjpeg writes it; the Huffman coding is vectorised in numpy.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

# zigzag position k -> natural (row-major) index within the 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, i // 8 if (i // 8 + i % 8) % 2 else i % 8)), np.int64)

# the standard tables of the JPEG specification (K.1, K.3), natural order
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)
STD_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
STD_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
STD_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
STD_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# colour spaces of a frame, and what a read asks of K6 (ops/kernels/jpeg.py)
GRAY, YCC, RGB = "gray", "ycbcr", "rgb"
_UNSUPPORTED_SOF = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical progressive (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)", 0xCF: "arithmetic-coded hierarchical (SOF15)",
}


@dataclasses.dataclass
class Component:
    id: int
    h: int  # sampling factors
    v: int
    tq: int  # quantisation table slot
    width: int = 0  # samples (libjpeg's downsampled_width / _height)
    height: int = 0
    bw: int = 0  # the block grid held for it
    bh: int = 0
    qt: Optional[np.ndarray] = None  # int32 [64] natural order, latched at its first scan


@dataclasses.dataclass
class Scan:
    comps: Tuple[int, ...]  # frame component indices
    dc: Tuple[Tuple[bytes, bytes], ...]  # per scan component: (bits[16], values)
    ac: Tuple[Tuple[bytes, bytes], ...]
    restart: int  # MCUs per restart interval, 0 for none
    begin: int  # the entropy-coded bytes: data[begin:end]
    end: int


@dataclasses.dataclass
class Frame:
    height: int
    width: int
    comps: List[Component]
    scans: List[Scan]
    colorspace: str
    orientation: int  # Exif orientation, 1 when there is none
    hmax: int
    vmax: int

    @property
    def mcux(self) -> int:
        return -(-self.width // (8 * self.hmax))

    @property
    def mcuy(self) -> int:
        return -(-self.height // (8 * self.vmax))


def _fail(msg: str):
    raise ValueError(f"JPEG: {msg}")


def _exif_orientation(body: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of an APP1 Exif body, else 1."""
    t = body[6:]
    if t[:2] not in (b"II", b"MM") or len(t) < 8:
        return 1
    e = "<" if t[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(e + "I", t[4:8])
        (n,) = struct.unpack(e + "H", t[ifd:ifd + 2])
        for i in range(n):
            ent = t[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, typ, _ = struct.unpack(e + "HHI", ent[:8])
            if tag == 0x0112 and typ == 3:
                (val,) = struct.unpack(e + "H", ent[8:10])
                return val if 1 <= val <= 8 else 1
    except struct.error:
        return 1
    return 1


def _scan_end(arr: np.ndarray, start: int) -> int:
    """Offset of the first marker at or after ``start`` that ends a scan: an
    0xFF followed by neither 0x00 (stuffing) nor RST0-7; ``len`` if none."""
    a = arr[start:]
    ff = np.flatnonzero(a[:-1] == 0xFF)
    nxt = a[ff + 1]
    stop = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    if not len(stop):
        return len(arr)
    end = start + int(stop[0])
    while end > start and arr[end - 1] == 0xFF:  # fill bytes belong to the marker
        end -= 1
    return end


def parse(data: bytes) -> Frame:
    """The markers of a JPEG file: frame, tables, scans (with the offsets of
    their entropy-coded bytes), colour space and Exif orientation."""
    if data[:2] != b"\xff\xd8":
        _fail("not a JPEG file (no SOI marker)")
    arr = np.frombuffer(data, np.uint8)
    qts: dict = {}
    dcs: dict = {}
    acs: dict = {}
    restart = 0
    frame = None
    scans: List[Scan] = []
    jfif = adobe = False
    transform = 1
    orientation = 1
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1  # garbage between markers, which libjpeg skips with a warning
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            _fail("truncated file (marker segment)")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            _fail(f"truncated file (marker 0x{m:02X} segment)")
        pos += length
        if m in _UNSUPPORTED_SOF:
            _fail(f"{_UNSUPPORTED_SOF[m]} JPEG is not read; only baseline and extended "
                  "sequential Huffman (SOF0, SOF1)")
        if m == 0xCC:
            _fail("arithmetic-coded JPEG (DAC marker) is not read")
        if m == 0xDC:
            _fail("DNL marker is not read")
        if m in (0xC0, 0xC1):
            prec, h, w, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                _fail(f"{prec}-bit samples are not read; only 8-bit")
            if nf not in (1, 3):
                what = "4-component (CMYK / YCCK)" if nf == 4 else f"{nf}-component"
                _fail(f"{what} JPEG is not read; only 1 (grey) or 3 components")
            if h == 0 or w == 0:
                _fail("image height or width 0 (DNL) is not read")
            comps = []
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                hs, vs = hv >> 4, hv & 15
                if not (1 <= hs <= 2 and 1 <= vs <= 2):
                    _fail(f"sampling factors {hs}x{vs}: only factors up to 2x2 are read")
                if tq > 3:
                    _fail(f"quantisation table {tq}")
                comps.append(Component(cid, hs, vs, tq))
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if nf == 1:  # one component is always one block per MCU
                comps[0].h = comps[0].v = hmax = vmax = 1
            frame = Frame(h, w, comps, scans, YCC, 1, hmax, vmax)
            for c in comps:
                c.width = -(-w * c.h // hmax)
                c.height = -(-h * c.v // vmax)
                if nf == 1:
                    c.bw, c.bh = -(-c.width // 8), -(-c.height // 8)
                else:
                    c.bw, c.bh = frame.mcux * c.h, frame.mcuy * c.v
        elif m == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                bits = body[p + 1:p + 17]
                nv = sum(bits)
                vals = body[p + 17:p + 17 + nv]
                if tc > 1 or th > 3 or len(bits) != 16 or len(vals) != nv or nv > 256:
                    _fail("bad DHT marker")
                (acs if tc else dcs)[th] = (bytes(bits), bytes(vals))
                p += 17 + nv
        elif m == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                size = 128 if pq else 64
                raw = body[p + 1:p + 1 + size]
                if tq > 3 or len(raw) != size:
                    _fail("bad DQT marker")
                zz = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int32)
                q = np.zeros(64, np.int32)
                q[ZIGZAG] = zz
                qts[tq] = q
                p += 1 + size
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xDA:
            if frame is None:
                _fail("SOS before SOF")
            ns = body[0] if body else 0
            if not 1 <= ns <= len(frame.comps):
                _fail(f"scan of {ns} components in a frame of {len(frame.comps)}")
            if len(body) != 4 + 2 * ns:
                _fail("bad SOS marker")
            ids = {c.id: i for i, c in enumerate(frame.comps)}
            cidx, dc, ac = [], [], []
            for i in range(ns):
                cid, t = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in ids:
                    _fail(f"scan names component {cid}, which the frame lacks")
                ci = ids[cid]
                if ci in cidx:
                    _fail(f"scan names component {cid} twice")
                if t >> 4 not in dcs or t & 15 not in acs:
                    _fail("scan uses a Huffman table that was not defined")
                if frame.comps[ci].qt is None:
                    if frame.comps[ci].tq not in qts:
                        _fail(f"quantisation table {frame.comps[ci].tq} was not defined")
                    frame.comps[ci].qt = qts[frame.comps[ci].tq].copy()
                cidx.append(ci)
                dc.append(dcs[t >> 4])
                ac.append(acs[t & 15])
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahl != 0:
                _fail("spectral selection / successive approximation in a sequential scan")
            if ns > 1 and sum(frame.comps[i].h * frame.comps[i].v for i in cidx) > 10:
                _fail("more than 10 blocks per MCU")
            end = _scan_end(arr, pos)
            scans.append(Scan(tuple(cidx), tuple(dc), tuple(ac), restart, pos, end))
            pos = end
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xE1 and body[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(body)
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, transform = True, body[11]
    if frame is None or not scans:
        _fail("no frame or no scan (truncated file?)")
    missing = [c.id for i, c in enumerate(frame.comps) if not any(i in s.comps for s in scans)]
    if missing:
        _fail(f"components {missing} are in no scan (truncated file?)")
    if len(frame.comps) == 1:
        frame.colorspace = GRAY
    elif jfif:
        frame.colorspace = YCC
    elif adobe:
        frame.colorspace = RGB if transform == 0 else YCC
    else:  # libjpeg's guess from the component ids
        frame.colorspace = RGB if [c.id for c in frame.comps] == [82, 71, 66] else YCC
    frame.orientation = orientation
    return frame


# --------------------------------------------------------------------- layout
@dataclasses.dataclass(frozen=True)
class Layout:
    """Where K6 finds each component: the coefficient buffer holds every
    component's ``[bh, bw, 64]`` blocks one after the other (block offset
    ``block_off``), the plane buffer their ``[bh*8, bw*8]`` uint8 planes
    (byte offset ``plane_off``). ``up`` is each component's upsampling
    (``UP_*``), ``mode`` the colour conversion of the read
    (:data:`MODES`), ``ncomp`` the components that the read needs (the IDCT
    runs over their blocks only)."""

    height: int
    width: int
    mode: int
    ncomp: int
    block_off: Tuple[int, ...]
    bw: Tuple[int, ...]
    bh: Tuple[int, ...]
    plane_off: Tuple[int, ...]
    cw: Tuple[int, ...]
    ch: Tuple[int, ...]
    up: Tuple[int, ...]
    blocks: int  # blocks of the needed components
    plane_bytes: int

    @property
    def channels(self) -> int:
        return 1 if self.mode in (MODE_GRAY, MODE_RGB_GRAY) else 3


# upsampling per component (libjpeg-turbo's jdsample.c): copy, h2v1 / h1v2 /
# h2v2 fancy, h2v1 / h2v2 box (fancy needs a width above 2)
UP_COPY, UP_H2V1, UP_H1V2, UP_H2V2, UP_H2V1_BOX, UP_H2V2_BOX = range(6)
# colour conversions (jdcolor.c): YCbCr->RGB, RGB->RGB, grey->RGB (repeated),
# one plane as grey (a grey file, or a colour file's Y), RGB->grey
MODE_YCC_RGB, MODE_RGB_RGB, MODE_GRAY_RGB, MODE_GRAY, MODE_RGB_GRAY = range(5)


def layout(frame: Frame, gray: bool) -> Layout:
    if frame.colorspace == GRAY:
        mode = MODE_GRAY if gray else MODE_GRAY_RGB
    elif frame.colorspace == YCC:
        mode = MODE_GRAY if gray else MODE_YCC_RGB
    else:
        mode = MODE_RGB_GRAY if gray else MODE_RGB_RGB
    ncomp = 1 if mode == MODE_GRAY else len(frame.comps)
    boff, poff, up = [], [], []
    b = p = 0
    for c in frame.comps:
        boff.append(b)
        poff.append(p)
        b += c.bw * c.bh
        p += c.bw * c.bh * 64
        fh, fv = frame.hmax // c.h, frame.vmax // c.v
        if (fh, fv) == (1, 1):
            up.append(UP_COPY)
        elif (fh, fv) == (1, 2):
            up.append(UP_H1V2)
        elif (fh, fv) == (2, 1):
            up.append(UP_H2V1 if c.width > 2 else UP_H2V1_BOX)
        else:
            up.append(UP_H2V2 if c.width > 2 else UP_H2V2_BOX)
    comps = frame.comps
    return Layout(frame.height, frame.width, mode, ncomp, tuple(boff), tuple(c.bw for c in comps),
                  tuple(c.bh for c in comps), tuple(poff), tuple(c.width for c in comps),
                  tuple(c.height for c in comps), tuple(up), boff[ncomp - 1] + comps[ncomp - 1].bw
                  * comps[ncomp - 1].bh, poff[ncomp - 1] + comps[ncomp - 1].bw
                  * comps[ncomp - 1].bh * 64)


def quant_tables(frame: Frame) -> np.ndarray:
    """int32 ``[3, 64]``: each component's table, natural order (zeros for
    absent components)."""
    q = np.zeros((3, 64), np.int32)
    for i, c in enumerate(frame.comps):
        q[i] = c.qt
    return q


# ---------------------------------------------------------- entropy (Python)
def _lookup(table: Tuple[bytes, bytes]):
    """Code length and symbol per 16-bit lookahead (length 0: no code)."""
    bits, vals = table
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            if code >= (1 << ln):
                _fail("bad Huffman table")
            lo, hi = code << (16 - ln), (code + 1) << (16 - ln)
            length[lo:hi] = ln
            sym[lo:hi] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return length.tolist(), sym.tolist()


def _segments(data: bytes, scan: Scan) -> List[np.ndarray]:
    """The scan's entropy-coded bytes split at its RST markers, each segment
    with its 0xFF00 stuffing removed."""
    a = np.frombuffer(data, np.uint8)[scan.begin:scan.end]
    ff = np.flatnonzero(a[:-1] == 0xFF)
    nxt = a[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    cuts = [0] + [int(r) for r in rst] + [len(a)]
    segs = []
    for i in range(len(cuts) - 1):
        s = a[cuts[i] + (2 if i else 0):cuts[i + 1]]
        stuffed = np.flatnonzero((s[:-1] == 0xFF) & (s[1:] == 0)) + 1
        segs.append(np.delete(s, stuffed))
    return segs


def _scan_blocks(frame: Frame, scan: Scan):
    """The scan's blocks in coding order as (scan component, block row,
    block column), and the MCUs it holds."""
    if len(scan.comps) == 1:
        c = frame.comps[scan.comps[0]]
        nbx, nby = -(-c.width // 8), -(-c.height // 8)
        return [[(0, by, bx)] for by in range(nby) for bx in range(nbx)]
    mcus = []
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            mcu = []
            for s, ci in enumerate(scan.comps):
                c = frame.comps[ci]
                for v in range(c.v):
                    for h in range(c.h):
                        mcu.append((s, my * c.v + v, mx * c.h + h))
            mcus.append(mcu)
    return mcus


def _decode_scan_py(data: bytes, frame: Frame, scan: Scan, outs: List[list],
                    bws: List[int]) -> None:
    nat = ZIGZAG.tolist() + [63] * 16
    dc = [_lookup(t) for t in scan.dc]
    ac = [_lookup(t) for t in scan.ac]
    segs = _segments(data, scan)
    mcus = _scan_blocks(frame, scan)
    per = scan.restart or len(mcus)
    if len(segs) < -(-len(mcus) // per):
        _fail("truncated scan (fewer restart intervals than MCUs need)")
    mask = [(1 << s) - 1 for s in range(17)]
    for iv in range(-(-len(mcus) // per)):
        seg = segs[iv]
        nbits = 8 * len(seg)
        padded = np.concatenate([seg, np.full(8, 0xFF, np.uint8)]).astype(np.uint32)
        W = ((padded[:-3] << 24) | (padded[1:-2] << 16) | (padded[2:-1] << 8)
             | padded[3:]).tolist()
        p = 0
        pred = [0] * len(scan.comps)
        for mcu in mcus[iv * per:(iv + 1) * per]:
            for s, by, bx in mcu:
                out = outs[s]
                base = (by * bws[s] + bx) * 64
                dl, ds = dc[s]
                look = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
                ln = dl[look]
                if ln == 0:
                    _fail("corrupt or truncated scan (no Huffman code matches)")
                t = ds[look]
                p += ln
                if t > 16:
                    _fail("corrupt scan (a DC difference of more than 16 bits)")
                if t:
                    v = (W[p >> 3] >> (32 - (p & 7) - t)) & mask[t]
                    p += t
                    if v <= mask[t - 1]:
                        v -= mask[t]
                    pred[s] += v
                out[base] = pred[s]
                al, as_ = ac[s]
                k = 1
                while k < 64:
                    look = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
                    ln = al[look]
                    if ln == 0:
                        _fail("corrupt or truncated scan (no Huffman code matches)")
                    rs = as_[look]
                    p += ln
                    r, t = rs >> 4, rs & 15
                    if t:
                        k += r
                        v = (W[p >> 3] >> (32 - (p & 7) - t)) & mask[t]
                        p += t
                        if v <= mask[t - 1]:
                            v -= mask[t]
                        out[base + nat[k]] = v
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            if p > nbits:
                _fail("truncated scan (the entropy-coded data ends early)")


def entropy_decode_py(data: bytes, frame: Frame) -> np.ndarray:
    """The plain entropy decoder: int16 ``[blocks, 64]`` coefficients in
    natural order, every component's ``[bh, bw]`` block grid one after the
    other (:class:`Layout`), blocks that no scan codes left 0."""
    outs = [[0] * (c.bw * c.bh * 64) for c in frame.comps]
    for scan in frame.scans:
        _decode_scan_py(data, frame, scan, [outs[i] for i in scan.comps],
                        [frame.comps[i].bw for i in scan.comps])
    flat = np.concatenate([np.asarray(o, np.int64) for o in outs])
    return flat.astype(np.int16).reshape(-1, 64)


# ------------------------------------------------------------------ decoding
def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` as ``cv2.imread`` turns it for an Exif orientation (1-8)."""
    if orientation == 1:
        return img
    if orientation >= 5:
        img = np.swapaxes(img, 0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def is_jpeg(path) -> bool:
    with open(path, "rb") as f:
        return f.read(3) == b"\xff\xd8\xff"


# ------------------------------------------------------------------ encoding
SCALEBITS = 16


def fix(x: float) -> int:
    """libjpeg's ``FIX(x)`` at ``SCALEBITS`` (jccolor.c, jdcolor.c)."""
    return int(x * (1 << SCALEBITS) + 0.5)


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)`` tables,
    natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMA_Q, STD_CHROMA_Q))


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c's ``rgb_ycc_convert``: uint8 ``[H, W, 3]`` -> int64 Y, Cb, Cr
    planes ``[3, H, W]``."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << (SCALEBITS - 1), 128 << SCALEBITS
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> SCALEBITS
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> SCALEBITS
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> SCALEBITS
    return np.stack([y, cb, cr])


def _pad_edge(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def _h2v2_downsample(a: np.ndarray) -> np.ndarray:
    """jcsample.c's ``h2v2_downsample`` of an even-sized plane: the sum of
    each 2x2 plus a bias of 1, 2, 1, 2, ... along each output row, >> 2."""
    s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias) >> 2


# jfdctint.c's and jidctint.c's constants: FIX(x) at CONST_BITS 13
ISLOW = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
             c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)


def _fdct_pass(d: np.ndarray, axis: int, first: bool) -> np.ndarray:
    """One pass of jfdctint.c's ``jpeg_fdct_islow`` along ``axis`` (rows
    first, then columns) of int64 blocks ``[..., 8, 8]``."""
    k = ISLOW
    x = [np.take(d, i, axis=axis) for i in range(8)]
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    cb = 11 if first else 15  # CONST_BITS - PASS1_BITS, CONST_BITS + PASS1_BITS

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
    else:
        out[0], out[4] = descale(t10 + t11, 2), descale(t10 - t11, 2)
    z1 = (t12 + t13) * k["c0541"]
    out[2] = descale(z1 + t13 * k["c0765"], cb)
    out[6] = descale(z1 - t12 * k["c1847"], cb)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * k["c1175"]
    t4, t5, t6, t7 = t4 * k["c0298"], t5 * k["c2053"], t6 * k["c3072"], t7 * k["c1501"]
    z1, z2 = -z1 * k["c0899"], -z2 * k["c2562"]
    z3, z4 = -z3 * k["c1961"] + z5, -z4 * k["c0390"] + z5
    out[7] = descale(t4 + z1 + z3, cb)
    out[5] = descale(t5 + z2 + z4, cb)
    out[3] = descale(t6 + z2 + z3, cb)
    out[1] = descale(t7 + z1 + z4, cb)
    return np.stack(out, axis=axis)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_fdct_islow`` of int64 level-shifted samples ``[N, 8, 8]``
    (outputs scaled up by 8, as libjpeg leaves them)."""
    return _fdct_pass(_fdct_pass(blocks, 2, True), 1, False)


def quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantisation (jcdctmgr.c, 16-bit DCT elements as its
    SIMD build uses): each divisor ``8 q`` as a reciprocal, a correction and a
    shift (``compute_reciprocal``), |x| + c times the reciprocal, shifted."""
    div = (q.astype(np.int64) << 3)
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // div, (1 << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    r = np.where(pow2, r - 1, r)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[bh*8, bw*8] -> [bh, bw, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _huff_codes(table):
    """Canonical (code, length) per symbol of a (bits, values) table."""
    bits, vals = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, ln
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _bit_size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category)."""
    a = np.abs(v)
    size = np.zeros(a.shape, np.int64)
    while (a > 0).any():
        size += a > 0
        a = a >> 1
    return size


def _huffman_encode(zz: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Entropy-code quantised blocks ``zz`` [N, 64] (zigzag order, coding
    order) whose components are ``comp`` [N]; ``tables[c]`` = (DC, AC)
    (code, length) arrays. Returns the stuffed scan bytes."""
    n = len(zz)
    dc = zz[:, 0].copy()
    diff = dc.copy()
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx[1:]] = dc[idx[1:]] - dc[idx[:-1]]
    dsize = _bit_size(diff)
    dc_code = np.stack([tables[c][0][0] for c in range(len(tables))])[comp, dsize]
    dc_len = np.stack([tables[c][0][1] for c in range(len(tables))])[comp, dsize]
    dbits = np.where(diff < 0, diff + (1 << dsize) - 1, diff) & ((1 << dsize) - 1)
    keys = [np.arange(n) * 256]
    vals = [(dc_code << dsize) | dbits]
    lens = [dc_len + dsize]

    ac = zz[:, 1:]
    bi, ki = np.nonzero(ac)  # row-major: blocks in order, positions ascending
    k = ki + 1
    v = ac[bi, ki]
    prev = np.zeros_like(k)
    same = np.zeros(len(k), bool)
    same[1:] = bi[1:] == bi[:-1]
    prev[same] = k[:-1][same[1:]]
    run = k - prev - 1
    size = _bit_size(v)
    ac_code = np.stack([tables[c][1][0] for c in range(len(tables))])
    ac_len = np.stack([tables[c][1][1] for c in range(len(tables))])
    cb = comp[bi]
    nzrl = run >> 4
    sym = ((run & 15) << 4) | size
    vbits = np.where(v < 0, v + (1 << size) - 1, v) & ((1 << size) - 1)
    keys.append(bi * 256 + 2 * k + 1)
    vals.append((ac_code[cb, sym] << size) | vbits)
    lens.append(ac_len[cb, sym] + size)
    for j in range(1, 4):  # up to three ZRLs (runs of 16 zeros) before a coefficient
        z = nzrl >= j
        keys.append(bi[z] * 256 + 2 * k[z] - 4 + j)  # before the coefficient, in order
        vals.append(ac_code[cb[z], 0xF0])
        lens.append(ac_len[cb[z], 0xF0])
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)  # the last nonzero position per block
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 256 + 255)
    vals.append(ac_code[comp[eob], 0])
    lens.append(ac_len[comp[eob], 0])

    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order].astype(np.int64)
    ln = np.concatenate(lens)[order].astype(np.int64)
    total = int(ln.sum())
    nbytes = -(-total // 8)
    off = np.cumsum(ln) - ln
    bits = np.ones(nbytes * 8, np.uint8)  # the final byte is padded with ones
    for j in range(int(ln.max(initial=0))):
        m = ln > j
        bits[off[m] + j] = (val[m] >> (ln[m] - 1 - j)) & 1
    out = np.packbits(bits)
    ff = out == 0xFF
    stuffed = np.repeat(out, 1 + ff)
    stuffed[np.flatnonzero(ff) + np.arange(1, ff.sum() + 1)] = 0
    return stuffed.tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


SAMPLINGS = {"444": (1, 1), "422": (2, 1), "440": (1, 2), "420": (2, 2)}  # luma h, v


def _downsample(a: np.ndarray, fh: int, fv: int, bw: int) -> np.ndarray:
    """jcsample.c for a component ``fh`` x ``fv`` times smaller than the
    full-size plane ``a`` (its rows already a multiple of ``fv``), the
    columns first repeated out to ``bw`` blocks: ``fullsize_downsample``,
    ``h2v1_downsample`` (bias 0, 1, 0, 1, ...), ``h2v2_downsample`` or
    ``int_downsample`` (rounded division) for 1x2."""
    a = _pad_edge(a, a.shape[0], bw * 8 * fh)
    if (fh, fv) == (1, 1):
        return a
    if (fh, fv) == (2, 2):
        return _h2v2_downsample(a)
    if (fh, fv) == (2, 1):
        return (a[:, 0::2] + a[:, 1::2] + (np.arange(a.shape[1] // 2) & 1)) >> 1
    return (a[0::2] + a[1::2] + 1) // 2


def encode_jpeg(img: np.ndarray, quality: int = 95, sampling: str = "420",
                restart: int = 0) -> bytes:
    """uint8 ``[H, W, 3]`` RGB or ``[H, W]`` grey as the bytes that
    ``cv2.imencode(".jpeg", ...)`` writes at ``IMWRITE_JPEG_QUALITY``
    ``quality`` (default 95, cv2's); colour at ``sampling`` "420" (cv2's
    default), "422", "440" or "444" (``IMWRITE_JPEG_SAMPLING_FACTOR``), a
    restart marker every ``restart`` MCUs (``IMWRITE_JPEG_RST_INTERVAL``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"encode_jpeg: {h}x{w} is outside JPEG's 1-65535")
    q_luma, q_chroma = quality_tables(quality)
    color = img.ndim == 3
    if color:
        planes = rgb_to_ycc(img)
        samp = (SAMPLINGS[sampling], (1, 1), (1, 1))
    else:
        planes = img.astype(np.int64)[None]
        samp = ((1, 1),)
    hmax, vmax = samp[0]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    hg = -(-h // vmax) * vmax  # full-size rows padded to the row group
    grids = []
    for ci, (hs, vs) in enumerate(samp):
        cw, chh = -(-w * hs // hmax), -(-h * vs // vmax)
        bw, bh = -(-cw // 8), -(-chh // 8)
        p = _downsample(_pad_edge(planes[ci], hg, w), hmax // hs, vmax // vs, bw)[:chh]
        p = _pad_edge(p, bh * 8, bw * 8)
        q = q_luma if ci == 0 else q_chroma
        coef = quantize(fdct_islow(_blocks(p - 128).reshape(-1, 8, 8)),
                        q.reshape(1, 8, 8)).reshape(bh, bw, 64)
        # the MCU grid: dummy blocks right (the left neighbour's DC) and below
        # (the DC of the block before them in the MCU), as jccoefct.c makes them
        gw, gh = mcux * hs, mcuy * vs
        full = np.zeros((gh, gw, 64), np.int64)
        full[:bh, :bw] = coef
        for x in range(bw, gw):
            full[:bh, x, 0] = full[:bh, x - 1, 0]
        for y in range(bh, gh):
            for x in range(gw):
                full[y, x, 0] = full[y - 1, (x // hs) * hs + hs - 1, 0]
        grids.append(full)
    # coding order: MCU by MCU, each component's v x h blocks
    zz_list, comp_list = [], []
    for ci, (hs, vs) in enumerate(samp):
        g = grids[ci].reshape(mcuy, vs, mcux, hs, 64).transpose(0, 2, 1, 3, 4)
        zz_list.append(g.reshape(mcuy * mcux, vs * hs, 64))
        comp_list.append(np.full((mcuy * mcux, vs * hs), ci))
    zz = np.concatenate(zz_list, axis=1)[..., ZIGZAG]  # [MCUs, blocks per MCU, 64]
    comp = np.concatenate(comp_list, axis=1)
    huff = [(STD_DC_LUMA, STD_AC_LUMA)] + ([(STD_DC_CHROMA, STD_AC_CHROMA)] if color else [])
    codes = [(_huff_codes(d), _huff_codes(a)) for d, a in huff]
    tables = [codes[min(ci, 1)] for ci in range(len(samp))]
    per = restart or len(zz)
    parts = []
    for i, s0 in enumerate(range(0, len(zz), per)):
        if i:
            parts.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        parts.append(_huffman_encode(zz[s0:s0 + per].reshape(-1, 64),
                                     comp[s0:s0 + per].reshape(-1), tables))

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate((q_luma, q_chroma)[:len(huff)]):
        out.append(_segment(0xDB, bytes([t]) + q[ZIGZAG].astype(np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, h, w, len(samp))
    for ci, (hs, vs) in enumerate(samp):
        sof += bytes([ci + 1, (hs << 4) | vs, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    for t, (dct, act) in enumerate(huff):
        out.append(_segment(0xC4, bytes([t]) + dct[0] + dct[1]))
        out.append(_segment(0xC4, bytes([0x10 | t]) + act[0] + act[1]))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    sos = bytes([len(samp)])
    for ci in range(len(samp)):
        sos += bytes([ci + 1, 0x11 * min(ci, 1)])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out += parts
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """Write uint8 ``[H, W, 3]`` RGB or ``[H, W]`` grey as a baseline JPEG
    (:func:`encode_jpeg`): the counterpart of ``cv2.imwrite(path, bgr)``."""
    Path(path).write_bytes(encode_jpeg(img, quality))
