"""The port's JPEG codec (``data/jpeg.py``, and K6's plain version in
``ops/kernels/jpeg.py``) against cv2 and PIL on the CPU.

Fixtures are made here from seeded numpy arrays at odd sizes (37x53, 64x48,
129x97): files written by ``cv2.imencode`` at quality 50 / 75 / 95 in every
sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0), with its own Huffman tables
(``IMWRITE_JPEG_OPTIMIZE``) and with restart intervals, grey files, files
that PIL wrote (an RGB one with the Adobe marker among them), and Exif
orientation tags spliced into APP1. The decoder must equal ``cv2.imread``
bit for bit in colour and grey reads; the writer must write the bytes of
``cv2.imencode``.
"""

import io
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from multitask_bonetumor_yolo_tpu_torch.data import imageio, jpeg
from multitask_bonetumor_yolo_tpu_torch.ops.kernels.jpeg import decode_jpeg, read_jpeg
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SIZES = ((37, 53), (64, 48), (129, 97))
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def make_image(h, w, seed=0):
    """A smooth colour gradient with noise: every quality keeps some AC."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
    img = np.stack([base, base[::-1], np.roll(base, 5, 1)], -1) + rs.randint(0, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_read(data, gray=False):
    """``cv2.imread`` of the bytes (RGB for a colour read)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    assert img is not None
    return img if gray else img[..., ::-1]


def assert_reads_like_cv2(data, what):
    for gray in (False, True):
        got = decode_jpeg(data, gray=gray, device="cpu")
        want = cv2_read(data, gray)
        assert got.dtype == np.uint8 and got.shape == want.shape, (what, gray)
        assert np.array_equal(got, want), (what, gray, int(np.abs(got.astype(int) - want).max()))


def with_exif(data, orientation):
    """``data`` with an APP1 Exif segment (little-endian TIFF, IFD0 holding
    the orientation tag) spliced in after SOI."""
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def test_cv2_files_read_bit_for_bit():
    """cv2-written files at three sizes, quality 50/75/95 in every sampling,
    plus optimised Huffman tables and restart intervals (every 3 MCUs):
    colour and grey reads (a colour file's grey read is its Y plane) equal
    ``cv2.imread``."""
    for h, w in SIZES:
        img = make_image(h, w, seed=h)
        for q in (50, 75, 95):
            for name, samp in SAMPLING.items():
                params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp]
                for extra in ([], [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                              [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]):
                    data = cv2.imencode(".jpeg", img, params + extra)[1].tobytes()
                    assert_reads_like_cv2(data, (h, w, q, name, extra))


def test_grey_and_pil_files_read_bit_for_bit():
    """Grey files (cv2, PIL), PIL's colour files (4:2:0 and 4:2:2) and its
    RGB file (``keep_rgb``: APP14 Adobe, transform 0, no colour conversion)
    read as cv2 reads them; the grey read of a colour file differs from the
    RGB->grey formula that the PNG codec applies."""
    for h, w in SIZES:
        img = make_image(h, w, seed=w)
        assert_reads_like_cv2(cv2.imencode(".jpeg", img[..., 0])[1].tobytes(), "cv2 grey")
        for mode, kw in (("L", {}), ("RGB", {}), ("RGB", {"quality": 80, "subsampling": 1}),
                         ("RGB", {"keep_rgb": True})):
            bio = io.BytesIO()
            Image.fromarray(img if mode == "RGB" else img[..., 0]).save(bio, "JPEG", **kw)
            data = bio.getvalue()
            if kw.get("keep_rgb"):
                assert jpeg.parse(data).colorspace == jpeg.RGB
            assert_reads_like_cv2(data, ("PIL", mode, kw))
    data = cv2.imencode(".jpeg", make_image(64, 48))[1].tobytes()
    rgb = decode_jpeg(data, device="cpu").astype(np.int32)
    formula = (rgb @ np.asarray([4899, 9617, 1868]) + (1 << 13)) >> 14
    assert not np.array_equal(decode_jpeg(data, gray=True, device="cpu"), formula)


def test_exif_orientation_applied_as_cv2_does():
    """Orientation 1-8 spliced into APP1 (6 and 3 among them), in colour and
    grey reads, on a 4:2:0 and a grey file: the shape turns (53x37 for 6) and
    the pixels equal ``cv2.imread``'s."""
    img = make_image(37, 53, seed=3)
    for data in (cv2.imencode(".jpeg", img)[1].tobytes(),
                 cv2.imencode(".jpeg", img[..., 1])[1].tobytes()):
        for orientation in range(1, 9):
            rotated = with_exif(data, orientation)
            assert jpeg.parse(rotated).orientation == orientation
            assert_reads_like_cv2(rotated, orientation)
        assert decode_jpeg(with_exif(data, 6), device="cpu").shape[:2] == (53, 37)


def test_unsupported_and_truncated_files_raise():
    """Progressive, CMYK (4 components) and 12-bit files, and a scan cut in
    half or with a corrupt byte run, and a scan header that names 5 or 0
    components, or one component twice, raise a ValueError that names the
    cause; so does a file that is not a JPEG."""
    img = make_image(64, 48)
    progressive = cv2.imencode(".jpeg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(progressive, device="cpu")
    bio = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(bio, "JPEG")
    with pytest.raises(ValueError, match="4-component"):
        decode_jpeg(bio.getvalue(), device="cpu")
    base = cv2.imencode(".jpeg", img)[1].tobytes()
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(twelve, device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(base[:len(base) // 2], device="cpu")
    sos = base.index(b"\xff\xda")
    corrupt = base[:sos + 20] + b"\xff\xfe" * 8 + base[sos + 36:]
    with pytest.raises(ValueError, match="corrupt|truncated"):
        decode_jpeg(corrupt, device="cpu")
    grey = cv2.imencode(".jpeg", img[..., 0])[1].tobytes()
    for data, comps, what in ((grey, b"\x01\x00" * 5, "5 components in a frame of 1"),
                              (base, b"", "0 components"),
                              (base, b"\x01\x00\x02\x11\x01\x11", "component 1 twice")):
        sos = data.index(b"\xff\xda")
        (length,) = struct.unpack(">H", data[sos + 2:sos + 4])
        header = struct.pack(">HB", 6 + len(comps), len(comps) // 2) + comps + b"\x00\x3f\x00"
        with pytest.raises(ValueError, match=what):
            decode_jpeg(data[:sos + 2] + header + data[sos + 2 + length:], device="cpu")
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n", device="cpu")


def test_write_jpeg_writes_cv2s_bytes(tmp_path):
    """``write_jpeg`` / ``encode_jpeg`` against ``cv2.imencode`` of the same
    pixels (BGR for cv2): the same bytes at every size, at quality 95 (cv2's
    default), 75 and 50, grey and colour, and in the other samplings and with
    restart intervals; so the pixels that cv2 and the port decode from the
    port's files are equal too."""
    for h, w in SIZES + ((3, 5), (300, 451)):
        img = make_image(h, w, seed=h + w)
        for q in (95, 75, 50):
            want = cv2.imencode(".jpeg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1]
            assert jpeg.encode_jpeg(img, q) == want.tobytes(), (h, w, q)
            want = cv2.imencode(".jpeg", img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, q])[1]
            assert jpeg.encode_jpeg(img[..., 0], q) == want.tobytes(), (h, w, q, "grey")
        for name, samp in SAMPLING.items():
            for restart in (0, 2):
                want = cv2.imencode(".jpeg", img[..., ::-1], [
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp,
                    cv2.IMWRITE_JPEG_RST_INTERVAL, restart])[1].tobytes()
                assert jpeg.encode_jpeg(img, sampling=name, restart=restart) == want
    path = tmp_path / "a.jpeg"
    img = make_image(129, 97, seed=9)
    jpeg.write_jpeg(path, img)
    data = path.read_bytes()
    assert np.array_equal(read_jpeg(path, device="cpu"), cv2_read(data))
    assert np.array_equal(cv2.imread(str(path))[..., ::-1], decode_jpeg(data, device="cpu"))


def test_read_image_routes_jpeg_by_magic(tmp_path, monkeypatch):
    """``read_image`` / ``read_mask`` send a JPEG to the port's decoder by
    its FFD8FF magic whatever its suffix, on the device asked for: "cpu"
    equals cv2; the default, the card, raises where there is none (no
    fallback to the CPU)."""
    img = make_image(64, 48, seed=2)
    data = cv2.imencode(".jpeg", img)[1].tobytes()
    for name in ("a.jpeg", "b.JPG", "c"):
        (tmp_path / name).write_bytes(data)
        assert jpeg.is_jpeg(tmp_path / name)
        assert np.array_equal(imageio.read_image(tmp_path / name, device="cpu"), cv2_read(data))
        assert np.array_equal(imageio.read_mask(tmp_path / name, device="cpu"),
                              cv2_read(data, gray=True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imageio.read_image(tmp_path / "a.jpeg")
