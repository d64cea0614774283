"""The port's PNG codec and cv2-geometry resize (``data/imageio.py``) against
cv2, and ``cli/infer.py::load_and_letterbox`` against the JAX package's
dataset path, on the CPU.

Images are made from a seed with numpy: a smooth gradient with noise, a
block of random rows and flat rows, so that cv2's PNG writer picks all five
row filters at every compression level (the tests check that it did).
"""

import zlib

import numpy as np
import pytest

import cv2

from multitask_bonetumor_yolo_tpu.core.letterbox import PAD_VALUE as JAX_PAD
from multitask_bonetumor_yolo_tpu.core.letterbox import letterbox_geometry as jax_geometry
from multitask_bonetumor_yolo_tpu.data import dataset as jax_dataset
from multitask_bonetumor_yolo_tpu_torch.cli import infer
from multitask_bonetumor_yolo_tpu_torch.data import imageio
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

LEVELS = (0, 1, 3, 6, 9)


def make_image(h=64, w=80, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128).astype(np.uint8)
    img = np.stack([base, base[::-1], np.roll(base, 5, 1)], -1)
    img = (img + rng.randint(0, 20, img.shape)).astype(np.uint8)
    img[(5 * h) // 8:] = rng.randint(0, 256, (h - (5 * h) // 8, w, 3))
    img[::9] = 7
    return img


def row_filters(path):
    data = open(path, "rb").read()
    idat = b"".join(body for kind, body in imageio._chunks(data, str(path)) if kind == b"IDAT")
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba"])
def test_read_png_matches_cv2(tmp_path, kind):
    """Files that cv2 wrote at compression levels 0-9, with all five row
    filters in each: ``read_png`` equals ``cv2.imread`` + BGR->RGB bit for
    bit (alpha dropped, grey repeated to three channels)."""
    img = make_image()
    arr = {"grey": img[..., 0], "rgb": img[..., ::-1],
           "rgba": np.concatenate([img[..., ::-1], img[..., :1]], -1)}[kind]
    for level in LEVELS:
        path = tmp_path / f"{kind}{level}.png"
        assert cv2.imwrite(str(path), arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert row_filters(path) == {0, 1, 2, 3, 4}, level
        want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        assert np.array_equal(imageio.read_png(path), want), level


def test_write_png_round_trips_through_cv2(tmp_path):
    """``write_png`` -> ``cv2.imread`` gives the array back (RGB, grey, RGBA);
    a corrupted chunk and a 16-bit file are refused by name."""
    img = make_image(37, 51, seed=1)
    imageio.write_png(tmp_path / "rgb.png", img)
    assert np.array_equal(cv2.imread(str(tmp_path / "rgb.png"))[..., ::-1], img)
    imageio.write_png(tmp_path / "grey.png", img[..., 1])
    assert np.array_equal(cv2.imread(str(tmp_path / "grey.png"), cv2.IMREAD_GRAYSCALE),
                          img[..., 1])
    rgba = np.concatenate([img, img[..., :1]], -1)
    imageio.write_png(tmp_path / "rgba.png", rgba)
    assert np.array_equal(cv2.imread(str(tmp_path / "rgba.png"), cv2.IMREAD_UNCHANGED),
                          rgba[..., [2, 1, 0, 3]])
    data = bytearray((tmp_path / "rgb.png").read_bytes())
    data[40] ^= 0xFF  # inside the IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        imageio.read_png(tmp_path / "bad.png")
    cv2.imwrite(str(tmp_path / "deep.png"), (img.astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="16-bit"):
        imageio.read_png(tmp_path / "deep.png")


def test_resize_matches_cv2_within_one_lsb():
    """``resize_bilinear_u8`` against ``cv2.resize(INTER_LINEAR)``, up and
    down, colour and grey: within 1 LSB everywhere, equal on >= 99.5 % of the
    values."""
    img = make_image(97, 131, seed=2)
    for w, h in ((64, 50), (300, 200), (65, 48), (250, 33), (131, 97), (1, 1), (400, 3)):
        for a in (img, img[..., 0]):
            got = imageio.resize_bilinear_u8(a, w, h)
            want = cv2.resize(a, (w, h), interpolation=cv2.INTER_LINEAR)
            diff = np.abs(got.astype(int) - want)
            assert got.shape == want.shape
            assert diff.max() <= 1, (w, h)
            assert (diff == 0).mean() >= 0.995, (w, h, (diff == 0).mean())


def test_load_and_letterbox_matches_jax_dataset_path(tmp_path):
    """A non-square PNG through the port's ``load_and_letterbox`` against the
    JAX dataset's path (``_imread_color_rgb``, ``_resize(nearest=False)``,
    the top-left letterbox with PAD_VALUE), at 64 and 96: within 1 LSB."""
    img = make_image(45, 70, seed=3)
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img[..., ::-1])
    for size in (64, 96):
        rgb = jax_dataset._imread_color_rgb(str(path))
        _, nh, nw = jax_geometry(*rgb.shape[:2], size)
        want = np.full((size, size, 3), JAX_PAD, np.uint8)
        want[:nh, :nw] = jax_dataset._resize(rgb, nw, nh, nearest=False)
        got = infer.load_and_letterbox(str(path), size)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1


def test_jpeg_without_cv2_or_pil_names_the_png_route(tmp_path, monkeypatch):
    """With cv2 and PIL hidden, the port's own routes read both formats: a
    JPEG through ``data/jpeg.py`` (``load_and_letterbox`` equals what it gave
    with cv2 importable, and the JPEG read equals cv2's), ``BTXRD`` reads a
    JPEG split, and a PNG is still read by the PNG codec."""
    from multitask_bonetumor_yolo_tpu_torch.data import dataset, synthetic

    img = make_image(16, 24, seed=4)
    cv2.imwrite(str(tmp_path / "a.jpeg"), img)
    imageio.write_png(tmp_path / "a.png", img)
    root = synthetic.make_synthetic_btxrd(str(tmp_path / "d"), n=2, min_size=40, max_size=60,
                                          image_format="jpeg")
    want = infer.load_and_letterbox(str(tmp_path / "a.jpeg"), 32, "cpu")
    cv2_rgb = cv2.imread(str(tmp_path / "a.jpeg"))[..., ::-1]
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert np.array_equal(infer.load_and_letterbox(str(tmp_path / "a.jpeg"), 32, "cpu"), want)
    assert np.array_equal(imageio.read_image(tmp_path / "a.jpeg", device="cpu"), cv2_rgb)
    assert infer.load_and_letterbox(str(tmp_path / "a.png"), 32).shape == (32, 32, 3)
    ds = dataset.BTXRD(dataset.DataConfig(root=str(root), img_size=32), "all", device="cpu")
    assert len(ds) == 2 and ds[0]["image"].shape == (32, 32, 3)
