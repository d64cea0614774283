"""The raw-BTXRD path of the port on the CPU against the JAX package (whose
cv2 branches run here): ``make_synthetic_raw`` -> ``convert`` (the
``prepare_data`` CLI), the xlsx reader, ``polygon_to_mask`` against
``cv2.fillPoly``, ``wrangle``, ``show_sample`` and the dataset over the
converted JPEGs."""

import contextlib
import io
import os
import zipfile

import cv2
import numpy as np
import pytest

from multitask_bonetumor_yolo_tpu.cli import show_sample as jax_show_sample
from multitask_bonetumor_yolo_tpu.cli import wrangle as jax_wrangle
from multitask_bonetumor_yolo_tpu.data import convert as jax_convert
from multitask_bonetumor_yolo_tpu.data import dataset as jax_dataset
from multitask_bonetumor_yolo_tpu.data import synthetic as jax_synthetic
from multitask_bonetumor_yolo_tpu.utils import xlsx as jax_xlsx
from multitask_bonetumor_yolo_tpu_torch.cli import prepare_data, show_sample, wrangle
from multitask_bonetumor_yolo_tpu_torch.data import convert, dataset, synthetic
from multitask_bonetumor_yolo_tpu_torch.data.imageio import read_png
from multitask_bonetumor_yolo_tpu_torch.utils import xlsx
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

N_RAW = 6


def printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kw)
    return ret, out.getvalue()


def raw_pair(tmp_path):
    """The same raw split from both writers (image 3 marked "normal" in the
    metadata, so that both converters skip it)."""
    ours = synthetic.make_synthetic_raw(str(tmp_path / "raw_ours"), n=N_RAW, seed=3)
    theirs = jax_synthetic.make_synthetic_raw(str(tmp_path / "raw_jax"), n=N_RAW, seed=3)
    for root in (ours, theirs):
        meta = root / "dataset.csv"
        meta.write_text(meta.read_text().replace("raw_0003.jpeg,1,0", "raw_0003.jpeg,0,0"))
    return ours, theirs


def files(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def test_raw_split_and_convert_match_jax(tmp_path):
    """``make_synthetic_raw`` writes the JAX function's files byte for byte
    (its JPEGs are ``cv2.imwrite``'s bytes); ``prepare_data`` / ``convert``
    over it, with and without ``--emit-seg-polygons`` and from a .csv and an
    .xlsx metadata table, gives byte-equal labels, seg labels, ``img_cls.csv``
    and messages, pixel-equal masks, and hardlinked images."""
    ours, theirs = raw_pair(tmp_path)
    assert files(ours) == files(theirs)
    for rel in files(ours):
        assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel
    rows = [line.split(",") for line in (ours / "dataset.csv").read_text().split()[1:]]
    jax_xlsx.write_xlsx(str(tmp_path / "meta.xlsx"), ["image_id", "tumor", "benign"],
                        [[r[0], int(r[1]), r[2] == "1"] for r in rows])
    for meta, seg in (("dataset.csv", False), ("dataset.csv", True), (None, False)):
        tag = f"{meta}-{seg}"
        m_ours = str(ours / meta) if meta else str(tmp_path / "meta.xlsx")
        m_jax = str(theirs / meta) if meta else str(tmp_path / "meta.xlsx")
        d_ours, d_jax = tmp_path / f"ours-{tag}", tmp_path / f"jax-{tag}"
        argv = ["--src", str(ours), "--meta", m_ours, "--dst", str(d_ours)]
        _, said = printed(prepare_data.main, argv + (["--emit-seg-polygons"] if seg else []))
        n_jax, said_jax = printed(jax_convert.convert, str(theirs), m_jax, str(d_jax),
                                  emit_seg_polygons=seg)
        assert n_jax == N_RAW - 1 and said == said_jax.replace(str(d_jax), str(d_ours))
        assert files(d_ours) == files(d_jax)
        for rel in files(d_ours):
            if rel.startswith("masks/"):
                want = cv2.imread(str(d_jax / rel), cv2.IMREAD_UNCHANGED)
                assert np.array_equal(read_png(d_ours / rel)[..., 0], want), rel
                assert want.max() == 255
            else:
                assert (d_ours / rel).read_bytes() == (d_jax / rel).read_bytes(), rel
        img = d_ours / "images" / "raw_0000.jpeg"
        assert os.stat(img).st_ino == os.stat(ours / "images" / "raw_0000.jpeg").st_ino
        assert (d_ours / "labels_seg").exists() == seg


def test_polygon_to_mask_is_cv2_fill_poly():
    """``polygon_to_mask`` equals ``cv2.fillPoly`` (through the JAX
    converter's own call) on random polygons: float vertices (truncated to
    int32), vertices outside the image on every side, self-intersecting
    ones, stars of up to 40 vertices; and it is not JAX's numpy fallback."""
    rs = np.random.RandomState(0)
    for t in range(900):
        h, w = (int(v) for v in rs.randint(8, 120, 2))
        n = int(rs.randint(3, 12))
        kind = t % 4
        if kind == 0:
            pts = rs.rand(n, 2) * [w, h]
        elif kind == 1:
            pts = rs.rand(n, 2) * [w * 1.6, h * 1.6] - [w * 0.3, h * 0.3]
        elif kind == 2:
            pts = rs.randn(n, 2) * [w / 3, h / 3] + [w / 2, h / 2]
        else:
            n = int(rs.randint(5, 40))
            ang = np.sort(rs.rand(n)) * 2 * np.pi
            r = (0.3 + 0.8 * rs.rand(n)) * min(h, w) / 2
            pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
        want = jax_convert.polygon_to_mask(pts.tolist(), h, w)
        assert np.array_equal(convert.polygon_to_mask(pts.tolist(), h, w), want), (t, h, w)
    rect = [[3.0, 2.0], [33.0, 2.0], [33.0, 20.0], [3.0, 20.0]]
    assert not np.array_equal(convert.polygon_to_mask(rect, 24, 40),
                              jax_convert._fill_polygon_np(rect, 24, 40))


def test_xlsx_reader_matches_jax(tmp_path):
    """The port's xlsx reader gives JAX's rows and dicts for the same bytes:
    inline strings, numbers, booleans, gaps, and a sheet with shared strings
    written by hand."""
    path = tmp_path / "a.xlsx"
    jax_xlsx.write_xlsx(str(path), ["image_id", "tumor", "benign", "age"],
                        [["IMG1.jpeg", 1, True, 31.5], ["IMG2.jpeg", 0, False, 7],
                         ["IMG3", "1", "yes", ""]])
    shared = tmp_path / "b.xlsx"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(shared, "w") as dst:
        for name in src.namelist():
            body = src.read(name)
            if name == "xl/worksheets/sheet1.xml":  # two cells through the shared strings
                body = body.replace(b'<c r="A2" t="inlineStr"><is><t>IMG1.jpeg</t></is></c>',
                                    b'<c r="A2" t="s"><v>1</v></c>')
                body = body.replace(b'<c r="A3" t="inlineStr"><is><t>IMG2.jpeg</t></is></c>',
                                    b'<c r="A3" t="s"><v>0</v></c>')
                assert body.count(b't="s"') == 2
            dst.writestr(name, body)
        ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
        dst.writestr("xl/sharedStrings.xml",
                     f'<sst xmlns="{ns}"><si><t>x</t></si><si><r><t>y</t></r><r><t>z</t></r>'
                     f'</si></sst>')
        dst.writestr("xl/worksheets/sheet2.xml", "<worksheet/>")
    for p in (path, shared):
        assert xlsx.read_xlsx_rows(p) == jax_xlsx.read_xlsx_rows(p)
        assert xlsx.read_xlsx_dicts(p) == jax_xlsx.read_xlsx_dicts(p)
        assert convert.build_type_map(str(p)) == jax_convert.build_type_map(str(p))


def test_wrangle_matches_jax(tmp_path):
    """``wrangle`` over the raw split writes JAX's CSV byte for byte and
    prints its summary."""
    ours, theirs = raw_pair(tmp_path)
    n, said = printed(wrangle.main, ["--src", str(ours), "--meta", str(ours / "dataset.csv"),
                                     "--out", str(tmp_path / "ours.csv")])
    _, said_jax = printed(jax_wrangle.main, ["--src", str(theirs), "--meta",
                                             str(theirs / "dataset.csv"), "--out",
                                             str(tmp_path / "jax.csv")])
    assert n == 2 * N_RAW
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert said == said_jax.replace("jax.csv", "ours.csv")


@pytest.mark.parametrize("square", [False, True])
def test_dataset_and_show_sample_on_jpeg_match_jax(tmp_path, square):
    """Over JPEG splits: a converted raw split (non-square images) and a
    training-ready split of ``img_size``-square JPEGs (``make_synthetic_btxrd``
    with ``image_format="jpeg"``, the JAX writer's bytes). ``BTXRD`` items
    against the JAX dataset's (cv2): boxes, masks, classes and ids equal, the
    image bit for bit where the resize is the identity (square) and within
    1 LSB otherwise (the port's resize, as ``test_torch_data.py`` states);
    ``show_sample``'s PNG against JAX's likewise."""
    size = 64
    if square:
        root = synthetic.make_synthetic_btxrd(str(tmp_path / "sq"), n=4, seed=2, min_size=size,
                                              max_size=size, image_format="jpeg")
        jroot = jax_synthetic.make_synthetic_btxrd(str(tmp_path / "sq_jax"), n=4, seed=2,
                                                   min_size=size, max_size=size)
        assert files(root) == files(jroot)
        for rel in files(root):
            if rel.startswith("masks/"):
                want = cv2.imread(str(jroot / rel), cv2.IMREAD_UNCHANGED)
                assert np.array_equal(read_png(root / rel)[..., 0], want), rel
            else:
                assert (root / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    else:
        ours, _ = raw_pair(tmp_path)
        root = tmp_path / "ready"
        printed(convert.convert, str(ours), str(ours / "dataset.csv"), str(root))
    tol = 0 if square else 1
    kw = dict(root=str(root), img_size=size, image_ext=".jpeg", max_boxes=4)
    mine = dataset.BTXRD(dataset.DataConfig(**kw), "all", device="cpu")
    theirs = jax_dataset.BTXRD(jax_dataset.DataConfig(**kw), "all")
    assert len(mine) == len(theirs) > 0
    for i in range(len(theirs)):
        got, want = mine[i], theirs[i]
        for k in ("boxes", "box_valid", "mask", "img_cls", "id"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.abs(got["image"].astype(int) - want["image"]).max() <= tol
    for index in range(2):
        common = ["--root", str(root), "--split", "all", "--index", str(index),
                  "--img-size", str(size)]
        _, said = printed(show_sample.main, common + ["--out", str(tmp_path / "o.png"),
                                                      "--device", "cpu"])
        printed(jax_show_sample.main, common + ["--out", str(tmp_path / "j.png")])
        got = read_png(tmp_path / "o.png").astype(int)
        want = cv2.imread(str(tmp_path / "j.png"))[..., ::-1]
        assert np.abs(got - want).max() <= tol and "box(es)" in said
