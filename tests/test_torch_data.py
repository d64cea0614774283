"""The port's data path against the JAX package's, on the CPU: the synthetic
BTXRD writer, the dataset's split and items, the loader and the device cache.

The port's ``make_synthetic_btxrd`` writes PNG images; the JAX one hands the
same arrays to its JPEG writer, which the test captures. Both datasets then
read the port's PNG directory (the JAX ``BTXRD`` with ``image_ext=".png"``,
through cv2)."""

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu.data import dataset as jax_dataset
from multitask_bonetumor_yolo_tpu.data import synthetic as jax_synthetic
from multitask_bonetumor_yolo_tpu_torch.data import dataset, imageio, synthetic
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SIZE = 96


def png_dataset(path, n=10, lo=60, hi=140, rich=True, seed=0):
    synthetic.make_synthetic_btxrd(str(path), n=n, seed=seed, min_size=lo, max_size=hi, rich=rich)
    return path


def configs(root, **kw):
    kw = dict(root=str(root), img_size=SIZE, image_ext=".png", max_boxes=4, **kw)
    return dataset.DataConfig(**kw), jax_dataset.DataConfig(**kw)


@pytest.mark.parametrize("rich", [False, True])
def test_synthetic_writer_matches_jax(tmp_path, monkeypatch, rich):
    """Labels, masks and the class csv equal the JAX writer's (the csv names
    ``.png`` where JAX names ``.jpeg``), and each PNG image holds exactly the
    array that JAX hands to its JPEG writer."""
    images, masks = {}, {}
    monkeypatch.setattr(jax_synthetic, "_write_jpeg",
                        lambda path, arr: images.__setitem__(path.stem, arr.copy()))
    monkeypatch.setattr(jax_synthetic, "_write_png",
                        lambda path, arr: masks.__setitem__(path.stem, arr.copy()))
    jax_root = jax_synthetic.make_synthetic_btxrd(str(tmp_path / "jax"), n=6, seed=3, nc=2,
                                                  min_size=48, max_size=120, rich=rich)
    root = synthetic.make_synthetic_btxrd(str(tmp_path / "port"), n=6, seed=3, nc=2,
                                          min_size=48, max_size=120, rich=rich)
    assert (root / "img_cls.csv").read_text() == \
        (jax_root / "img_cls.csv").read_text().replace(".jpeg", ".png")
    assert len(images) == len(masks) == 6
    for stem, img in images.items():
        assert (root / "labels_det" / f"{stem}.txt").read_text() == \
            (jax_root / "labels_det" / f"{stem}.txt").read_text()
        assert np.array_equal(imageio.read_png(root / "images" / f"{stem}.png"), img)
        assert np.array_equal(imageio.read_png_gray(root / "masks" / f"{stem}.png"), masks[stem])
        assert masks[stem].any()


def test_split_matches_jax(tmp_path):
    """Train / val / all splits list the same item ids, in the same order, as
    the JAX dataset on the same directory, at two seeds and ratios."""
    root = png_dataset(tmp_path / "d", n=13, lo=40, hi=60, rich=False)
    (root / "masks" / "synth_0004.png").unlink()  # an incomplete item is skipped
    for seed, ratio in ((42, 0.8), (7, 0.5)):
        ours_cfg, jax_cfg = configs(root, seed=seed, train_ratio=ratio)
        for split in ("train", "val", "all"):
            ours = dataset.BTXRD(ours_cfg, split)
            theirs = jax_dataset.BTXRD(jax_cfg, split)
            assert [it["id"] for it in ours.items] == [it["id"] for it in theirs.items], split
            assert len(ours) > 0 and ours.class_histogram() == theirs.class_histogram()


@pytest.mark.parametrize("square", [False, True])
def test_items_match_jax(tmp_path, square):
    """``__getitem__`` against the JAX dataset's (cv2): boxes, masks, classes
    and ids equal; the letterboxed image within 1 LSB on non-square images
    (the resize), bit for bit when the images are ``img_size`` square."""
    lo, hi = (SIZE, SIZE) if square else (50, 200)
    root = png_dataset(tmp_path / "d", n=6, lo=lo, hi=hi)
    ours_cfg, jax_cfg = configs(root)
    ours, theirs = dataset.BTXRD(ours_cfg, "all"), jax_dataset.BTXRD(jax_cfg, "all")
    for i in range(len(theirs)):
        got, want = ours[i], theirs[i]
        assert sorted(got) == sorted(want)
        for k in ("boxes", "box_valid", "mask", "img_cls", "id"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        diff = np.abs(got["image"].astype(int) - want["image"])
        assert got["image"].dtype == np.uint8 and diff.max() <= (0 if square else 1)
        assert got["mask"].any() and got["box_valid"].any()


class Items:
    """A tiny stand-in dataset: the loaders read ``len``, items and
    ``cfg.batch_size``."""

    def __init__(self, n, batch_size=4):
        self.n, self.cfg = n, dataset.DataConfig(batch_size=batch_size)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return dict(id=np.int32(i), img_cls=np.int32(i % 2), boxes=np.full((2, 5), i, np.float32),
                    box_valid=np.ones(2, bool), image=np.full((3, 3, 3), i, np.uint8))


def test_loader_and_device_cache(tmp_path):
    """``BTXRDLoader`` gives the JAX loader's batches (shuffle order over two
    passes, ``drop_last``, ``pad_last`` replicas, ``sample_valid``); the
    device cache's replay equals its first pass, with the tail past its cap
    streamed again, and an error in the loader reaches the consumer."""
    items = Items(10)
    for kw in (dict(), dict(shuffle=True, seed=5), dict(drop_last=True, shuffle=True),
               dict(pad_last=True), dict(pad_last=True, batch_size=3, shuffle=True)):
        ours, theirs = dataset.BTXRDLoader(items, **kw), jax_dataset.BTXRDLoader(items, **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{kw} {k}")
    last = list(dataset.BTXRDLoader(items, pad_last=True))[-1]
    assert last["sample_valid"].tolist() == [True, True, False, False]
    assert last["id"].tolist() == [8, 9, 9, 9]

    one_batch = sum(v.nbytes for v in next(iter(dataset.BTXRDLoader(items))).values())
    for cap, kept in ((4 << 30, 3), (one_batch, 1)):
        cache = dataset.DeviceEvalCache(lambda: dataset.BTXRDLoader(items, pad_last=True),
                                        lambda b: dataset.to_device(b, "cpu"), max_bytes=cap)
        first, again = list(cache), list(cache)
        assert len(first) == len(again) == 3 and len(cache._cached) == kept
        for i, ((b1, d1), (b2, d2)) in enumerate(zip(first, again)):
            assert all(torch.equal(d1[k], d2[k]) for k in d1)
            assert d1["image"].device.type == "cpu" and d1["sample_valid"].dtype == torch.bool
            want_keys = set(b1) if i == 0 or i >= kept else set(dataset.DeviceEvalCache.HOST_KEYS)
            assert set(b2) == want_keys
            for k in want_keys:
                np.testing.assert_array_equal(b2[k], b1[k])

    def broken():
        yield from dataset.BTXRDLoader(items)
        raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable"):
        list(dataset.Prefetcher(broken()))


def test_device_cache_prime(tmp_path):
    """``DeviceEvalCache.prime`` runs the first pass on a thread: the next
    pass joins it and replays the same batches without calling the loader
    again; priming twice starts one pass. A primer that fails keeps its
    error: the next pass warns with it and streams the split inline (the
    JAX primer swallowed every ``BaseException`` silently)."""
    items = Items(10)
    calls = []

    def make_loader():
        calls.append(1)
        return dataset.BTXRDLoader(items, pad_last=True)

    want = list(dataset.DeviceEvalCache(make_loader, lambda b: dataset.to_device(b, "cpu")))
    calls.clear()
    cache = dataset.DeviceEvalCache(make_loader, lambda b: dataset.to_device(b, "cpu"))
    cache.prime()
    cache.prime()
    got = list(cache)
    assert len(calls) == 1 and cache._primer is None and len(got) == len(want) == 3
    for (_, d1), (_, d2) in zip(got, want):
        assert all(torch.equal(d1[k], d2[k]) for k in d2)

    failures = iter([OSError("disk gone")])

    def flaky():
        err = next(failures, None)
        if err is not None:
            raise err
        return dataset.BTXRDLoader(items, pad_last=True)

    cache = dataset.DeviceEvalCache(flaky, lambda b: dataset.to_device(b, "cpu"))
    cache.prime()
    with pytest.warns(RuntimeWarning, match=r"priming failed \(OSError\('disk gone'\)\)"):
        got = list(cache)
    assert len(got) == 3 and len(cache._cached) == 3
