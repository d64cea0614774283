"""The port's on-device augmentations and nearest resize against the JAX
package's (``data/preprocess.py``, ``ops/resize.py``), on the CPU.

Inputs are made with numpy from a seed: a batch of B = 8 uint8 images at
32², boxes with valid and invalid slots, binary masks, distinct image
classes. The JAX functions run eagerly; the port's apply steps take JAX's
own random draws (``augment_batch``: ``k_mosaic, k_hsv, k_flip, k_gate =
split(key, 4)``; the HSV gains ``uniform(k_hsv, (B', 3), -1, 1)``, the flips
``bernoulli(k_flip, p, (B',))``, the mosaic gate ``bernoulli(k_gate, p,
(B // 4,))``, B' the batch after the mosaic). Tolerances: fp32 values atol
1e-5; boxes, valid, masks, ``img_cls`` and ``id`` equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.data import preprocess as jp
from multitask_bonetumor_yolo_tpu.ops.resize import resize_nearest as jax_resize_nearest
from multitask_bonetumor_yolo_tpu_torch.data import preprocess as tp
from multitask_bonetumor_yolo_tpu_torch.ops.resize import resize_nearest
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

B, S, M = 8, 32, 6
ATOL = 1e-5


def make_batch(seed=0):
    rs = np.random.RandomState(seed)
    boxes = np.zeros((B, M, 5), np.float32)
    valid = np.zeros((B, M), bool)
    mask = np.zeros((B, S, S, 1), np.uint8)
    for i in range(B):
        n = i % 4  # 0-3 valid boxes; the rest of the slots hold junk
        boxes[i] = rs.uniform(0.05, 0.95, (M, 5)).astype(np.float32)
        boxes[i, :, 0] = rs.randint(0, 2, M)
        valid[i, :n] = True
        y0, x0 = rs.randint(0, S // 2, 2)
        mask[i, y0:y0 + S // 3, x0:x0 + S // 4] = 1
    return {
        "image": rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
        "boxes": boxes, "box_valid": valid, "mask": mask,
        "img_cls": np.arange(B, dtype=np.int32),
        "id": 100 + np.arange(B, dtype=np.int32),
        "sample_valid": np.arange(B) < B - 1,
    }


def jax_draws(key, cfg, b=B):
    """The JAX ``augment_batch``'s draws for ``key``, as the port's dict."""
    _, k_hsv, k_flip, k_gate = jax.random.split(key, 4)
    out_b = b // 4 if cfg.mosaic_prob > 0 else b
    draws = {}
    if cfg.mosaic_prob > 0:
        draws["gate"] = jax.random.bernoulli(k_gate, cfg.mosaic_prob, (b // 4,))
    if cfg.hsv_h > 0 or cfg.hsv_s > 0 or cfg.hsv_v > 0:
        draws["hsv"] = jax.random.uniform(k_hsv, (out_b, 3), minval=-1.0, maxval=1.0)
    if cfg.hflip_prob > 0:
        draws["flip"] = jax.random.bernoulli(k_flip, cfg.hflip_prob, (out_b,))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def assert_same(got, want, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if atol:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_resize_nearest_matches_jax():
    """2x up, 0.5x (the mosaic's; source 2i + 1), and odd ratios, among them
    10 -> 3, where ``F.interpolate(mode="nearest-exact")`` takes index 4 for
    output 1 and JAX 5; fp32 and uint8, NHWC and HWC, equal."""
    rs = np.random.RandomState(1)
    for (h, w), (oh, ow) in (((8, 6), (16, 12)), ((32, 32), (16, 16)), ((10, 7), (3, 5)),
                             ((9, 13), (14, 4))):
        for x in (rs.randn(2, h, w, 3).astype(np.float32),
                  rs.randint(0, 2, (h, w, 1)).astype(np.uint8)):
            want = jax_resize_nearest(jnp.asarray(x), oh, ow)
            got = resize_nearest(torch.from_numpy(x), oh, ow)
            assert got.dtype == torch.from_numpy(x).dtype
            assert_same(got, want)
    x = torch.arange(10.0).reshape(1, 10, 1, 1)
    assert resize_nearest(x, 3, 1).flatten().tolist() == [1.0, 5.0, 8.0]


def test_rgb_hsv_round_trip_matches_jax():
    """``_rgb_to_hsv`` and ``_hsv_to_rgb`` on random pixels, grey pixels
    (d = 0), black, each channel the maximum, and hues at every sextant and
    past 1 and below 0 (floor-mod): within 1e-5 of JAX's."""
    rs = np.random.RandomState(2)
    rgb = rs.rand(64, 3).astype(np.float32)
    rgb[:4] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 1, 1], [0.2, 0.2, 0.2]]
    rgb[4:7] = [[0.9, 0.1, 0.3], [0.1, 0.9, 0.3], [0.1, 0.3, 0.9]]
    assert_same(tp._rgb_to_hsv(torch.from_numpy(rgb)), jax.jit(jp._rgb_to_hsv)(jnp.asarray(rgb)), ATOL)
    hsv = rs.rand(64, 3).astype(np.float32)
    hsv[:8, 0] = [-0.25, 0.0, 1 / 6, 2 / 6, 0.5, 4 / 6, 5 / 6, 1.3]
    assert_same(tp._hsv_to_rgb(torch.from_numpy(hsv)), jax.jit(jp._hsv_to_rgb)(jnp.asarray(hsv)), ATOL)


def test_hsv_augment_matches_jax():
    """``hsv_apply`` on JAX's ``uniform(key, (B, 3), -1, 1)`` against
    ``hsv_augment`` at YOLO's gains (0.015, 0.7, 0.4) and at larger ones."""
    images = jp.normalize(jnp.asarray(make_batch()["image"]))
    for seed, gains in ((0, (0.015, 0.7, 0.4)), (1, (0.5, 0.9, 0.9))):
        key = jax.random.PRNGKey(seed)
        want = jax.jit(jp.hsv_augment, static_argnums=2)(images, key, gains)
        r = torch.from_numpy(np.array(jax.random.uniform(key, (B, 3), minval=-1.0, maxval=1.0)))
        assert_same(tp.hsv_apply(torch.from_numpy(np.array(images)), r, gains), want, ATOL)


def test_random_hflip_matches_jax():
    """``hflip_apply`` on JAX's ``bernoulli(key, 0.5, (B,))`` against
    ``random_hflip``: images, masks and boxes equal, some flipped, some not."""
    batch = make_batch()
    images = jp.normalize(jnp.asarray(batch["image"]))
    key = jax.random.PRNGKey(4)
    flip = jax.random.bernoulli(key, 0.5, (B,))
    assert 0 < int(flip.sum()) < B
    want = jp.random_hflip(images, jnp.asarray(batch["boxes"]), jnp.asarray(batch["mask"]),
                           key, 0.5)
    got = tp.hflip_apply(torch.from_numpy(np.array(images)), torch.from_numpy(batch["boxes"]),
                         torch.from_numpy(batch["mask"]), torch.from_numpy(np.array(flip)))
    for g, w in zip(got, want):
        assert_same(g, w)


def test_mosaic4_matches_jax():
    """``mosaic4``: the 2x bilinear quadrants within 1e-5, the nearest mask
    quadrants, the remapped boxes packed valid-first and their valid flags
    equal (groups with 0 + 1 + 2 + 3 and 0 + 1 + 2 + 3 valid boxes of 6
    slots: 6 of 6 kept)."""
    batch = make_batch()
    images = jp.normalize(jnp.asarray(batch["image"]))
    want = jax.jit(jp.mosaic4)(images, *(jnp.asarray(batch[k]) for k in ("boxes", "box_valid", "mask")))
    got = tp.mosaic4(torch.from_numpy(np.array(images)),
                     *(torch.from_numpy(batch[k]) for k in ("boxes", "box_valid", "mask")))
    assert_same(got[0], want[0], ATOL)
    for g, w in zip(got[1:], want[1:]):
        assert_same(g, w)
    assert got[2].sum().item() == 2 * 6 and got[3].dtype == torch.uint8


@pytest.mark.parametrize("cfg", [
    jp.AugmentConfig(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, hflip_prob=0.5, mosaic_prob=0.5),
    jp.AugmentConfig(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, hflip_prob=0.5),
], ids=["mosaic-hsv-flip", "hsv-flip"])
def test_augment_batch_matches_jax(cfg):
    """``augment_apply`` on JAX's draws against ``augment_batch``: images
    within 1e-5; boxes, valid, masks, ``img_cls``, ``id`` and
    ``sample_valid`` equal, and the same keys. Under mosaic (one group used,
    one not) the batch is B // 4 and group j keeps image j's ``img_cls``, not
    its first source's (image 4j), as the JAX code does. ``augment_batch``
    with a seeded generator equals ``augment_apply`` on that generator's
    draws."""
    batch = make_batch()
    key = next(k for k in map(jax.random.PRNGKey, range(32))
               if cfg.mosaic_prob == 0
               or np.array(jax.random.bernoulli(jax.random.split(k, 4)[3], 0.5, (2,))).tolist()
               == [True, False])
    want = jax.jit(jp.augment_batch, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in batch.items()}, key, cfg)
    tcfg = tp.AugmentConfig(**{f: getattr(cfg, f) for f in
                               ("hsv_h", "hsv_s", "hsv_v", "hflip_prob", "mosaic_prob")})
    port_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tp.augment_apply(port_batch, tcfg, jax_draws(key, cfg))
    assert sorted(got) == sorted(want)
    assert_same(got["image"], want["image"], ATOL)
    for k in ("boxes", "box_valid", "mask", "img_cls", "id", "sample_valid"):
        assert_same(got[k], want[k])
    n = B // 4 if cfg.mosaic_prob else B
    assert got["img_cls"].tolist() == list(range(n))
    gen = torch.Generator().manual_seed(5)
    via_gen = tp.augment_batch(port_batch, gen, tcfg)
    draws = tp.augment_draws(torch.Generator().manual_seed(5), tcfg, B)
    for k, v in tp.augment_apply(port_batch, tcfg, draws).items():
        assert torch.equal(via_gen[k], v), k
