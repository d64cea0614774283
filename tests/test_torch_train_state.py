"""The port's train state and preprocessing, on the CPU: the non-finite
skip of ``TrainState.apply_gradients``, two of its steps and the
learning-rate schedule against optax's (through the JAX package), and the
not-yet-ported augmentation.

At the oracle config of tests/test_torch_train.py, with the port's own
seeded weights: none of these needs the JAX model. They live apart from
that file so that each test file holds fewer tests than
tests/test_train_fast.py: the parallel runner hands out files in order of
their test counts, and the suite's longest file should start first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multitask_bonetumor_yolo_tpu.train.state import TrainConfig as JaxTrainConfig
from multitask_bonetumor_yolo_tpu.train.state import make_optimizer
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from multitask_bonetumor_yolo_tpu_torch.train import TrainConfig, create_train_state, lr_at
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import (
    B, CFG, IMG, TRAIN, adam_state, make_batch, port_moments, to_torch,
)


def test_nonfinite_gradient_skips_the_step():
    """As tests/test_train_fast.py's ``test_apply_gradients_skips_nonfinite``:
    a NaN gradient leaves the parameters, the BN statistics moved by the
    forward, the moments and the optimizer count as they were and only
    ``step`` advances; a finite step after it applies; a huge but finite
    gradient (whose sum of squares overflows) is clipped, not skipped."""
    model = build_model(ModelConfig(**CFG), seed=0)
    state = create_train_state(model.cfg, TrainConfig(**TRAIN), model=model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    snap = state.bn_snapshot()
    image = torch.from_numpy(np.random.RandomState(1).rand(B, IMG, IMG, 3).astype(np.float32))
    model(image, train=True, mode="train")  # moves the BN statistics
    params = state.params()
    grads = [torch.ones_like(p) for p in params]
    grads[3] = grads[3].clone().fill_(float("nan"))
    mu, nu = state.mu.clone(), state.nu.clone()
    norm, ok = state.apply_gradients(grads, snap)
    assert not bool(ok) and state.step == 1 and int(state.count) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(state.mu, mu) and torch.equal(state.nu, nu)

    _, ok = state.apply_gradients([torch.full_like(p, 0.5) for p in params], state.bn_snapshot())
    assert bool(ok) and state.step == 2 and int(state.count) == 1
    assert all((p != before[n]).all() for n, p in model.named_parameters())

    _, ok = state.apply_gradients([torch.full_like(p, 3e38) for p in params], state.bn_snapshot())
    assert bool(ok) and all(torch.isfinite(p).all() for p in params)


def test_apply_gradients_matches_optax():
    """Two steps of ``TrainState.apply_gradients`` against the JAX package's
    optimizer (``make_optimizer``: optax clip + AdamW under the cosine
    schedule; its parameters as one flat leaf, as optax's update is
    elementwise but for the global norm) on the same seeded gradients, at a
    learning rate and weight decay large enough to see (lr 1e-2, wd 0.05):
    the first gradient's global norm is half of ``grad_clip``, the second's
    four times it, so the clip scales it and with it the moments. After each
    step, mu, nu and each parameter's change p1 - p0 within 1e-5 (moments) or
    1e-4 (change) of their value plus the same of the tensor's largest (the
    same fp32 formulas, but the norms are summed in another order and the
    second step's moments are differences that can cancel), the change also
    plus two fp32 spacings of p1 (its rounding in each package). Without the
    decay the change moves by lr * wd * p, 5e-4 |p| against a limit of ~3e-6;
    without the clip the second gradient enters the moments 4x too large;
    the schedule read at the wrong count moves the second change by 2.4 %."""
    cfg = dict(TRAIN, lr=1e-2, weight_decay=0.05, grad_clip=2.0)
    model = build_model(ModelConfig(**CFG), seed=0)
    state = create_train_state(model.cfg, TrainConfig(**cfg), model=model)
    names, params = zip(*model.named_parameters())
    sizes = np.cumsum([0] + [p.numel() for p in params])
    tx = make_optimizer(JaxTrainConfig(**cfg))
    update = jax.jit(lambda p, s, g: (lambda u, s1: (optax.apply_updates(p, u), s1))(
        *tx.update(g, s, p)))
    jax_p = {"w": jnp.asarray(np.concatenate([p.detach().numpy().ravel() for p in params]))}
    jax_opt = tx.init(jax_p)
    rs = np.random.RandomState(5)
    for k, norm in enumerate((0.5 * cfg["grad_clip"], 4.0 * cfg["grad_clip"])):
        flat = rs.standard_normal(sizes[-1])
        flat = (flat * norm / np.linalg.norm(flat)).astype(np.float32)
        grads = [torch.from_numpy(flat[a:b]).view_as(p)
                 for a, b, p in zip(sizes[:-1], sizes[1:], params)]
        got_norm, ok = state.apply_gradients(grads, state.bn_snapshot())
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-5)
        assert bool(ok) and int(state.count) == k + 1
        p0 = np.asarray(jax_p["w"], np.float64)
        jax_p, jax_opt = update(jax_p, jax_opt, {"w": flat})
        adam = adam_state(jax_opt)
        assert int(adam.count) == k + 1
        p1, mu, nu = (np.asarray(t["w"]) for t in (jax_p, adam.mu, adam.nu))
        moments = port_moments(state)
        for n, p, a, b in zip(names, params, sizes[:-1], sizes[1:]):
            for what, got, want in (("mu", moments[n][0], mu[a:b]), ("nu", moments[n][1], nu[a:b])):
                err = np.abs(got.numpy().ravel() - want)
                assert (err <= 1e-5 * (np.abs(want) + np.abs(want).max())).all(), (what, n, k)
            d_want = p1[a:b] - p0[a:b]
            err = np.abs((p.detach().numpy().ravel() - p0[a:b]) - d_want)
            lim = 1e-4 * (np.abs(d_want) + np.abs(d_want).max()) + 2 * np.spacing(np.abs(p1[a:b]))
            assert (err <= lim).all(), (n, k, (err - lim).max())


def test_lr_schedule_matches_optax():
    """``lr_at`` against ``optax.cosine_decay_schedule`` (through the JAX
    package's ``lr_at``) at the start, middle, end and past the end."""
    from multitask_bonetumor_yolo_tpu.train.state import lr_at as jax_lr_at

    jc, tc = JaxTrainConfig(**TRAIN), TrainConfig(**TRAIN)
    for count in (0, 3, 5, 10, 12):
        want = jax_lr_at(jc, count)
        np.testing.assert_allclose(lr_at(tc, count), want, rtol=1e-6)
        np.testing.assert_allclose(float(lr_at(tc, torch.tensor(count))), want, rtol=1e-6)


def test_augmentation_is_not_ported_yet():
    from multitask_bonetumor_yolo_tpu_torch.data import AugmentConfig, augment_batch

    batch = to_torch(make_batch())
    with pytest.raises(NotImplementedError):
        augment_batch(batch, torch.Generator(), AugmentConfig(hflip_prob=0.5))
    out = augment_batch(batch, torch.Generator(), AugmentConfig())
    assert out["image"].dtype == torch.float32 and float(out["image"].max()) <= 1.0
    assert dataclasses.asdict(AugmentConfig()) == {
        "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "hflip_prob": 0.0, "mosaic_prob": 0.0}
