"""The port's seeded initialisation against the JAX model's own, on the CPU.

The JAX ``MultitaskModel`` at the oracle config of
tests/test_reference_oracle.py (img 160, dims 16/32/48/64, depths 1/1/2/1,
BiFPN 64, proto 8) is initialised by ``jax.jit(model.init)`` (~22 s), the
port by ``build_model(seed)``; the Flax tree goes through the bridge, so
every parameter and BN statistic is matched by its torch name.

A leaf that the JAX init fills with one value is a constant (zero biases, BN
and LN ones and zeros, running statistics, layer-scale gamma 1e-6, BiFPN
fusion weights 1, the Detect head's bias priors) and must be equal in the
port. Every other leaf is a random draw from a Flax initialiser:
``lecun_normal`` (scale 1) for every conv, Dense, transposed-conv and
patchify kernel, ``variance_scaling(2.0, "fan_in", "truncated_normal")`` for
a ConvNeXt block's ``dw_kernel``, ``w1`` and ``w2``. Both draw a standard
normal cut to [-2, 2] times ``sqrt(scale / fan_in) / TRUNC``, with Flax's
fan-in of the JAX kernel's shape (the product of all but the last axis).
Each random leaf is standardised by its own ``sqrt(scale / fan_in)``, read
off the Flax tree; the two pools of standardised values, the port's and
JAX's, are held to the truncation bound ``2 / TRUNC`` and to each other.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.models import ModelConfig as JaxModelConfig
from multitask_bonetumor_yolo_tpu.models import MultitaskModel as JaxMultitaskModel
from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from test_torch_model import CFG, IMG, one_torch_thread  # noqa: F401 (autouse)

TRUNC = 0.87962566103423978  # std of a standard normal cut to [-2, 2]
BOUND = 2.0 / TRUNC  # the largest |w| / sqrt(scale / fan_in) either init may draw
HE = ("dw_kernel", "w1", "w2")  # the ConvNeXt block's variance_scaling(2.0) leaves
_T = np.linspace(-2.0, 2.0, 400_001)
_P = np.exp(-0.5 * _T ** 2)
KURT = float((_P * _T ** 4).sum() * _P.sum() / (_P * _T ** 2).sum() ** 2)  # of the cut normal


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _unit_tree(params):
    """Each Flax parameter leaf as an array filled with its initialiser's
    ``sqrt(scale / fan_in)``, 0 for a constant leaf. Transposes and flips
    keep a filled array filled, so the bridge carries it to the torch name."""
    out = {}
    for path, a in _flax_leaves(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if np.all(a == a.flat[0]):
            unit = 0.0
        else:
            scale = 2.0 if path[-1] in HE else 1.0
            unit = math.sqrt(scale / (math.prod(a.shape[:-1])))
        node[path[-1]] = np.full(a.shape, unit, np.float32)
    return out


@pytest.fixture(scope="module")
def inits():
    """``(port state_dict, JAX state_dict, {name: sqrt(scale / fan_in)})``
    with the random leaves' names in the last."""
    model = JaxMultitaskModel(JaxModelConfig(**CFG))
    variables = jax.jit(lambda key, x: model.init(key, x, train=False, mode="train"))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    want = flax_to_torch(params, stats)
    units = {k: float(v.flatten()[0])
             for k, v in flax_to_torch(_unit_tree(params), stats).items()
             if k in want and v.dtype.is_floating_point and v.numel()
             and not k.endswith(("running_mean", "running_var"))
             and float(v.flatten()[0]) > 0}
    got = build_model(ModelConfig(**CFG), seed=0, device="cpu").state_dict()
    return got, want, units


def _pool(sd, units):
    return np.concatenate([sd[k].numpy().ravel() / u for k, u in sorted(units.items())]
                          ).astype(np.float64)


def test_init_names_shapes_and_constants_match_jax(inits):
    """The port's state_dict has the bridged tree's names and shapes; every
    leaf that JAX fills with one value is that value in the port, exactly;
    every leaf JAX draws at random is not constant in the port."""
    got, want, units = inits
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        if k in units:
            assert not torch.all(got[k] == got[k].flatten()[0]), k
        else:
            assert torch.equal(got[k].to(w.dtype), w), k
    assert len(units) > 100


@pytest.mark.parametrize("side", ["port", "jax"])
def test_init_draws_within_the_truncation_bound(inits, side):
    """Every random |w| within ``2 sqrt(scale / fan_in) / TRUNC`` (x 1 + 1e-6),
    the port's as JAX's. An untruncated normal of the same variance reaches
    ~5.2 of its unit over this config's ~7 M draws."""
    got, want, units = inits
    sd = got if side == "port" else want
    worst = max((sd[k].abs().max().item() / u, k) for k, u in units.items())
    assert worst[0] <= BOUND * (1 + 1e-6), (side, worst, BOUND)


@pytest.mark.parametrize("stat", ["std", "kurtosis", "ks"])
def test_init_pooled_distribution_matches_jax(inits, stat):
    """Pooled over every random leaf, each standardised by its own unit:
    the port's std within 0.5 % of JAX's, its kurtosis (the fourth central
    moment over the squared variance: ``KURT``, 2.36, for the cut normal, 3
    for an uncut one) within 0.05 of JAX's, and the two-sample Kolmogorov-Smirnov
    statistic between the pools below its p = 1e-3 critical value."""
    got, want, units = inits
    a, b = _pool(got, units), _pool(want, units)
    assert a.size == b.size > 100_000
    if stat == "std":
        assert abs(a.std() / b.std() - 1.0) <= 5e-3, (a.std(), b.std())
    elif stat == "kurtosis":
        kurt = [np.mean((z - z.mean()) ** 4) / np.var(z) ** 2 for z in (a, b)]
        assert abs(kurt[0] - kurt[1]) <= 0.05, kurt
    else:
        a.sort(), b.sort()
        grid = np.concatenate([a, b])
        d = np.abs(np.searchsorted(a, grid, side="right") / a.size
                   - np.searchsorted(b, grid, side="right") / b.size).max()
        crit = math.sqrt(-0.5 * math.log(1e-3 / 2)) * math.sqrt(2.0 / a.size)
        assert d < crit, (d, crit)


def test_init_each_leaf_has_its_fan_in(inits):
    """Leaf by leaf, the standardised std of the port's draw (and of JAX's)
    (its root mean square, the draw's mean being 0) is 1 within six
    standard errors of a sample std of the cut normal (``sqrt((KURT - 1) /
    4n)``): a wrong fan-in or scale in one leaf shows here even where the
    pooled std cannot see it."""
    got, want, units = inits
    for side, sd in (("port", got), ("jax", want)):
        for k, u in units.items():
            z = sd[k].double().flatten() / u
            se = math.sqrt((KURT - 1.0) / (4 * z.numel()))
            rms = z.pow(2).mean().sqrt().item()
            assert abs(rms - 1.0) <= 6 * se, (side, k, rms, se)
