"""The port's whole model in bf16 against the JAX model in bf16, on the CPU.

The recipe trains in bf16 (``cli/train.py --dtype`` defaults to
``bfloat16`` in both packages), so a cast that the port places differently
from JAX would show only here. At the oracle config of
tests/test_torch_model.py with ``dtype="bfloat16", pallas="off"`` and that
file's weights (:func:`test_torch_model.jax_variables`), the JAX model runs
in bf16 and in fp32 (full fp32 matmul precision), the port in bf16, for the
training forward (``train=True, mode="train"``) and inference
(``train=False, mode="infer"``). Held: every output key, the pooled P5 that
feeds the image classifier (the mean of the neck's P5 in fp32; the JAX side
through ``capture_intermediates``, the port through a forward hook), and
after the training forward every BN running statistic.

The rule is the kernels' (``chip_smoke.py``): per key the port's bf16 result
may be at most twice as far from JAX's bf16 result as JAX's bf16 is from
JAX's fp32, plus 1e-3 of the key's fp32 scale (max-abs distances). The BN
statistics are two keys, the running means and the running variances, each
BN leaf measured in units of its own fp32 scale: over ~100 leaves of 8-64
channels the bf16 rounding alone puts one leaf's distance past twice its
own JAX distance (by 17 % at this config), while a misplaced cast moves a
whole layer's statistics by far more than the worst leaf's rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.models import ModelConfig as JaxModelConfig
from multitask_bonetumor_yolo_tpu.models import MultitaskModel as JaxMultitaskModel
from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, MultitaskModel
from test_torch_model import B, CFG, IMG, jax_variables, one_torch_thread  # noqa: F401

BF16 = {**CFG, "dtype": "bfloat16"}
FORWARDS = {"train": (True, "train"), "infer": (False, "infer")}


def _np(t):
    return [_np(a)[0] for a in t] if isinstance(t, (list, tuple)) else [
        np.asarray(t, np.float32)]


def _jax(variables, x, dtype, train, mode):
    """JAX outputs (every key a list of fp32 arrays), the pooled P5, and the
    BN statistics after the forward as a torch state_dict."""
    model = JaxMultitaskModel(JaxModelConfig(**{**CFG, "dtype": dtype}))
    with jax.default_matmul_precision("highest"):
        out, mut = jax.jit(lambda v, x: model.apply(
            v, x, train=train, mode=mode, mutable=["batch_stats"],
            capture_intermediates=lambda mdl, _: mdl.name == "neck"))(variables, jnp.asarray(x))
    got = {k: _np(v) for k, v in out.items()}
    p5 = np.asarray(mut["intermediates"]["neck"]["__call__"][0][2], np.float32)
    got["pooled_p5"] = [p5.mean((1, 2))]
    stats = flax_to_torch(jax.tree.map(np.asarray, variables["params"]),
                          jax.tree.map(np.asarray, mut["batch_stats"]))
    return got, stats


def _port(variables, x, train, mode):
    model = MultitaskModel(ModelConfig(**BF16))
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]),
                          strict=True)
    model = model.to(memory_format=torch.channels_last)
    seen = {}

    def keep_p5(module, inputs, outs):  # returns None: the output stays as it is
        seen["p5"] = outs[2]

    model.neck.register_forward_hook(keep_p5)
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=train, mode=mode)
    got = {k: [t.float().numpy() for t in v] if isinstance(v, list) else [v.float().numpy()]
           for k, v in out.items()}
    got["pooled_p5"] = [seen["p5"].float().mean((2, 3)).numpy()]
    return got, model.state_dict()


@pytest.fixture(scope="module")
def runs():
    variables = jax_variables(CFG)
    x = np.random.RandomState(1).rand(B, IMG, IMG, 3).astype(np.float32)
    return {name: {"jax16": _jax(variables, x, "bfloat16", *tm),
                   "jax32": _jax(variables, x, "float32", *tm),
                   "port16": _port(variables, x, *tm)}
            for name, tm in FORWARDS.items()}


def _within_rule(port, j16, j32, what):
    e = np.abs(port - j16).max()
    r = np.abs(j16 - j32).max()
    bound = 2.0 * r + 1e-3 * np.abs(j32).max()
    assert e <= bound, f"{what}: port-JAX bf16 {e:.3e}, JAX bf16-fp32 {r:.3e}, bound {bound:.3e}"


@pytest.mark.parametrize("forward", list(FORWARDS))
def test_bf16_outputs_match_jax(runs, forward):
    """Every output key of the forward (each ``det_feats`` level apart), and
    the pooled P5, within the rule; the port's keys are JAX's."""
    run = runs[forward]
    port, j16, j32 = run["port16"][0], run["jax16"][0], run["jax32"][0]
    assert port.keys() == j16.keys()
    for key in j16:
        assert len(port[key]) == len(j16[key]), key
        for i, (p, a, b) in enumerate(zip(port[key], j16[key], j32[key])):
            assert p.shape == a.shape, (key, i)
            _within_rule(p, a, b, f"{forward} {key}[{i}]")


@pytest.mark.parametrize("stat", ["running_mean", "running_var"])
def test_bf16_bn_statistics_match_jax(runs, stat):
    """After the training forward, every BN leaf's running statistic within
    the rule, the leaves pooled into one key in units of each leaf's fp32
    scale; inference moves none of them in either package."""
    run = runs["train"]
    port, j16, j32 = run["port16"][1], run["jax16"][1], run["jax32"][1]
    keys = sorted(k for k in j32 if k.endswith(stat))
    assert len(keys) > 50
    scale = [max(j32[k].abs().max().item(), 1e-12) for k in keys]
    unit = lambda sd: np.concatenate([sd[k].numpy() / s for k, s in zip(keys, scale)])  # noqa: E731
    _within_rule(unit(port), unit(j16), unit(j32), stat)
    before = flax_to_torch(*(jax.tree.map(np.asarray, jax_variables(CFG)[c])
                             for c in ("params", "batch_stats")))
    infer = runs["infer"]
    for k in keys:
        assert torch.equal(infer["port16"][1][k], before[k]), k
        assert torch.equal(infer["jax16"][1][k], before[k]), k
