"""The port's whole inference slice against the JAX model, on the CPU.

The JAX ``MultitaskModel`` at the oracle config of
tests/test_reference_oracle.py (img 160, dims 16/32/48/64, depths 1/1/2/1,
BiFPN 64, proto 8) with every parameter and BN statistic perturbed, run with
``pallas="off", train=False, mode="infer"`` at full fp32 matmul precision;
its weights go through the bridge into the port, which runs the same input
in fp32 on the CPU. Every output key must agree at the oracle tolerances
(atol 2e-3, rtol 1e-3).

The weights come from the port's seeded initialisation (the Flax
initialisers' distributions, ``models/model.py::init_parameters``), perturbed
with numpy, and reach the JAX model through the inverse of the bridge
(:func:`jax_variables`): initialising the JAX model op by op takes ~40 s on
the CPU, tracing it for its shapes ~3 s.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.models import ModelConfig as JaxModelConfig
from multitask_bonetumor_yolo_tpu.models import MultitaskModel as JaxMultitaskModel
from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch, load_npz, save_npz
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, MultitaskModel, build_model

IMG = 160
B = 2
CFG = dict(
    nc_det=2, nc_img=2, proto_ch=8, bifpn_feature_size=64, bifpn_num_layers=2,
    img_size=IMG, single_head=False, dtype="float32", pallas="off",
    backbone_depths=(1, 1, 2, 1), backbone_dims=(16, 32, 48, 64),
)
KEYS = ("det_feats", "seg_coeffs", "protos", "seg_logits", "cls_logits",
        "det_preds", "seg_preds", "cls_probs", "seg_prob")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch single-threaded in this module and in the port's other test
    modules, which import this fixture. The suite runs in several worker
    processes on one machine, and torch's default of one OpenMP thread per
    core oversubscribes it: beside six busy processes on 8 cores the train
    slice's tests took 20-50 s each instead of ~1 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(cfg, seed=0):
    """Flax ``{params, batch_stats}`` for ``JaxModelConfig(**cfg)``: the
    port's weights from ``build_model(seed)`` with every parameter and BN
    statistic perturbed as tests/test_reference_oracle.py does (running
    variances x U(0.7, 1.4), everything else + 0.05 N(0, 1)), so BN stats,
    LN scales and layer-scale gammas are non-degenerate.

    The bridge's per-leaf rules are transposes and flips, so its inverse is
    read off the bridge applied to Flax trees holding each element's own
    index (exact in fp32 below 2^24 elements)."""
    shapes = jax.eval_shape(
        lambda x: JaxMultitaskModel(JaxModelConfig(**cfg)).init(
            jax.random.PRNGKey(0), x, train=False, mode="train"),
        jax.ShapeDtypeStruct((1, cfg["img_size"], cfg["img_size"], 3), jnp.float32))
    leaves, treedef = jax.tree.flatten(shapes)
    ends = np.cumsum([math.prod(leaf.shape) for leaf in leaves])
    starts = ends - [math.prod(leaf.shape) for leaf in leaves]
    assert ends[-1] < 2 ** 24
    coded = jax.tree.unflatten(treedef, [
        np.arange(a, b, dtype=np.float32).reshape(leaf.shape)
        for a, b, leaf in zip(starts, ends, leaves)])
    index = flax_to_torch(coded["params"], coded["batch_stats"])
    sd = build_model(ModelConfig(**cfg), seed=seed).state_dict()
    rs = np.random.RandomState(seed)
    flat = np.full(ends[-1], np.nan, np.float32)
    for key, idx in index.items():
        if key.endswith("num_batches_tracked"):
            continue
        v = sd[key].numpy()
        if key.endswith("running_var"):
            v = v * rs.uniform(0.7, 1.4, v.shape)
        else:
            v = v + 0.05 * rs.randn(*v.shape)
        flat[idx.numpy().astype(np.int64)] = v
    assert not np.isnan(flat).any()
    return jax.tree.unflatten(treedef, [flat[a:b].reshape(leaf.shape)
                                        for a, b, leaf in zip(starts, ends, leaves)])


@pytest.fixture(scope="module")
def jax_run():
    model = JaxMultitaskModel(JaxModelConfig(**CFG))
    x = np.random.RandomState(1).rand(B, IMG, IMG, 3).astype(np.float32)
    variables = jax_variables(CFG)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, x: model.apply(v, x, train=False, mode="infer"))(
            variables, jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    return x, out, params, stats


def _port(params, stats, **over):
    model = MultitaskModel(ModelConfig(**{**CFG, **over}))
    model.load_state_dict(flax_to_torch(params, stats), strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def _assert_outputs_match(out, got):
    for key in KEYS:
        want = out[key]
        if key == "det_feats":
            for i, (a, b) in enumerate(zip(want, got[key])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3,
                                           rtol=1e-3, err_msg=f"{key}[{i}]")
            continue
        assert tuple(got[key].shape) == tuple(want.shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want), atol=2e-3,
                                   rtol=1e-3, err_msg=key)


def test_infer_slice_matches_jax(jax_run):
    x, out, params, stats = jax_run
    model = _port(params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False, mode="infer")
    _assert_outputs_match(out, got)


def test_bridge_npz_roundtrip(jax_run, tmp_path):
    """save_npz -> load_npz -> flax_to_torch gives the same state_dict, and
    the port's own state_dict has exactly the bridged keys."""
    _, _, params, stats = jax_run
    path = str(tmp_path / "w.npz")
    save_npz(path, params, stats)
    sd_a = flax_to_torch(params, stats)
    sd_b = flax_to_torch(*load_npz(path))
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    assert set(MultitaskModel(ModelConfig(**CFG)).state_dict()) == set(sd_a)


def test_kernel_route_on_cpu_matches_jax(jax_run):
    """pallas="on" on a CPU tensor runs the kernel's plain twin (tanh-GELU):
    still within the oracle tolerance of the erf reference, and no launch."""
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels.convnext_block import (
        convnext_block,
    )

    x, out, params, stats = jax_run
    before = convnext_block.launches
    model = _port(params, stats, pallas="on")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert convnext_block.launches == before
    np.testing.assert_allclose(got["cls_logits"].numpy(), np.asarray(out["cls_logits"]),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["det_preds"].numpy(), np.asarray(out["det_preds"]),
                               atol=2e-3, rtol=1e-3)


def test_v2_single_head_slices_seg_preds(jax_run):
    _, _, params, stats = jax_run
    seg_only = {k: v for k, v in params.items() if k != "detect"}
    stats_only = {k: v for k, v in stats.items() if k != "detect"}
    model = MultitaskModel(ModelConfig(**{**CFG, "single_head": True}))
    model.load_state_dict(flax_to_torch(seg_only, stats_only), strict=True)
    x = torch.from_numpy(np.random.RandomState(2).rand(1, IMG, IMG, 3).astype(np.float32))
    with torch.no_grad():
        got = model.eval()(x)
    assert torch.equal(got["det_preds"], got["seg_preds"][..., :6])


def test_train_modes_raise():
    """The train modes are ported (tests/test_torch_train.py); the one
    combination nothing runs still raises, and so does an unknown mode."""
    model = MultitaskModel(ModelConfig(**CFG))
    x = torch.zeros(1, IMG, IMG, 3)
    with pytest.raises(NotImplementedError):
        model(x, train=True, mode="infer")
    with pytest.raises(ValueError):
        model(x, train=False, mode="eval")


def test_infer_batch_serves_uint8_images(jax_run):
    """The CLI's serving entry point: uint8 letterboxed NHWC images in, the
    model dict + fixed-shape NMS result + instance masks out."""
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch

    _, _, params, stats = jax_run
    model = _port(params, stats)
    imgs = np.random.RandomState(3).randint(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    res = infer_batch(model, imgs, conf_thresh=0.0, top_k=7, instance_masks=True)
    assert res.detections.boxes.shape == (2, 7, 4)
    assert res.instance_masks.shape == (2, 7, IMG, IMG)
    assert res.outputs["det_preds"].shape[:2] == (2, 20 * 20 + 10 * 10 + 5 * 5)
    assert bool(res.detections.valid.all())
    assert torch.isfinite(res.outputs["seg_prob"]).all()
