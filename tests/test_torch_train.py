"""The port's train slice against the JAX package, on the CPU.

One JAX model at the oracle config of tests/test_torch_model.py (img 160,
dims 16/32/48/64, depths 1/1/2/1, BiFPN 64, proto 8, fp32, ``pallas="off"``),
with that file's weights (the port's seeded initialisation, every parameter
and BN statistic perturbed, carried into Flax trees by the inverse of the
bridge) and a seeded synthetic batch (uint8 images, a few boxes per image,
box-shaped masks, random image classes), all made with numpy. The port takes
the same weights through the bridge. ``iou_match_thresh`` is 0.1 so that
random weights give positives and every loss term takes part.

The module fixture runs JAX's train step (``train/steps.py::make_train_step``)
as its two halves: the step's ``loss_fn`` under a jitted ``value_and_grad``
(the loss, its gradient, the train-mode outputs and the new BN statistics,
``mutable=["batch_stats"]``), then the JAX ``TrainState.apply_gradients``
(optax clip + AdamW + the non-finite skip) on the parameters and gradients
flattened into one leaf: optax's update is elementwise but for the global
norm, which is the same over one flat leaf. Jitting ``make_train_step``
whole takes more than five minutes to compile on the CPU at this config
(measured), where the halves take ~15 s. It also runs the validation
forward (``train=False, mode="train"``), jitted.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.losses import LossConfig as JaxLossConfig
from multitask_bonetumor_yolo_tpu.losses import multitask_loss as jax_multitask_loss
from multitask_bonetumor_yolo_tpu.models import ModelConfig as JaxModelConfig
from multitask_bonetumor_yolo_tpu.models import MultitaskModel as JaxMultitaskModel
from multitask_bonetumor_yolo_tpu.train.state import TrainConfig as JaxTrainConfig
from multitask_bonetumor_yolo_tpu.train.state import TrainState as JaxTrainState
from multitask_bonetumor_yolo_tpu.train.state import make_optimizer
from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch
from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig, multitask_loss
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, MultitaskModel
from multitask_bonetumor_yolo_tpu_torch.train import (
    TrainConfig, create_train_state, make_train_step,
)
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (autouse)

IMG = 160
B = 2
M = 4  # padded GT boxes per image
CFG = dict(
    nc_det=2, nc_img=2, proto_ch=8, bifpn_feature_size=64, bifpn_num_layers=2,
    img_size=IMG, single_head=False, dtype="float32", pallas="off",
    backbone_depths=(1, 1, 2, 1), backbone_dims=(16, 32, 48, 64),
)
LOSS = dict(img_size=IMG, nc_det=2, iou_match_thresh=0.1)
TRAIN = dict(lr=1e-3, max_epochs=2, steps_per_epoch=5)
TRAIN_KEYS = ("det_feats", "seg_coeffs", "protos", "seg_logits", "cls_logits")


def make_batch(seed=1):
    rs = np.random.RandomState(seed)
    boxes = np.zeros((B, M, 5), np.float32)
    valid = np.zeros((B, M), bool)
    mask = np.zeros((B, IMG, IMG, 1), np.float32)
    for i, n in enumerate((3, 2)):
        valid[i, :n] = True
        boxes[i, :n, 0] = rs.randint(0, 2, n)
        boxes[i, :n, 1:3] = rs.uniform(0.3, 0.7, (n, 2))
        boxes[i, :n, 3:5] = rs.uniform(0.2, 0.5, (n, 2))
        for cls, xc, yc, w, h in boxes[i, :n]:
            x0, x1 = int((xc - w / 2) * IMG), int((xc + w / 2) * IMG)
            y0, y1 = int((yc - h / 2) * IMG), int((yc + h / 2) * IMG)
            mask[i, y0:y1, x0:x1] = 1.0
    return {
        "image": rs.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
        "boxes": boxes, "box_valid": valid, "mask": mask,
        "img_cls": rs.randint(0, 2, B).astype(np.int32),
        "id": np.arange(B, dtype=np.int32),
    }


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def _unflat(flat, like):
    leaves, treedef = jax.tree.flatten(like)
    sizes = np.cumsum([0] + [np.size(a) for a in leaves])
    return jax.tree.unflatten(treedef, [np.asarray(flat[a:b]).reshape(np.shape(x))
                                        for a, b, x in zip(sizes[:-1], sizes[1:], leaves)])


def adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside the optax chain's state."""
    found = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def port_moments(state):
    """The port's flat AdamW moments as ``{parameter name: (mu, nu)}``."""
    names, params = zip(*state.model.named_parameters())
    sizes = [p.numel() for p in params]
    return {n: (m.view_as(p), v.view_as(p)) for n, p, m, v in
            zip(names, params, state.mu.split(sizes), state.nu.split(sizes))}


@pytest.fixture(scope="module")
def jax_run():
    from multitask_bonetumor_yolo_tpu.data.preprocess import AugmentConfig, augment_batch

    model = JaxMultitaskModel(JaxModelConfig(**CFG))
    batch = make_batch()
    loss_cfg = JaxLossConfig(**LOSS)
    jb = augment_batch({k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3),
                       AugmentConfig())
    variables = jax_variables(CFG)
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def loss_and_grad(p):  # make_train_step's loss_fn
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, jb["image"],
                                   train=True, mode="train", mutable=["batch_stats"])
            lo = jax_multitask_loss(out, jb, loss_cfg, train=True)
            return lo.total, (lo, upd["batch_stats"], out)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (total, (lo, new_stats, out)), grads = loss_and_grad(params)
    val_out, val_stats = jax.jit(lambda v, x: model.apply(
        v, x, train=False, mode="train", mutable=["batch_stats"]))(variables, jb["image"])
    tx = make_optimizer(JaxTrainConfig(**TRAIN))
    flat = {"w": jnp.asarray(_flat(params))}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=flat, batch_stats=new_stats,
                          opt_state=tx.init(flat), tx=tx)
    new_state, ok = jax.jit(lambda st, g: st.apply_gradients(grads=g, batch_stats=new_stats))(
        state, {"w": jnp.asarray(_flat(grads))})
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    adam = adam_state(new_state.opt_state)
    # optax's global norm, summed in fp64 (the step's ``optax_global_norm``)
    grad_norm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                            for g in jax.tree.leaves(grads)))
    metrics = {"loss_total": total, **{f"loss_{k}": v for k, v in lo.components.items()},
               "num_pos": lo.num_pos, "avg_iou": lo.avg_iou,
               "grad_norm": grad_norm, "step_skipped": 1.0 - float(ok)}
    return dict(
        batch=batch, params=np_tree(params), stats=np_tree(stats), total=float(total),
        out=np_tree(out), new_stats=np_tree(new_stats), grads=np_tree(grads),
        val_out=np_tree(val_out), val_stats=np_tree(val_stats["batch_stats"]),
        step_params=_unflat(np.asarray(new_state.params["w"]), np_tree(params)),
        step_stats=np_tree(new_state.batch_stats),
        step_mu=_unflat(np.asarray(adam.mu["w"]), np_tree(params)),
        step_nu=_unflat(np.asarray(adam.nu["w"]), np_tree(params)),
        metrics={k: float(v) for k, v in metrics.items()},
    )


def _port(run, **over):
    model = MultitaskModel(ModelConfig(**{**CFG, **over}))
    model.load_state_dict(flax_to_torch(run["params"], run["stats"]), strict=True)
    return model.to(memory_format=torch.channels_last)


def _image(run):
    return torch.from_numpy(run["batch"]["image"]).float() / 255.0


def _assert_tree(got_sd, want_sd, keys, atol, rtol, what):
    for k in keys:
        np.testing.assert_allclose(got_sd[k].detach().numpy(), want_sd[k].numpy(),
                                   atol=atol, rtol=rtol, err_msg=f"{what} {k}")


def _assert_out(got, want, atol=2e-3, rtol=1e-3):
    assert set(got) == set(TRAIN_KEYS)
    for key in TRAIN_KEYS:
        w, g = want[key], got[key]
        pairs = zip(w, g) if key == "det_feats" else [(w, g)]
        for a, b in pairs:
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, rtol=rtol,
                                       err_msg=key)


def _bn_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


@pytest.mark.parametrize("train", [True, False])
def test_train_mode_forward_and_bn_stats_match_jax(jax_run, train):
    """``mode="train"`` outputs (train=True: body and heads on batch
    statistics; train=False: the validation forward, heads only) at the
    oracle tolerances (atol 2e-3, rtol 1e-3), and every BN running statistic
    after the forward at 1e-5 (Flax momentum, biased variance)."""
    run = jax_run
    model = _port(run)
    got = model(_image(run), train=train, mode="train")
    _assert_out(got, run["out"] if train else run["val_out"])
    want = flax_to_torch(run["params"], run["new_stats"] if train else run["val_stats"])
    sd = model.state_dict()
    _assert_tree(sd, want, _bn_keys(sd), 1e-5, 1e-5, "bn")
    if not train:  # body statistics do not move in the validation forward
        before = flax_to_torch(run["params"], run["stats"])
        assert torch.equal(sd["neck.p3_proj.ConvBN_0.BatchNorm_0.running_mean"],
                           before["neck.p3_proj.ConvBN_0.BatchNorm_0.running_mean"])


@pytest.mark.parametrize("assigner", ["reference", "tal"])
def test_loss_matches_jax(jax_run, assigner):
    """``multitask_loss`` on the same model outputs and batch: total, the five
    terms, num_pos and avg_iou at rtol 1e-5 (fp32, same formulas)."""
    run = jax_run
    batch = {k: v for k, v in run["batch"].items() if k != "image"}
    cfg = dict(LOSS, assigner=assigner)
    want = jax.jit(lambda o, b: jax_multitask_loss(o, b, JaxLossConfig(**cfg), train=True))(
        jax.tree.map(jnp.asarray, run["out"]), {k: jnp.asarray(v) for k, v in batch.items()})
    out = {k: [torch.from_numpy(t) for t in v] if k == "det_feats" else torch.from_numpy(v)
           for k, v in run["out"].items()}
    got = multitask_loss(out, to_torch(batch), LossConfig(**cfg), train=True)
    assert float(want.num_pos) > 0
    pairs = [(got.total, want.total), (got.num_pos, want.num_pos), (got.avg_iou, want.avg_iou)]
    pairs += [(got.components[k], want.components[k]) for k in want.components]
    for g, w in pairs:
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)
    assert torch.equal(got.matched_mask, torch.from_numpy(np.asarray(want.matched_mask)))


def test_param_gradients_match_jax(jax_run):
    """The loss gradient of every parameter with ``pallas="off"`` (eager
    blocks under autograd), in the port's layouts via the bridge: each within
    2e-3 of its own scale, plus 1e-6 of the largest gradient's (max |got -
    want| <= 2e-3 * max |want| + 1e-6 * max over all |want|: the bias of a
    conv in front of a train-mode BN has a zero gradient in exact arithmetic,
    rounding noise of ~1e-7 in both packages); the loss itself at rtol
    1e-5."""
    run = jax_run
    model = _port(run)
    lo = multitask_loss(model(_image(run), train=True, mode="train"),
                        to_torch({k: v for k, v in run["batch"].items() if k != "image"}),
                        LossConfig(**LOSS), train=True)
    np.testing.assert_allclose(lo.total.item(), run["total"], rtol=1e-5)
    lo.total.backward()
    want = flax_to_torch(run["grads"], run["stats"])
    floor = 1e-6 * max(np.abs(want[n].numpy()).max() for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        # v1 in train mode leaves the Segment head's box/class towers unused:
        # no gradient in the port, zeros in JAX
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(g - w).max()
        assert err <= 2e-3 * np.abs(w).max() + floor, (name, err, np.abs(w).max())


def test_train_step_matches_jax(jax_run):
    """One ``make_train_step`` step from the same weights and batch: the
    metrics at rtol 1e-4; the BN statistics at 1e-5; the state's counters
    advanced; AdamW's moments against optax's at the gradients' tolerance of
    test_param_gradients_match_jax (mu = 0.1 g within 2e-3 of each tensor's
    scale, nu = 1e-3 g^2 within 5e-3 as the square doubles the relative
    error, each plus 1e-6 of the largest over all tensors); and each
    parameter's change p1 - p0 against JAX's change at rtol 1e-3 plus two
    fp32 spacings of p1 (its rounding in each package), on the elements whose
    gradient is at least 10x that tolerance, where the two gradients cannot
    differ in sign. AdamW's first step moves a weight by lr * (g / (|g| +
    eps) + wd * p), so a step that did not update, or updated from wrong
    moments, fails there. Every parameter is also within 2 lr + 1e-5 of
    JAX's (the bound of tests/test_train_fast.py). The clip, the decay and a
    second step are held against optax on shared gradients in
    tests/test_torch_train_state.py."""
    run = jax_run
    model = _port(run)
    state = create_train_state(model.cfg, TrainConfig(**TRAIN), model=model)
    step = make_train_step(model.cfg, LossConfig(**LOSS))
    state, metrics, aux = step(state, to_torch(run["batch"]), torch.Generator().manual_seed(3))
    assert set(metrics) == set(run["metrics"])
    for k, v in run["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(metrics["step_skipped"]) == 0.0
    assert (state.step, int(state.count)) == (1, 1)
    names = [n for n, _ in model.named_parameters()]
    want = flax_to_torch(run["step_params"], run["step_stats"])
    sd = model.state_dict()
    _assert_tree(sd, want, names, 2 * TRAIN["lr"] + 1e-5, 0, "param")
    _assert_tree(sd, want, _bn_keys(sd), 1e-5, 1e-5, "bn")
    assert aux["seg_prob"].shape == (B, IMG, IMG, 1) and aux["cls_logits"].shape == (B, 2)

    before, grads, mu, nu = (
        {n: v.numpy() for n, v in flax_to_torch(run[k], run["stats"]).items() if n in names}
        for k in ("params", "grads", "step_mu", "step_nu"))
    moments = port_moments(state)
    top = {k: max(np.abs(t).max() for t in d.values())
           for k, d in (("g", grads), ("mu", mu), ("nu", nu))}
    held = 0
    for name in names:
        got_mu, got_nu = (t.numpy() for t in moments[name])
        assert np.abs(got_mu - mu[name]).max() <= (
            2e-3 * np.abs(mu[name]).max() + 1e-6 * top["mu"]), ("mu", name)
        assert np.abs(got_nu - nu[name]).max() <= (
            5e-3 * np.abs(nu[name]).max() + 1e-6 * top["nu"]), ("nu", name)
        g = grads[name]
        strong = np.abs(g) >= 10 * (2e-3 * np.abs(g).max() + 1e-6 * top["g"])
        p1 = want[name].numpy()
        d_got = sd[name].numpy().astype(np.float64) - before[name]
        d_want = p1.astype(np.float64) - before[name]
        lim = 1e-3 * np.abs(d_want) + 2 * np.spacing(np.abs(p1))
        err = np.abs(d_got - d_want)
        assert (err <= lim)[strong].all(), ("change", name, (err - lim)[strong].max())
        held += int(strong.sum())
    total = sum(g.size for g in grads.values())
    assert held >= total // 2, (held, total)


def test_kernel_route_trains_on_cpu(jax_run, monkeypatch):
    """``pallas="on"`` on the CPU trains through the kernels' plain versions
    (K1's saving form and K2's plain backward, tanh-GELU) on every stage
    under ``block_bwd="fused"``, and no kernel launches. Per parameter the
    loss gradient stays within 1e-4 of its scale of the eager path's with
    the same tanh-GELU, and no farther from the eager erf path's than twice
    the tanh-GELU eager path is (each plus 1e-6 of the largest gradient's:
    the zero gradients of conv biases in front of train-mode BN are rounding
    noise). The two GELUs alone part by up to 2.6 % of a gradient's scale at
    this config (the ``b2`` of a stage-1 block)."""
    import torch.nn.functional as F

    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2

    run = jax_run
    counts = (cnb.convnext_block.launches, cnb.convnext_block_saving.launches,
              k2.convnext_block_bwd.launches)
    gelu = F.gelu
    grads = {}
    for key, over in (("kernel", dict(pallas="on", block_bwd="fused")), ("tanh", {}),
                      ("erf", {})):
        with monkeypatch.context() as m:
            if key == "tanh":  # the eager block's GELU in the kernels' form
                m.setattr(F, "gelu", lambda x, approximate="none": gelu(x, approximate="tanh"))
            model = _port(run, **over)
            lo = multitask_loss(model(_image(run), train=True, mode="train"),
                                to_torch({k: v for k, v in run["batch"].items() if k != "image"}),
                                LossConfig(**LOSS), train=True)
            lo.total.backward()
        grads[key] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert counts == (cnb.convnext_block.launches, cnb.convnext_block_saving.launches,
                      k2.convnext_block_bwd.launches)
    assert grads["kernel"].keys() == grads["erf"].keys() == grads["tanh"].keys()
    floor = 1e-6 * max(g.abs().max().item() for g in grads["erf"].values())
    for name, want in grads["tanh"].items():
        got, erf = grads["kernel"][name], grads["erf"][name]
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + floor, (name, err)
        err = (got - erf).abs().max().item()
        assert err <= 2.0 * (want - erf).abs().max().item() + floor, (name, "erf", err)
