"""The port at ConvNeXt-Base's widths on the CPU, torch only.

* The model on its eager path (``pallas="off"``, fp32) against the
  benchmark's plain reference (``h100_bench/reference``) at Base's trunk
  widths 128/256/512/1024, cut only in depth (1/1/2/1) and size (64^2, a
  BiFPN of 32), v1, the benchmark's seeded weights: the served outputs and
  one train step.
* K1's plain twins (both forms) and K2's at C = 512, the width that Base's
  27 stage-2 blocks run on the kernels, against the eager block and its
  autograd backward in fp32: they differ by the tanh form of GELU that the
  kernels compute against the eager block's exact (erf) GELU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from h100_bench import compare, harness, inputs, weights
from h100_bench.reference import optim
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2

BASE = dict(nc_det=2, nc_img=2, proto_ch=32, bifpn_feature_size=32, bifpn_num_layers=2,
            img_size=64, reg_max=16, single_head=False, backbone_depths=[1, 1, 2, 1],
            backbone_dims=[128, 256, 512, 1024], eval_bn="frozen", pallas="off",
            block_bwd="auto", dtype="float32")
TRAIN = {"lr": 1e-4, "weight_decay": 5e-4, "grad_clip": 10.0}
# max over t of |gelu_tanh(t) - gelu_erf(t)| and of the slopes' difference
# (float64 on a grid of step 1.2e-5 over [-12, 12]; both vanish outside it)
GELU_GAP, GELU_SLOPE_GAP = 4.733e-4, 8.685e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_served_outputs_match_the_reference_at_base_widths():
    """Both sides fp32 from the same weights, so they differ only by the
    order of fp32 sums: each served output within 1e-5 of its scale (the
    Tiny-ratio test's tolerance in ``h100_bench/tests``)."""
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch

    state = weights.make_state(BASE, 21, "cpu")
    prog = harness.program_model(BASE, state, torch.device("cpu"))
    ref = harness.reference_model(BASE, state)
    x = inputs.radiographs(2, 64, torch.Generator().manual_seed(22),
                           {"aspect": [0.6, 1.0], "lesions": 4, "noise": 8.0})
    res = infer_batch(prog, x.numpy(), conf_thresh=0.05, nms_iou=0.6, top_k=100,
                      instance_masks=False)
    with torch.no_grad():
        out = ref(x.float() / 255.0)
    for k in ("det_preds", "seg_preds", "seg_coeffs", "protos", "cls_probs", "seg_prob"):
        scale = out[k].abs().max().item()
        assert (res.outputs[k].float() - out[k]).abs().max().item() <= 1e-5 * max(scale, 1.0), k


def test_one_train_step_matches_the_reference_at_base_widths():
    """One step from the same weights: the loss terms and the gradient norm
    within 1e-5 (fp32 round-off, as above), and each parameter's change by
    the benchmark's leaf measure within 1e-2 (Adam moves an element by
    about lr whatever its gradient's size, so a gradient at round-off level
    can step either way; the leaves that round-off alone moves are left
    out, as ``h100_bench/tests`` does)."""
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.train import (TrainConfig, create_train_state,
                                                          make_train_step)

    state = weights.make_state(BASE, 23, "cpu")
    mcfg = harness.model_config(BASE)
    prog = harness.program_model(BASE, state, torch.device("cpu"))
    ts = create_train_state(mcfg, TrainConfig(**TRAIN), model=prog)
    step = make_train_step(mcfg, LossConfig(img_size=64, assigner="tal"))
    ref = harness.reference_model(BASE, state, clone=True)
    opt = optim.AdamW([p for _, p in ref.named_parameters()], **TRAIN)
    batch = inputs.train_batches(1, 2, 64, torch.Generator().manual_seed(24),
                                 {"boxes": 3, "slots": 8})[0]
    _, m, _ = step(ts, batch, None)
    terms, norm, grads, _ = optim.train_step(ref, opt, batch, "tal")
    for k, v in terms.items():
        assert abs(float(m[f"loss_{k}"]) - float(v)) <= 1e-5 * float(terms["total"]), k
    assert abs(float(m["grad_norm"]) - float(norm)) <= 1e-5 * float(norm)
    g1 = {k: g.norm() for k, g in grads.items()}
    med = torch.stack(list(g1.values())).median()
    names = [k for k, g in g1.items() if g >= 1e-3 * med]
    ps, rs = prog.state_dict(), ref.state_dict()
    delta = lambda sd: {k: sd[k].float() - state[k].float() for k in names}  # noqa: E731
    assert compare._leaf_gaps(delta(ps), delta(rs), names)[0].max() < 1e-2


def block_512(seed=25):
    """fp32 block inputs at C = 512 in the port's layouts (gamma ~0.5)."""
    rs = np.random.RandomState(seed)
    c = 512

    def f(*s, scale=0.05):
        return torch.from_numpy(rs.randn(*s).astype(np.float32) * scale)

    x = f(2, 5, 6, c, scale=1.0)
    params = [f(c, 1, 7, 7, scale=0.1), f(c), f(c) + 1.0, f(c), f(4 * c, c, scale=0.03),
              f(4 * c), f(c, 4 * c, scale=0.03), f(c), f(c) + 0.5]
    return x, params


def test_k1_twins_match_the_eager_block_at_512():
    """Both forms of K1's twin against the eager block in fp32. ``y`` (the
    depthwise output plus bias) has no GELU in it: within fp32 round-off.
    ``out``: the twins' GELU is within GELU_GAP of the eager block's exact
    one at every hidden unit, so channel c of the output moves by at most
    GELU_GAP * sum_j |gamma_c w2[c, j]| (plus round-off); the saving form's
    ``out`` is the inference form's bit for bit."""
    x, params = block_512()
    out = cnb.convnext_block_plain(x, *params)
    out_s, y = cnb.convnext_block_plain_saving(x, *params)
    want = cnb.convnext_block_ref(x, *params)
    dw_kernel, dw_bias, *_, w2, _, gamma = params
    want_y = F.conv2d(x.permute(0, 3, 1, 2), dw_kernel, dw_bias, padding=3,
                      groups=512).permute(0, 2, 3, 1)
    assert torch.equal(out, out_s)
    assert (y - want_y).abs().max().item() <= 1e-5 * want_y.abs().max().item()
    bound = GELU_GAP * (gamma[:, None] * w2).abs().sum(1)
    gap = (out - want).abs().amax((0, 1, 2))
    assert bool((gap <= bound + 1e-5 * want.abs().max()).all()), (gap - bound).max()
    assert gap.max().item() > 1e-3 * bound.max().item()  # the GELU forms do differ


def test_k2_twin_matches_eager_autograd_at_512():
    """K2's twin (on its saving form's ``y``) against autograd of the eager
    block, fp32, one cotangent: every gradient within 2 * GELU_SLOPE_GAP of
    its own scale. The two backwards differ by the slope of GELU (tanh form
    against erf), by at most GELU_SLOPE_GAP at each hidden unit, and by
    GELU_GAP in the activation that dw2 and dgamma take, small shares of a
    slope and an activation of order one; on these inputs the gradients
    differ by at most 3.7e-4 of their scale, a quarter of the limit. The same
    twin against autograd of K1's twin, which has the kernels' GELU:
    within 1e-5 of each scale (fp32 round-off)."""
    x, params = block_512()
    g = torch.from_numpy(np.random.RandomState(26).randn(*x.shape).astype(np.float32))
    _, y = cnb.convnext_block_plain_saving(x, *params)
    got = k2.convnext_block_bwd_plain(x, y, g, *params)
    leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
    for fwd, tol in ((cnb.convnext_block_ref, 2 * GELU_SLOPE_GAP),
                     (cnb.convnext_block_plain, 1e-5)):
        want = torch.autograd.grad(fwd(*leaves), leaves, g)
        for i, (a, b) in enumerate(zip(got, want)):
            a = a.reshape(b.shape)
            err = (a - b).abs().max().item()
            assert err <= tol * b.abs().max().item(), (fwd.__name__, i, err)
