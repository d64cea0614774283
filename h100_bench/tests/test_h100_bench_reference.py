"""The benchmark's plain reference against the program's eager path
(``pallas="off"``, fp32) on the CPU at a small configuration, for both
models, with the benchmark's weights: the served outputs, NMS and masks,
and three train steps. A card test holds the program's kernel path against
the reference on the card at a small size.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench import compare, harness, inputs, weights
from h100_bench.reference import optim, post
from h100_bench.reference.precision import no_tf32

SMALL = dict(nc_det=2, nc_img=2, proto_ch=32, bifpn_feature_size=32, bifpn_num_layers=2,
             img_size=64, reg_max=16, backbone_depths=[1, 1, 2, 1],
             backbone_dims=[16, 32, 64, 128], eval_bn="frozen", pallas="off",
             block_bwd="auto", dtype="float32")
TRAIN = {"lr": 1e-4, "weight_decay": 5e-4, "grad_clip": 10.0}


@pytest.fixture(params=[False, True], ids=["v1", "v2"])
def cfg(request):
    return dict(SMALL, single_head=request.param)


def _ring(cfg, seed, n=4):
    gen = torch.Generator().manual_seed(seed)
    p = {"aspect": [0.6, 1.0], "lesions": 4, "noise": 8.0}
    return inputs.radiographs(n, cfg["img_size"], gen, p)


def test_state_dict_keys_match_the_program(cfg):
    state = weights.make_state(cfg, 3, "cpu")
    prog = harness.program_model(cfg, state, torch.device("cpu"))
    assert set(prog.state_dict()) == set(state)
    ref = harness.reference_model(cfg, state)
    assert set(ref.state_dict()) == set(state)


def test_serve_outputs_nms_and_masks(cfg):
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch

    state = weights.make_state(cfg, 5, "cpu")
    weights.shift_class_bias(state, cfg, 4.0)  # scores high enough to keep boxes
    prog = harness.program_model(cfg, state, torch.device("cpu"))
    ref = harness.reference_model(cfg, state)
    x = _ring(cfg, 6)
    res = infer_batch(prog, x.numpy(), conf_thresh=0.05, nms_iou=0.6, top_k=100,
                      instance_masks=True)
    with torch.no_grad():
        out = ref(x.float() / 255.0)
    for k in ("det_preds", "seg_preds", "seg_coeffs", "protos", "cls_probs", "seg_prob"):
        scale = out[k].abs().max().item()
        assert (res.outputs[k].float() - out[k]).abs().max().item() <= 1e-5 * max(scale, 1.0), k
    det = post.nms(res.outputs["det_preds"], cfg["img_size"], 0.05, 0.6, 100)
    assert bool(det.valid.any(1).all())
    assert torch.equal(det.indices, res.detections.indices)
    assert torch.equal(det.boxes, res.detections.boxes)
    m = post.masks(res.outputs["seg_coeffs"], res.outputs["protos"], res.detections,
                   cfg["img_size"])
    assert torch.equal(m, res.instance_masks)


def test_three_train_steps(cfg):
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.train import (TrainConfig, create_train_state,
                                                          make_train_step)

    state = weights.make_state(cfg, 7, "cpu")
    mcfg = harness.model_config(cfg)
    prog = harness.program_model(cfg, state, torch.device("cpu"))
    ts = create_train_state(mcfg, TrainConfig(**TRAIN), model=prog)
    step = make_train_step(mcfg, LossConfig(img_size=64, assigner="tal"))
    ref = harness.reference_model(cfg, state, clone=True)
    opt = optim.AdamW([p for _, p in ref.named_parameters()], **TRAIN)
    batches = inputs.train_batches(3, 4, 64, torch.Generator().manual_seed(8),
                                   {"boxes": 3, "slots": 8})
    # from the same weights the two agree to fp32 round-off; after it,
    # Adam moves each element by about lr whatever its gradient's size, so
    # where a gradient is at round-off level its sign, and so its step,
    # differs between two fp32 sums
    for i, b in enumerate(batches):
        _, m, _ = step(ts, b, None)
        terms, norm, grads, _ = optim.train_step(ref, opt, b, "tal")
        if i == 0:
            g1 = {k: g.norm() for k, g in grads.items()}
        tol = 1e-5 if i == 0 else 1e-3
        for k, v in terms.items():
            assert abs(float(m[f"loss_{k}"]) - float(v)) <= tol * float(terms["total"]), (i, k)
        assert abs(float(m["grad_norm"]) - float(norm)) <= tol * float(norm), i
    ps, rs = prog.state_dict(), ref.state_dict()
    # the benchmark's measure: each leaf's change by its norm, against the
    # larger of the reference's and the median leaf's, leaving out the
    # leaves that round-off alone moves (a bias before a train-mode BN)
    med = torch.stack(list(g1.values())).median()
    names = [k for k, g in g1.items() if g >= 1e-3 * med]
    delta = lambda sd: {k: sd[k].float() - state[k].float() for k in names}  # noqa: E731
    assert compare._leaf_gaps(delta(ps), delta(rs), names)[0].max() < 1e-2


def test_class_bias_shift_moves_only_the_nms_head(cfg):
    state = weights.make_state(cfg, 9, "cpu")
    before = {k: v.clone() for k, v in state.items()}
    weights.shift_class_bias(state, cfg, 1.5)
    changed = {k for k in state if not torch.equal(state[k], before[k])}
    head = "segment" if cfg["single_head"] else "detect"
    assert changed == {f"{head}.towers.cv3_{i}_2.bias" for i in range(3)}


def test_weights_are_seeded_and_scaled(cfg):
    a = weights.make_state(cfg, 11, "cpu")
    b = weights.make_state(cfg, 11, "cpu")
    c = weights.make_state(cfg, 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cls_fc.weight"], c["cls_fc.weight"])
    w = a["neck.p3_proj.ConvBN_0.Conv_0.weight"]
    assert abs(w.std().item() / np.sqrt(2.0 / w[0].numel()) - 1.0) < 0.1
    var = torch.cat([v for k, v in a.items() if k.endswith("running_var")])
    assert 0.7 <= var.min() and var.max() <= 1.4


@pytest.mark.cuda
def test_kernel_path_near_the_reference_on_the_card(card):
    """The program in bf16 through its kernels against the fp32 reference at
    a small size: within 3e-2 of each served output's scale."""
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch

    cfg = dict(SMALL, single_head=False, img_size=128, dtype="bfloat16", pallas="auto",
               backbone_dims=[96, 192, 384, 768])
    state = weights.make_state(cfg, 13, card)
    prog = harness.program_model(cfg, state, card)
    ref = harness.reference_model(cfg, state)
    x = _ring(cfg, 14).to(card)
    res = infer_batch(prog, x.cpu().numpy(), conf_thresh=0.05, instance_masks=True)
    with torch.no_grad(), no_tf32():
        out = ref(x.float() / 255.0)
    for k in ("cls_probs", "seg_prob"):
        assert (res.outputs[k].float() - out[k]).abs().max().item() < 3e-2, k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


