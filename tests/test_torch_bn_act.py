"""Kernel K7, eval-mode BN + activation + cast in one pass
(``ops/kernels/bn_act.py``, ``csrc/bn_act.cu``), and its route in
``models/common.py::bn_act``.

On the CPU: the route (K7 only for a tensor on the card, BN on running
statistics, no gradient wanted; there K7 refuses a layout or dtype it does
not read rather than giving way to the eager chain), the layouts the
wrapper takes and what it refuses, every eval BN of both models going to
K7 on the card (110 calls per v1 forward, 98 per v2), and the CPU forward
equal bit for bit to the eager chain. A tensor "on the card" here is a CPU
tensor of :class:`OnCard`, which says it is on the card (``is_cuda``, and
with :class:`CardDevice` ``device`` too, for the wrapper's checks); the
route and the checks read nothing else of it.

Tests marked ``cuda`` skip without a card. The file imports no JAX; on the
GPU machine run them without the tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_bn_act.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model, common
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import bn_act as k7

ACTS = ("silu", "elu", "none")
WIDTHS = (32, 64, 128, 192, 256, 384, 512)
TINY = dict(img_size=64, backbone_depths=(1, 1, 1, 1), backbone_dims=(16, 32, 48, 64),
            bifpn_feature_size=32, proto_ch=8, pallas="off")
# eval BN + act calls per forward: C2f adapters 18, BiFPN 59, Segment 21, Detect 12 (v1)
K7_CALLS = {"v1": 110, "v2": 98}


class OnCard(torch.Tensor):
    """A CPU tensor that the route takes for one on the card (``is_cuda``);
    the ops it goes through still make CPU tensors."""

    is_cuda = True


class CardDevice(OnCard):
    """An :class:`OnCard` whose ``device`` is the card too, for the
    wrapper's checks."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_card(t: torch.Tensor, cls=OnCard) -> torch.Tensor:
    return t.as_subclass(cls)


def bn(c: int, requires_grad: bool = True) -> nn.BatchNorm2d:
    m = nn.BatchNorm2d(c).eval()
    m.requires_grad_(requires_grad)
    return m


def channels_last(b, c, h, w, dtype=torch.float32):
    return torch.randn(b, c, h, w).to(dtype).contiguous(memory_format=torch.channels_last)


def eager(x, mean, var, weight, bias, eps, act):
    """The chain as the models ran it before K7: fp32 BN, act, cast."""
    y = F.batch_norm(x.as_subclass(torch.Tensor).float(), mean, var, weight, bias,
                     training=False, eps=eps)
    return {"silu": F.silu, "elu": F.elu, "none": lambda t: t}[act](y).to(x.dtype)


@pytest.fixture
def k7_calls(monkeypatch):
    """K7's wrapper replaced by a recorder of its calls (shape, act, eps)
    that answers with :func:`eager`, as a tensor on the card; each input in
    a layout K7 reads in place."""
    calls = []

    def fake(x, mean, var, weight, bias, eps, act):
        stride, vec = k7.pixel_stride(x), 16 // x.dtype.itemsize
        assert stride is not None and stride % vec == 0 and x.shape[1] % vec == 0
        assert x.data_ptr() % 16 == 0 and mean.dtype == torch.float32
        calls.append((tuple(x.shape), act, eps))
        return on_card(eager(x, mean, var, weight, bias, eps, act))

    monkeypatch.setattr(k7, "bn_act", fake)
    return calls


# ----------------------------------------------------------------- the route
@pytest.mark.parametrize("card,train,grad,params_grad,want", [
    (True, False, False, True, True),    # serving: no_grad, eval BN
    (True, False, True, False, True),    # grad mode on, but nothing requires one
    (True, True, False, True, False),    # train-mode BN (batch statistics)
    (True, False, True, True, False),    # autograd wants the BN parameters' gradient
    (False, False, False, True, False),  # a CPU tensor
])
def test_route(k7_calls, card, train, grad, params_grad, want):
    x = channels_last(2, 16, 5, 6)
    if card:
        x = on_card(x)
    with torch.set_grad_enabled(grad):
        common.bn_act(x, bn(16, params_grad), train, "silu")
    assert len(k7_calls) == want


def test_route_input_requiring_grad_takes_the_eager_chain(k7_calls):
    x = on_card(channels_last(2, 16, 5, 6).requires_grad_())
    common.bn_act(x, bn(16, False), False, "silu")
    assert k7_calls == []
    with torch.no_grad():
        common.bn_act(x, bn(16, False), False, "silu")
    assert len(k7_calls) == 1


LAYOUT = "not a channels-last map"


@pytest.mark.parametrize("x,err,match", [
    (torch.randn(2, 16, 5, 6), ValueError, LAYOUT),                      # NCHW contiguous
    (channels_last(2, 16, 5, 6, torch.float16), TypeError, "dtype"),     # fp16
    (channels_last(2, 12, 5, 6, torch.bfloat16), ValueError, LAYOUT),    # C not a multiple of 8
    (channels_last(2, 16, 5, 6)[:, 2:14], ValueError, LAYOUT),           # off the 16-byte grid
    (channels_last(1, 2048 + 8, 3, 3)[:, :1028], ValueError, LAYOUT),    # over 256 vectors
], ids=["nchw", "fp16", "c12", "misaligned", "too-wide"])
def test_route_refuses_what_k7_does_not_read(x, err, match):
    """On the card, eval, no gradient: K7 or an error, never the eager
    chain in its place."""
    with torch.no_grad(), pytest.raises(err, match=match):
        common.bn_act(on_card(x, CardDevice), bn(x.shape[1]), False, "silu")


def test_route_refuses_a_half_precision_bn():
    m = bn(16).half()
    with torch.no_grad(), pytest.raises(ValueError, match="float16"):
        common.bn_act(on_card(channels_last(2, 16, 5, 6), CardDevice), m, False, "silu")


def test_conv_blocks_call_k7_on_the_card(k7_calls):
    """ConvBN (SiLU), its ``conv_input=False`` form, and DepthwiseConvBlock
    (ELU) hand K7 their BN's running statistics and parameters."""
    conv = common.ConvBN(16, 24, 3, bn_eps=1e-3).eval()
    dw = common.DepthwiseConvBlock(16, 16).eval()
    x = on_card(channels_last(2, 16, 5, 6))
    with torch.no_grad():
        conv(x)
        conv(on_card(channels_last(2, 24, 5, 6)), conv_input=False)
        dw(x)
        conv(x, train=True)  # batch statistics: the eager chain
    assert k7_calls == [((2, 24, 5, 6), "silu", 1e-3), ((2, 24, 5, 6), "silu", 1e-3),
                        ((2, 16, 5, 6), "elu", common.BN_EPS_BODY)]


@pytest.mark.parametrize("act", ACTS)
def test_route_on_cpu_is_the_eager_chain(act):
    m = bn(32)
    nn.init.normal_(m.running_mean)
    x = channels_last(2, 32, 5, 6, torch.bfloat16)
    got = common.bn_act(x, m, False, act)
    want = eager(x, m.running_mean, m.running_var, m.weight, m.bias, m.eps, act)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ------------------------------------------------------------- the wrapper
@pytest.mark.parametrize("shape,cut,want", [
    ((2, 32, 5, 6), None, 32),             # channels_last
    ((2, 320, 5, 6), (64, 320), 320),      # the heads' slice at offset 64 of 320
    ((2, 384, 5, 6), (320, 384), 384),     # the last slice
    ((1, 32, 1, 1), None, 32),             # one pixel
    ((16, 64, 1, 7), None, 64),            # one row
])
def test_pixel_stride(shape, cut, want):
    x = channels_last(*shape)
    if cut:
        x = x[:, cut[0]:cut[1]]
    assert k7.pixel_stride(x) == want
    assert k7.pixel_stride(torch.randn(*shape)) in ((None,) if shape[2] * shape[3] > 1 else
                                                     (None, shape[1]))


@pytest.mark.parametrize("case,err,match", [
    ("dtype", TypeError, "dtype"), ("layout", ValueError, LAYOUT), ("act", ValueError, "gelu"),
    ("params", ValueError, r"mean .*\(31,\)"), ("device", ValueError, "device cpu"),
], ids=["dtype", "layout", "act", "params", "device"])
def test_wrapper_refuses_what_k7_does_not_take(case, err, match):
    c = 32
    m = bn(c)
    x = on_card(channels_last(2, c, 5, 6, torch.bfloat16), CardDevice)
    act = "silu"
    params = (m.running_mean, m.running_var, m.weight.detach(), m.bias.detach())
    if case == "dtype":
        x = x.half()
    elif case == "layout":
        x = x.contiguous()
    elif case == "act":
        act = "gelu"
    elif case == "params":
        params = (m.running_mean[:-1],) + params[1:]
    else:  # a tensor that reports the CPU as its device
        x = on_card(x.as_subclass(torch.Tensor))
    with pytest.raises(err, match=match):
        k7.bn_act(x, *params, m.eps, act)


# ------------------------------------------------------------- the models
@pytest.fixture(scope="module")
def tiny_models():
    """One tiny bf16 model of each variant, its BN statistics drawn away
    from their initial values, shared by the model tests."""
    gen = torch.Generator().manual_seed(3)
    models = {}
    for variant in ("v1", "v2"):
        cfg = ModelConfig(single_head=variant == "v2", dtype="bfloat16", **TINY)
        model = build_model(cfg, seed=0, device="cpu").eval()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        models[variant] = model
    return models


def seed_chain(x, bn_mod, train, act):
    """The chain as the models ran it before K7: BN in fp32, act, cast."""
    return common._act(common.batch_norm_fp32(x, bn_mod, train), act).to(x.dtype)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_every_eval_bn_takes_k7_on_the_card(variant, tiny_models, k7_calls, monkeypatch):
    """The eval forward on a tensor on the card, every op on the CPU: each
    of the 110 (v1) / 98 (v2) BN + act calls goes to K7 in a layout K7
    reads in place, and none under the training forward."""
    eager_calls = []
    monkeypatch.setattr(common, "batch_norm_fp32",
                        lambda x, m, train, f=common.batch_norm_fp32: eager_calls.append(train)
                        or f(x, m, train))
    model = tiny_models[variant]
    x = on_card(torch.rand(1, TINY["img_size"], TINY["img_size"], 3))
    with torch.no_grad():
        model(x, train=False, mode="infer")
    assert len(k7_calls) == K7_CALLS[variant] and eager_calls == []
    acts = [act for _, act, _ in k7_calls]
    assert acts.count("elu") == 8 and acts.count("none") == 0
    k7_calls.clear()
    with torch.no_grad():
        model(x, train=True, mode="train")
    assert k7_calls == [] and len(eager_calls) == K7_CALLS[variant]


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_cpu_forward_is_the_eager_chain_bit_for_bit(variant, tiny_models, monkeypatch):
    model = tiny_models[variant]
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        got = model(x, train=False, mode="infer")
        monkeypatch.setattr(common, "bn_act", seed_chain)
        want = model(x, train=False, mode="infer")
    for k in ("det_preds", "seg_coeffs", "protos", "seg_logits", "cls_logits"):
        a, b = got[k], want[k]
        for ta, tb in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(ta, tb), k


# ------------------------------------------------------------- on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def bn_on(c, dev, seed):
    g = torch.Generator().manual_seed(seed)
    m = nn.BatchNorm2d(c, eps=1e-3).eval()
    with torch.no_grad():
        m.running_mean.normal_(0, 0.5, generator=g)
        m.running_var.uniform_(0.2, 2.0, generator=g)
        m.weight.normal_(1, 0.3, generator=g)
        m.bias.normal_(0, 0.3, generator=g)
    return m.to(dev)


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 steps of ``want``, a step taken no smaller than
    at 2^-12 of ``want``'s largest magnitude: near a zero crossing the
    chain's fp32 rounding (~2^-24 of the BN's shift) moves the value by many
    steps of its own tiny size, whichever side rounds."""
    floor = want.float().abs().max() * 2.0 ** -12
    _, e = torch.frexp(torch.maximum(want.float().abs(), floor))
    return (got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(want.float()), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("sliced", [False, True], ids=["contiguous", "slice"])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", ACTS)
def test_k7_matches_the_eager_chain(dev, act, dtype, c, sliced, batch):
    """K7 against the eager chain (cuDNN's BN, torch's activation and cast)
    on the same input, both through the models' route
    (``common.bn_act``; the eager chain under autograd, the BN's
    parameters requiring a gradient): bf16 equal but for at most 1 step
    (:func:`bf16_steps`) on at most 1 % of the elements; fp32 within 1e-5
    of the output's scale (the two fold the statistics into fp32 values
    that differ in the last bit). A slice reads channels [64, 64 + C) of a
    channels-last map of C + 72 channels, as the heads' fused first conv."""
    m = bn_on(c, dev, c)
    g = torch.Generator(device=dev).manual_seed(c + batch)
    full = torch.randn(batch, c + 72 if sliced else c, 21, 20, generator=g, device=dev) * 2
    full = full.to(dtype).contiguous(memory_format=torch.channels_last)
    x = full[:, 64:64 + c] if sliced else full
    before = k7.bn_act.launches
    with torch.no_grad():
        got = common.bn_act(x, m, False, act)
    with torch.enable_grad():
        want = common.bn_act(x, m, False, act).detach()
    torch.cuda.synchronize()
    assert k7.bn_act.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:
        assert bf16_steps(got, want).max().item() <= 1
        assert (got != want).float().mean().item() <= 0.01
    else:
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    with torch.no_grad():
        assert torch.equal(common.bn_act(x, m, False, act), got)  # the same bits again


def rms_gap(a, b) -> float:
    a = torch.cat([t.float().reshape(-1) for t in a])
    b = torch.cat([t.float().reshape(-1) for t in b])
    return ((a - b).norm() / b.norm()).item()


def served_model(variant, dev, img=256):
    cfg = ModelConfig(img_size=img, dtype="bfloat16", single_head=variant == "v2",
                      eval_bn="frozen")
    model = build_model(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                for t, noise in ((m.running_mean, 0.05), (m.weight, 0.05), (m.bias, 0.05)):
                    t.add_(noise * torch.randn(t.shape, generator=g).to(dev))
                m.running_var.mul_((torch.rand(m.running_var.shape, generator=g) * 0.7 + 0.7)
                                   .to(dev))
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_eval_forward_through_k7_against_the_eager_route(dev, variant):
    """The whole bf16 eval forward through K7 (no gradient wanted) against
    the same model on the eager chain (grad mode on, the parameters
    requiring one), within the benchmark's serving limits: neck maps 0.06,
    heads 0.02 (relative RMS)."""
    model = served_model(variant, dev)
    neck = []
    hook = model.neck.register_forward_hook(lambda m, a, o: neck.append([t.detach() for t in o]))
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    before = k7.bn_act.launches
    with torch.no_grad():
        fast = model(x, train=False, mode="infer")
    assert k7.bn_act.launches - before == K7_CALLS[variant]
    with torch.enable_grad():
        slow = model(x, train=False, mode="infer")
    hook.remove()
    assert k7.bn_act.launches - before == K7_CALLS[variant]
    neck_gap = rms_gap(neck[0], neck[1])
    head_gap = max(rms_gap([t.detach() for t in (fast[k] if isinstance(fast[k], list)
                                                  else [fast[k]])],
                           [t.detach() for t in (slow[k] if isinstance(slow[k], list)
                                                 else [slow[k]])])
                   for k in ("det_feats", "seg_coeffs", "protos"))
    print(f"{variant}: neck_gap {neck_gap:.3e}, head_gap {head_gap:.3e}")
    assert neck_gap <= 0.06 and head_gap <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_launches_per_root(dev, variant):
    """``launches.K7`` per ``infer`` root is 110 (v1) / 98 (v2), and no
    ``train_step`` root launches K7."""
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch
    from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.train import (TrainConfig, create_train_state,
                                                          make_train_step)
    from multitask_bonetumor_yolo_tpu_torch.utils import profiling

    img = 256
    model = served_model(variant, dev, img)
    images = np.random.RandomState(0).randint(0, 256, (2, img, img, 3), dtype=np.uint8)
    batch = synthetic_batch(2, img, torch.Generator(device=dev).manual_seed(1))
    state = create_train_state(model.cfg, TrainConfig(), model=model.train())
    step = make_train_step(model.cfg, LossConfig(img_size=img))
    profiling.enable()
    try:
        infer_batch(model.eval(), images, conf_thresh=0.0, top_k=20, instance_masks=True)
        state, _, _ = step(state, batch, None)
        torch.cuda.synchronize()
        per_root = profiling.report()["per_root"]
    finally:
        profiling.disable()
        profiling.reset()
    assert per_root["infer"]["launches.K7"] == K7_CALLS[variant]
    assert per_root["train_step"].get("launches.K7", 0) == 0
