"""The block kernels' operands and K1's GELU form, on the CPU, torch only.

``kernel_operands`` folds the block's parameters once and hands each kernel
the weights in the layouts its route names: K1's Hopper design takes w1'^T
and w2'^T (the torch layouts of w1 and w2), its first design w1' and w2';
K2's Hopper pipeline and first design take their own sets. The routes are
the CUDA library's rules; here they are set by hand, since no library can
be built without a card. K4's route has a Python mirror, which picks its
pointer list (held against the library on the card). The kernels
themselves run only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def block_params(seed, c):
    """Seeded parameters in the port's layouts (gamma ~0.5, LN scale ~1)."""
    rs = np.random.RandomState(seed)

    def f(*s):
        return torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.1)

    return (f(c, 1, 7, 7), f(c), f(c) + 1.0, f(c), f(4 * c, c), f(4 * c), f(c, 4 * c), f(c),
            f(c) * 0.5)


@pytest.mark.parametrize("fwd,bwd,want", [
    (True, None, {"w1f_t", "w2f_t"}),
    (False, None, {"w1f", "w2f"}),
    (True, True, {"w1f_t", "w2f_t", "w2f", "w1_t"}),
    (False, True, {"w1f", "w2f", "w1f_t", "w1_t"}),
    (False, False, {"w1f", "w2f", "w2f_t", "w1f_t", "w1", "w2_t"}),
])
def test_kernel_operands_follow_the_routes(monkeypatch, fwd, bwd, want):
    """The weights are exactly the ones the routes name (K1's route ``fwd``;
    with ``bwd`` not None, K2's), each in the compute dtype and contiguous:
    w1f_t and w2f_t are the dt transposes of ``fold_block_params``'s w1' and
    w2' bit for bit, w1f and w2f its w1' and w2', and the raw-space ones the
    casts of w1 and w2; the fp32 vectors are the fold's."""
    monkeypatch.setattr(cnb, "forward_route", lambda dt, c: fwd)
    monkeypatch.setattr(k2, "hopper_route", lambda dt, c: bool(bwd))
    params = block_params(3, 32)
    taps, dwb, w1f, b1f, w2f, b2f = cnb.fold_block_params(*params)
    w1, w2 = params[4], params[6]
    for dt in (torch.bfloat16, torch.float32):
        ops = cnb.kernel_operands(params, dt, backward=bwd is not None)
        assert set(ops) == {"taps", "dw_bias", "b1f", "b2f"} | want
        expect = {"w1f_t": w1f.t(), "w2f_t": w2f.t(), "w1f": w1f, "w2f": w2f, "w1_t": w1.t(),
                  "w1": w1, "w2_t": w2.t()}
        for k in want:
            assert ops[k].dtype == dt and ops[k].is_contiguous(), k
            assert torch.equal(ops[k], expect[k].to(dt)), k
        for k, v in (("taps", taps), ("dw_bias", dwb), ("b1f", b1f), ("b2f", b2f)):
            assert ops[k].dtype == torch.float32 and torch.equal(ops[k], v), k


def test_gelu_sigmoid_form_matches_tanh_form():
    """K1's and K2's GELU, x * sigmoid(2u) = x / (1 + exp(-2u)) with u =
    0.79788456 (x + 0.044715 x^3), as the kernels evaluate it, is the tanh
    form ``gelu_tanh`` (x * 0.5 * (1 + tanh u)) within fp32 rounding over
    |x| <= 10."""
    x = torch.linspace(-10.0, 10.0, 200001, dtype=torch.float32)
    u2 = 1.5957691216057308 * (x + 0.044715 * x * x * x)
    sig = x / (1.0 + torch.exp(-u2))
    want = cnb.gelu_tanh(x)
    torch.testing.assert_close(sig, want, rtol=2e-6, atol=2e-7)
    exact = cnb.gelu_tanh(x.double())  # both forms sit within fp32 rounding of it
    assert (sig.double() - exact).abs().max().item() < 2e-6
    assert (want.double() - exact).abs().max().item() < 2e-6


def test_first_design_entry_on_cpu_is_the_twin():
    """``convnext_block_v0`` on a CPU tensor returns the plain twin, in both
    forms, and launches nothing."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(1, 9, 7, 32).astype(np.float32)).to(torch.bfloat16)
    params = block_params(5, 32)
    before = cnb.convnext_block_v0.launches
    out = cnb.convnext_block_v0(x, *params)
    out_s, y = cnb.convnext_block_v0(x, *params, saving=True)
    want, want_y = cnb.convnext_block_plain_saving(x, *params)
    assert cnb.convnext_block_v0.launches == before
    assert torch.equal(out, want) and torch.equal(out_s, want) and torch.equal(y, want_y)


@pytest.mark.parametrize("dt,c,hopper", [
    (torch.bfloat16, 48, True), (torch.bfloat16, 96, True), (torch.bfloat16, 192, True),
    (torch.bfloat16, 384, True), (torch.bfloat16, 768, False), (torch.float32, 96, False),
    (torch.float32, 384, False), (torch.float32, 768, False),
    (torch.bfloat16, 128, True), (torch.bfloat16, 256, True), (torch.bfloat16, 512, False),
    (torch.bfloat16, 1024, False),
])
def test_k4_route_rule(dt, c, hopper):
    """K4's Python route rule: bf16 up to C = 384 runs K2's Hopper pipeline
    under V1; fp32, and C = 512 and above (K4's row pass stops at Tiny's
    widths, where K2's goes on to 512), run K4's first design."""
    assert k2.bwd_v1_route(dt, c) is hopper


def test_k4_first_design_entry_on_cpu_is_the_plain_version():
    """``convnext_block_bwd_v1_v0`` and ``convnext_block_bwd_v1`` on CPU
    tensors return K4's plain version and launch nothing."""
    rs = np.random.RandomState(6)
    x, g = (torch.from_numpy(rs.randn(1, 9, 7, 32).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    params = block_params(7, 32)
    before = k2.convnext_block_bwd_v1.launches, k2.convnext_block_bwd_v1_v0.launches
    want = k2.convnext_block_bwd_v1_plain(x, g, *params)
    for fn in (k2.convnext_block_bwd_v1_v0, k2.convnext_block_bwd_v1):
        got = fn(x, g, *params)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (k2.convnext_block_bwd_v1.launches, k2.convnext_block_bwd_v1_v0.launches) == before
