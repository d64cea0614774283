"""The port's CUDA kernels (K1 in both forms and both designs, K2, K3 in both designs, K4,
the kernel lab K5) and its device-side NMS on the card.

Every test here carries the ``cuda`` marker and skips without a card. The
file imports no JAX, because the GPU machine has none; run it there without
the tests' conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.ops import nms
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import dwconv as k3
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import kernel_lab as k5
from multitask_bonetumor_yolo_tpu_torch.tools import kernel_lab as lab_tools

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def block_args(seed, b, h, w, c, dtype, dev):
    """Seeded block inputs in the port's layouts (gamma ~0.5, LN scale ~1)."""
    rs = np.random.RandomState(seed)

    def f(*s, scale=0.1):
        return torch.from_numpy(rs.randn(*s).astype(np.float32) * scale).to(dev)

    x = f(b, h, w, c, scale=1.0).to(dtype)
    return (x, f(c, 1, 7, 7), f(c), f(c) + 1.0, f(c), f(4 * c, c), f(4 * c),
            f(c, 4 * c), f(c), f(c) * 0.5)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 13, 21, 96), torch.bfloat16, 3e-2),
    ((2, 20, 20, 768), torch.bfloat16, 3e-2),
    ((1, 13, 21, 96), torch.float32, 1e-2),
    ((3, 7, 5, 48), torch.bfloat16, 3e-2),  # partial channel and hidden chunks
])
def test_kernel_matches_twin(dev, shape, dtype, tol):
    """K1 against its twin on the same inputs. fp32 runs the kernel's
    products in TF32 (hence 1e-2), the twin in full fp32."""
    args = block_args(8, *shape, dtype, dev)
    before = cnb.convnext_block.launches
    got = cnb.convnext_block(*args)
    want = cnb.convnext_block_plain(*args)
    torch.cuda.synchronize()
    assert cnb.convnext_block.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_hopper_design_matches_twin(dev, c):
    """K1's route sends bf16 up to C = 384 to its Hopper design: both forms
    against the twin at an odd shape (partial 8 x 8 tiles), two calls equal
    bit for bit, the saving form's out equal to the inference form's, and its
    y equal bit for bit to the first design's (phase 1 is the same code)."""
    assert cnb.forward_route(torch.bfloat16, c)
    assert not cnb.forward_route(torch.float32, c) and not cnb.forward_route(torch.bfloat16, 768)
    args = block_args(12, 1, 13, 21, c, torch.bfloat16, dev)
    before = cnb.convnext_block.launches, cnb.convnext_block_saving.launches
    got = cnb.convnext_block(*args)
    again = cnb.convnext_block(*args)
    out, y = cnb.convnext_block_saving(*args)
    want, want_y = cnb.convnext_block_plain_saving(*args)
    _, v0_y = cnb.convnext_block_v0(*args, saving=True)
    torch.cuda.synchronize()
    assert (cnb.convnext_block.launches, cnb.convnext_block_saving.launches) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(y.float(), want_y.float(), atol=3e-2, rtol=3e-2)
    assert torch.equal(got, again) and torch.equal(out, got) and torch.equal(y, v0_y)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 13, 21, 96), torch.bfloat16, 3e-2),
    ((2, 10, 10, 384), torch.bfloat16, 3e-2),
    ((1, 13, 21, 96), torch.float32, 1e-2),
])
def test_first_design_matches_twin(dev, shape, dtype, tol):
    """K1's first design through its own entry (``convnext_block_v0``),
    whatever the route, both forms, against the twin; one launch each on
    its own count."""
    args = block_args(13, *shape, dtype, dev)
    before = (cnb.convnext_block_v0.launches, cnb.convnext_block.launches,
              cnb.convnext_block_saving.launches)
    got = cnb.convnext_block_v0(*args)
    out, y = cnb.convnext_block_v0(*args, saving=True)
    want, want_y = cnb.convnext_block_plain_saving(*args)
    torch.cuda.synchronize()
    assert (cnb.convnext_block_v0.launches, cnb.convnext_block.launches,
            cnb.convnext_block_saving.launches) == (before[0] + 2, before[1], before[2])
    for a, b in ((got, want), (out, want), (y, want_y)):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def test_kernel_raises_on_what_it_does_not_take(dev):
    before = cnb.convnext_block.launches
    with pytest.raises(ValueError):  # C not a multiple of 16
        cnb.convnext_block(*block_args(0, 1, 8, 8, 24, torch.bfloat16, dev))
    with pytest.raises(TypeError):
        cnb.convnext_block(*block_args(0, 1, 8, 8, 32, torch.float16, dev))
    x, *params = block_args(0, 1, 8, 8, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # not contiguous NHWC
        cnb.convnext_block(x.transpose(1, 2), *params)
    assert cnb.convnext_block.launches == before


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 13, 21, 96), torch.bfloat16, 3e-2),
    ((3, 7, 5, 48), torch.bfloat16, 3e-2),
    ((1, 13, 21, 96), torch.float32, 1e-2),
])
def test_saving_kernel_matches_twin(dev, shape, dtype, tol):
    """K1's residual-saving form against its twin: ``out`` as the inference
    form, and ``y`` (the dwconv output plus bias, fp32 sums in both) at the
    same tolerance."""
    args = block_args(9, *shape, dtype, dev)
    before = cnb.convnext_block_saving.launches, cnb.convnext_block.launches
    out, y = cnb.convnext_block_saving(*args)
    want_out, want_y = cnb.convnext_block_plain_saving(*args)
    torch.cuda.synchronize()
    assert (cnb.convnext_block_saving.launches, cnb.convnext_block.launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)


def check_bwd(got, want, tol):
    """dx elementwise; each parameter gradient, a sum over every pixel, to
    ``tol`` of its own scale: max |got - want| <= tol * max |want|."""
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        assert a.shape == b.shape and a.dtype == torch.float32, i
        err = (a - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), (i, err, b.abs().max().item())


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 13, 21, 96), torch.bfloat16, 3e-2),
    ((3, 7, 5, 48), torch.bfloat16, 3e-2),
    ((2, 20, 20, 384), torch.bfloat16, 3e-2),
    ((1, 13, 21, 96), torch.float32, 1e-2),
    ((1, 13, 11, 48), torch.bfloat16, 3e-2),  # P = 143: a partial 64-pixel tile
    ((1, 13, 11, 192), torch.bfloat16, 3e-2),
    ((1, 13, 11, 384), torch.bfloat16, 3e-2),
    ((2, 8, 8, 64), torch.bfloat16, 3e-2),  # padded to the C = 96 instantiation
    ((2, 10, 10, 768), torch.bfloat16, 3e-2),  # wider than the Hopper pipeline holds
])
def test_bwd_kernel_matches_plain(dev, shape, dtype, tol):
    """K2 against its plain version on the same x, saved y and cotangent.
    bf16: both round the same operands to bf16 but sum in other orders, so a
    rounding step can flip (3e-2); fp32: K2's products run in TF32 (1e-2)."""
    x, *params = block_args(10, *shape, dtype, dev)
    _, y = cnb.convnext_block_plain_saving(x, *params)
    g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(11), device=dev).to(dtype)
    before = k2.convnext_block_bwd.launches
    got = k2.convnext_block_bwd(x, y, g, *params)
    want = k2.convnext_block_bwd_plain(x, y, g, *params)
    torch.cuda.synchronize()
    assert k2.convnext_block_bwd.launches == before + 1
    check_bwd(got, want, tol)
    # on the operands the autograd Function folds in its forward
    again = k2.convnext_block_bwd(x, y, g, *params,
                                  ops=cnb.kernel_operands(params, dtype, backward=True))
    for a, b in zip(got, again):  # fixed-order reductions: bit for bit
        assert torch.equal(a, b)


def profiled(run, attempts=4):
    """``run()`` under ``torch.profiler`` and the names of the device kernels
    it launched. The profiler can come back with no device event at all for
    a call that launched kernels (seen on the H100 machine; ``chip_smoke.py
    ::device_events`` handles it the same way): such a profile is taken
    again, up to ``attempts`` profiles."""
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return out, names


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_bwd_hopper_pipeline_launches(dev, c):
    """A bf16 call up to C = 384 runs K2's Hopper pipeline: at most five
    kernel launches per call, counted by the profiler, none of them a
    library kernel, and two calls equal bit for bit. The library's route
    rule, which picks the operands and pointer list, says the same."""
    assert k2.hopper_route(torch.bfloat16, c)
    assert not k2.hopper_route(torch.float32, c) and not k2.hopper_route(torch.bfloat16, 768)
    x, *params = block_args(14, 1, 13, 11, c, torch.bfloat16, dev)
    _, y = cnb.convnext_block_plain_saving(x, *params)
    g = torch.randn_like(x)
    ops = cnb.kernel_operands(params, x.dtype, backward=True)
    first = k2.convnext_block_bwd(x, y, g, *params, ops=ops)
    torch.cuda.synchronize()
    second, names = profiled(lambda: k2.convnext_block_bwd(x, y, g, *params, ops=ops))
    assert 0 < len(names) <= 5 and all("k2_" in n or "cnb_bwd_" in n for n in names), names
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_png_round_trip_on_the_card_machine(dev, tmp_path):
    """The port's PNG codec where cv2 and PIL are missing: write, read back,
    letterbox, equal."""
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import load_and_letterbox
    from multitask_bonetumor_yolo_tpu_torch.data.imageio import read_png, write_png

    img = np.random.RandomState(3).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    assert np.array_equal(read_png(tmp_path / "a.png"), img)
    canvas = load_and_letterbox(str(tmp_path / "a.png"), 53)
    assert np.array_equal(canvas[:37], img) and (canvas[37:] == 114).all()


def test_autograd_runs_the_kernels(dev):
    """Recorded by autograd, the block runs K1's saving form and K2 once
    each, and its gradients are the plain version's."""
    x, *params = block_args(12, 2, 16, 16, 96, torch.bfloat16, dev)
    leaves = [t.requires_grad_() for t in (x, *params)]
    counts = (cnb.convnext_block.launches, cnb.convnext_block_saving.launches,
              k2.convnext_block_bwd.launches)
    out = cnb.convnext_block(*leaves)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert (cnb.convnext_block.launches, cnb.convnext_block_saving.launches,
            k2.convnext_block_bwd.launches) == (counts[0], counts[1] + 1, counts[2] + 1)
    _, y = cnb.convnext_block_plain_saving(x.detach(), *[p.detach() for p in params])
    want = k2.convnext_block_bwd_plain(x.detach(), y, g, *[p.detach() for p in params])
    check_bwd([t.grad for t in leaves], want, 3e-2)


def test_bwd_kernel_raises_on_what_it_does_not_take(dev):
    x, *params = block_args(0, 1, 8, 8, 32, torch.bfloat16, dev)
    y, g = torch.zeros_like(x), torch.zeros_like(x)
    before = k2.convnext_block_bwd.launches
    with pytest.raises(ValueError):  # y of another shape
        k2.convnext_block_bwd(x, y[:, :4], g, *params)
    with pytest.raises(ValueError):  # g of another dtype
        k2.convnext_block_bwd(x, y, g.float(), *params)
    with pytest.raises(ValueError):  # g not contiguous NHWC
        k2.convnext_block_bwd(x, y, g.transpose(1, 2), *params)
    with pytest.raises(ValueError):  # C not a multiple of 16
        k2.convnext_block_bwd(*[t[..., :24] for t in (x, y, g)],
                              *block_args(0, 1, 8, 8, 24, torch.bfloat16, dev)[1:])
    assert k2.convnext_block_bwd.launches == before


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 13, 21, 48), torch.bfloat16, 1e-4),
    ((2, 160, 160, 96), torch.bfloat16, 1e-4),
    ((3, 7, 5, 784), torch.float32, 1e-4),  # wider than the block kernels take
    ((2, 23, 19, 48), torch.float32, 1e-4),  # H not a multiple of the 7-row band
    ((2, 9, 11, 16), torch.bfloat16, 1e-4),  # C below the 32-channel chunk
    ((32, 20, 20, 768), torch.bfloat16, 1e-4),  # more work units than CTAs
])
def test_dwconv_kernel_matches_plain(dev, shape, dtype, tol):
    """K3 (its Hopper design) against ``F.conv2d(groups=C)`` on the fp32
    input (TF32 off), with the flipped taps of the explicit backward and with
    a bias (the library's bias pointer, as K4's recompute passes it): fp32
    sums of exact products in both, in other orders (1e-4); and bit for bit
    equal to the first design (``dwconv7_v0``: the same fmaf chain per
    output). The library's plan equals its Python mirror."""
    rs = np.random.RandomState(14)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)
    taps = torch.from_numpy(rs.randn(7, 7, shape[-1]).astype(np.float32) * 0.1).to(dev)
    bias = torch.from_numpy(rs.randn(shape[-1]).astype(np.float32)).to(dev)
    plan = k3.library_plan(*shape, dtype)
    assert plan == k3.dwconv7_plan(*shape, dtype.itemsize, sms=plan["sms"],
                                   ctas_per_sm=plan["ctas_per_sm"])
    for t, b in ((taps, None), (taps.flip(0, 1), None), (taps, bias)):
        before = k3.dwconv7.launches, k3.dwconv7_v0.launches
        got = k3.dwconv7(x, t, b)
        v0 = k3.dwconv7_v0(x, t, b)
        want = k3.dwconv7_plain(x, t, b)
        torch.cuda.synchronize()
        assert (k3.dwconv7.launches, k3.dwconv7_v0.launches) == (before[0] + 1, before[1] + 1)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        assert torch.equal(got, v0)


def test_dwconv_kernel_raises_on_what_it_does_not_take(dev):
    """Both designs' wrappers refuse the same inputs and launch nothing."""
    x = torch.zeros(1, 8, 8, 32, device=dev, dtype=torch.bfloat16)
    taps = torch.zeros(7, 7, 32, device=dev)
    for fn in (k3.dwconv7, k3.dwconv7_v0):
        before = k3.dwconv7.launches, k3.dwconv7_v0.launches
        with pytest.raises(ValueError):  # C not a multiple of 16
            fn(x[..., :24].contiguous(), taps[..., :24])
        with pytest.raises(TypeError):
            fn(x.half(), taps)
        with pytest.raises(ValueError):  # not contiguous NHWC
            fn(x.transpose(1, 2), taps)
        with pytest.raises(ValueError):  # taps of another width
            fn(x, taps[..., :16])
        with pytest.raises(ValueError):  # bias of another width
            fn(x, taps, taps[0, 0, :16])
        assert (k3.dwconv7.launches, k3.dwconv7_v0.launches) == before


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 13, 21, 96), torch.bfloat16, 3e-2),
    ((3, 7, 5, 48), torch.bfloat16, 3e-2),
    ((2, 20, 20, 768), torch.bfloat16, 3e-2),
    ((1, 13, 21, 96), torch.float32, 1e-2),
])
def test_bwd_v1_kernel_matches_plain(dev, shape, dtype, tol):
    """K4 against its plain version on the same x and cotangent, with K2's
    tolerances (bf16: one rounding step can flip; fp32: TF32 products)."""
    x, *params = block_args(15, *shape, dtype, dev)
    g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(16), device=dev).to(dtype)
    before = k2.convnext_block_bwd_v1.launches
    got = k2.convnext_block_bwd_v1(x, g, *params)
    want = k2.convnext_block_bwd_v1_plain(x, g, *params)
    torch.cuda.synchronize()
    assert k2.convnext_block_bwd_v1.launches == before + 1
    check_bwd(got, want, tol)
    again = k2.convnext_block_bwd_v1(x, g, *params)
    for a, b in zip(got, again):  # fixed-order reductions: bit for bit
        assert torch.equal(a, b)


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_bwd_v1_hopper_pipeline(dev, c):
    """A bf16 call of K4 up to C = 384 runs K2's Hopper pipeline under V1 (the
    Python rule that picks its pointers agrees with the library's): against
    the plain version at K2's tolerance at 13 x 11 (a partial 64-pixel
    tile), two calls equal bit for bit, and at most five launches of K4's
    kernels per call, counted by the profiler (beside them the wrapper's
    copies of the parameters into the kernels' dtypes and layouts)."""
    lib = k2._library()
    assert k2.bwd_v1_route(torch.bfloat16, c) and lib.cnb_backward_v1_route(c, 1) == 1
    assert lib.cnb_backward_v1_route(c, 0) == 0 and lib.cnb_backward_v1_route(768, 1) == 0
    x, *params = block_args(18, 1, 13, 11, c, torch.bfloat16, dev)
    g = torch.randn_like(x)
    first = k2.convnext_block_bwd_v1(x, g, *params)
    want = k2.convnext_block_bwd_v1_plain(x, g, *params)
    torch.cuda.synchronize()
    check_bwd(first, want, 3e-2)
    second, names = profiled(lambda: k2.convnext_block_bwd_v1(x, g, *params))
    assert 0 < len([n for n in names if "k2_" in n or "cnb_" in n]) <= 5, names
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-2)])
def test_bwd_v1_first_design_matches_plain(dev, dtype, tol):
    """K4's first design through its own entry (``convnext_block_bwd_v1_v0``)
    in both dtypes, whatever the route, against the plain version; one
    launch on its own count."""
    x, *params = block_args(19, 1, 13, 21, 96, dtype, dev)
    g = torch.randn_like(x)
    before = k2.convnext_block_bwd_v1_v0.launches, k2.convnext_block_bwd_v1.launches
    got = k2.convnext_block_bwd_v1_v0(x, g, *params)
    want = k2.convnext_block_bwd_v1_plain(x, g, *params)
    torch.cuda.synchronize()
    assert (k2.convnext_block_bwd_v1_v0.launches, k2.convnext_block_bwd_v1.launches) == (
        before[0] + 1, before[1])
    check_bwd(got, want, tol)


@pytest.mark.parametrize("fn", [k2.convnext_block_bwd_v1, k2.convnext_block_bwd_v1_v0])
def test_bwd_v1_kernel_raises_on_what_it_does_not_take(dev, fn):
    x, *params = block_args(0, 1, 8, 8, 32, torch.bfloat16, dev)
    g = torch.zeros_like(x)
    before = fn.launches
    with pytest.raises(ValueError):  # g of another dtype
        fn(x, g.float(), *params)
    with pytest.raises(ValueError):  # g not contiguous NHWC
        fn(x, g.transpose(1, 2), *params)
    with pytest.raises(ValueError):  # C above 768
        wide, *wide_params = block_args(0, 1, 8, 8, 784, torch.bfloat16, dev)
        fn(wide, torch.zeros_like(wide), *wide_params)
    assert fn.launches == before


@pytest.mark.parametrize("route", ["fused_v1", "explicit"])
def test_autograd_routes_run_their_kernels(dev, route):
    """Recorded by autograd, ``bwd="fused_v1"`` runs K1 (inference form) and
    K4 once each; ``"explicit"`` runs K1 once and K3 twice; the gradients are
    those of the route's backward function on the same cotangent."""
    x, *params = block_args(17, 2, 16, 16, 96, torch.bfloat16, dev)
    leaves = [t.requires_grad_() for t in (x, *params)]
    fns = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd,
           k2.convnext_block_bwd_v1, k3.dwconv7)
    counts = [f.launches for f in fns]
    out = cnb.convnext_block(*leaves, bwd=route)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    want = [1, 0, 0, 1, 0] if route == "fused_v1" else [1, 0, 0, 0, 2]
    assert [f.launches - c for f, c in zip(fns, counts)] == want
    fn = k2.convnext_block_bwd_v1 if route == "fused_v1" else k2.convnext_block_bwd_explicit
    plain = [t.detach() for t in leaves]
    for t, w in zip(leaves, fn(plain[0], g, *plain[1:])):
        torch.testing.assert_close(t.grad, w, atol=0, rtol=0)


def test_nms_on_card_matches_cpu(dev):
    """Batched NMS keeps on the card exactly what it keeps on the CPU, with
    a ragged batch (one image has no candidate above conf)."""
    rs = np.random.RandomState(1)
    b, a = 4, 8400
    preds = np.zeros((b, a, 6), np.float32)
    preds[..., :2] = rs.rand(b, a, 2) * 640
    preds[..., 2:4] = rs.rand(b, a, 2) * 120 + 4
    preds[..., 4:] = rs.rand(b, a, 2) * np.array([0.1, 0.3, 0.6, 1.0])[:, None, None]
    preds = torch.from_numpy(preds)
    want = nms.postprocess_detections(preds, 640, conf_thresh=0.25)
    got = nms.postprocess_detections(preds.to(dev), 640, conf_thresh=0.25)
    assert not bool(want.valid[0].any()) and bool(want.valid[1:].any())
    for name in ("valid", "indices", "labels"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.boxes.cpu(), want.boxes, atol=1e-5, rtol=0)


@pytest.mark.parametrize("c", [48, 96, 192, 384, 768])
def test_lab_variants_match_plain(dev, c):
    """Every variant of the kernel lab (K5) at every legal tile against its
    plain version, at an odd shape (partial tiles; at C = 48 a partial
    channel chunk and a partial hidden chunk), one launch each, at the
    tolerances of ``card_tolerance``: K1's Hopper design cut down up to C =
    384 (both tiles at C <= 192), its first design at C = 768."""
    x, dw, w1, w2 = lab_tools.lab_inputs(2, 13, 21, c, device=dev)
    taps, w1k, w2k, zeros, wt = lab_tools.fold(dw, w1, w2, c)
    assert (wt is not None) == (c <= 384) == cnb.forward_route(torch.bfloat16, c)
    for name in k5.VARIANTS:
        want = k5.lab_variant_plain(name, x, taps, w1k, w2k)
        rtol, atol = k5.card_tolerance(name)
        for tm in k5.legal_tiles(c):
            before = k5.lab_variant.launches
            got = k5.lab_variant(name, x, taps, w1k, w2k, tm=tm, zeros=zeros, wt=wt)
            torch.cuda.synchronize()
            assert k5.lab_variant.launches == before + 1
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name} TM={tm}: {m}")


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_lab_full_is_k1(dev, c):
    """The lab's ``full`` at K1's tile is K1 itself (``cnb_forward`` on the
    Hopper operands): equal bit for bit to ``convnext_block`` with zero
    biases, unit LN and unit gamma on the same operands; at the other tile
    within one bf16 step of it. Its tile is K1's Hopper tile, and the CPU
    route's rule for the tile agrees with the library."""
    x, dw, w1, w2 = lab_tools.lab_inputs(2, 13, 21, c, device=dev)
    taps, w1k, w2k, zeros, wt = lab_tools.fold(dw, w1, w2, c)
    ones = torch.ones(c, device=dev)
    want = cnb.convnext_block(x, taps.permute(2, 0, 1).reshape(c, 1, 7, 7), zeros[:c], ones,
                              zeros[:c], w1k.t().float(), zeros, w2k.t().float(), zeros[:c],
                              ones)
    assert torch.equal(k5.lab_variant("full", x, taps, w1k, w2k, zeros=zeros, wt=wt), want)
    assert torch.equal(k5.lab_variant("full", x, taps, w1k, w2k), want)  # operands made inside
    for tm in k5.legal_tiles(c):
        got = k5.lab_variant("full", x, taps, w1k, w2k, tm=tm, zeros=zeros, wt=wt)
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-3)
    hop = cnb.hopper_tile(c)
    assert k5.lab_tile("full", c) == k5.k1_tile(c) == (hop["tm"], hop["th"], hop["tw"],
                                                       hop["ctas_per_sm"])
    assert k5.k1_tile(c)[0] == k5.k1_tile_pixels(c)
    assert k5.lab_tile("mlpgelu", c) == k5.k1_tile(c)


def test_lab_v0_matches_plain(dev):
    """The first design's lab (``lab_variant_v0``, the "before") at C = 96:
    every variant at both of its tiles against its plain version, its
    ``full`` bit for bit K1's first design, its own launch count."""
    c = 96
    x, dw, w1, w2 = lab_tools.lab_inputs(2, 13, 21, c, device=dev)
    taps, w1k, w2k, zeros, _ = lab_tools.fold(dw, w1, w2, c)
    assert k5.legal_tiles(c, v0=True) == (32, 128)
    assert k5.k1_tile(c, v0=True)[0] == k5.k1_tile_pixels(c, v0=True) == 128
    for name in k5.VARIANTS:
        want = k5.lab_variant_plain(name, x, taps, w1k, w2k)
        rtol, atol = k5.card_tolerance(name)
        for tm in k5.legal_tiles(c, v0=True):
            before = (k5.lab_variant.launches, k5.lab_variant_v0.launches)
            got = k5.lab_variant_v0(name, x, taps, w1k, w2k, tm=tm, zeros=zeros)
            torch.cuda.synchronize()
            assert (k5.lab_variant.launches, k5.lab_variant_v0.launches) == (
                before[0], before[1] + 1)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name} TM={tm}: {m}")
    ones = torch.ones(c, device=dev)
    want = cnb.convnext_block_v0(x, taps.permute(2, 0, 1).reshape(c, 1, 7, 7), zeros[:c], ones,
                                 zeros[:c], w1k.t().float(), zeros, w2k.t().float(), zeros[:c],
                                 ones)
    assert torch.equal(k5.lab_variant_v0("full", x, taps, w1k, w2k, zeros=zeros), want)


def test_lab_raises_on_what_it_does_not_take(dev):
    x, dw, w1, w2 = lab_tools.lab_inputs(1, 8, 8, 96, device=dev)
    ops = lab_tools.fold(dw, w1, w2, 96)
    before = (k5.lab_variant.launches, k5.lab_variant_v0.launches)
    with pytest.raises(TypeError):
        k5.lab_variant("dw", x.float(), *ops[:3])
    with pytest.raises(ValueError, match="unknown variant"):
        k5.lab_variant("dwfast", x, *ops[:3])
    with pytest.raises(ValueError, match="multiple of 16"):
        k5.lab_variant("dw", torch.zeros(1, 8, 8, 24, dtype=torch.bfloat16, device=dev),
                       *ops[:3])
    with pytest.raises(ValueError, match=r"legal: \(64, 128\)"):
        k5.lab_variant("dw", x, *ops[:3], tm=32)
    with pytest.raises(ValueError, match=r"legal: \(32, 128\)"):
        k5.lab_variant_v0("dw", x, *ops[:3], tm=64)
    with pytest.raises(ValueError):  # w1 not in the kernel's layout
        k5.lab_variant("mlp", x, ops[0], ops[1].t(), ops[2])
    with pytest.raises(ValueError, match="w1'"):  # the Hopper operands transposed
        k5.lab_variant("mlp", x, *ops[:3], wt=(ops[4][1], ops[4][0]))
    assert (k5.lab_variant.launches, k5.lab_variant_v0.launches) == before


def test_k3_and_k4_setup_on_every_card(dev):
    """K3's one-time setup (the fp32 plan's 51,904 bytes of dynamic shared
    memory, above the 48 KB default, and the CTAs per SM) is made on each
    card: fp32 ``dwconv7`` and fp32 ``convnext_block_bwd_v1`` (whose first
    design recomputes y through K3's device code, in its own library)
    against their plain versions on every visible card, the last card first
    and card 0 last. On one card this is the single-card case."""
    for i in range(torch.cuda.device_count() - 1, -1, -1):
        d = torch.device("cuda", i)
        rs = np.random.RandomState(20 + i)
        x = torch.from_numpy(rs.randn(2, 40, 40, 96).astype(np.float32)).to(d)
        taps = torch.from_numpy(rs.randn(7, 7, 96).astype(np.float32) * 0.1).to(d)
        assert k3.library_plan(2, 40, 40, 96, torch.float32)["smem"] > 48 * 1024
        before = k3.dwconv7.launches
        got = k3.dwconv7(x, taps)
        torch.testing.assert_close(got, k3.dwconv7_plain(x, taps), atol=1e-4, rtol=1e-4)
        x, *params = block_args(21 + i, 1, 13, 21, 96, torch.float32, d)
        g = torch.randn(x.shape, generator=torch.Generator(d).manual_seed(i), device=d)
        got_bwd = k2.convnext_block_bwd_v1(x, g, *params)
        check_bwd(got_bwd, k2.convnext_block_bwd_v1_plain(x, g, *params), 1e-2)
        torch.cuda.synchronize(d)
        assert k3.dwconv7.launches == before + 1
        assert got.device == d and got_bwd[0].device == d


def perturbed_model(cfg, seed=0):
    """The port's seeded model at ``cfg`` on the CPU with every parameter and
    BN statistic perturbed (running variances x U(0.7, 1.4), the rest
    + 0.05 N(0, 1), as the JAX-held tests do) and the Detect head's class
    biases raised by 6, so that NMS at 0.05 keeps boxes."""
    from multitask_bonetumor_yolo_tpu_torch.models import build_model

    model = build_model(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.mul_(torch.rand(t.shape, generator=gen) * 0.7 + 0.7)
            else:
                t.add_(0.05 * torch.randn(t.shape, generator=gen))
        for i in range(3):
            getattr(model.detect.towers, f"cv3_{i}_2").bias.add_(6.0)
    return model


EVAL_CFG = dict(nc_det=2, nc_img=2, proto_ch=8, bifpn_feature_size=64, bifpn_num_layers=2,
                img_size=160, dtype="float32", pallas="auto",
                backbone_depths=(1, 1, 2, 1), backbone_dims=(16, 32, 48, 64))


def test_eval_step_on_card_matches_cpu(dev, tmp_path):
    """``make_eval_step`` at the oracle config with ``pallas="auto"`` (K1 on
    every stage on the card, 5 launches; the eager block on the CPU), fp32,
    the TAL assigner, on a padded batch of the synthetic PNG dataset: losses
    and class logits within 1e-2 (K1's products run in TF32), under 1 % of
    the seg-mask pixels differing, the top NMS box of each image within
    0.5 px, the BN running statistics unchanged on both."""
    import copy

    from multitask_bonetumor_yolo_tpu_torch.data import (BTXRD, BTXRDLoader, DataConfig,
                                                         make_synthetic_btxrd, to_device)
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig
    from multitask_bonetumor_yolo_tpu_torch.train import (TrainConfig, create_train_state,
                                                          make_eval_step)

    cfg = ModelConfig(**EVAL_CFG)
    root = make_synthetic_btxrd(str(tmp_path / "d"), n=3, seed=1, min_size=160, max_size=160,
                                rich=True)
    ds = BTXRD(DataConfig(root=str(root), img_size=160, image_ext=".png", max_boxes=8), "all")
    batch = next(iter(BTXRDLoader(ds, 4, pad_last=True)))
    step = make_eval_step(cfg, LossConfig(img_size=160, assigner="tal"), TrainConfig())
    model = perturbed_model(cfg)
    outs = {}
    for where in ("cpu", dev):
        state = create_train_state(cfg, TrainConfig(), model=copy.deepcopy(model).to(where))
        bn = [t.clone() for t in state.bn_stats()]
        before = cnb.convnext_block.launches
        metrics, aux = step(state, to_device(batch, where))
        torch.cuda.synchronize()
        assert cnb.convnext_block.launches - before == (5 if where == dev else 0)
        assert all(torch.equal(a, b) for a, b in zip(state.bn_stats(), bn))
        outs[str(where)] = ({k: v.cpu() for k, v in metrics.items()},
                            {k: v.cpu() for k, v in aux.items()})
    (want_m, want), (got_m, got) = outs["cpu"], outs[str(dev)]
    for k in want_m:
        torch.testing.assert_close(got_m[k], want_m[k], rtol=1e-2, atol=1e-3, msg=k)
    torch.testing.assert_close(got["cls_logits"], want["cls_logits"], rtol=1e-2, atol=1e-2)
    assert (got["seg_mask"] != want["seg_mask"]).float().mean() < 0.01
    assert want["cm_counts"].sum() > 0 and bool(want["nms_valid"][:, 0].all())
    assert torch.equal(got["nms_valid"][:, 0], want["nms_valid"][:, 0])
    torch.testing.assert_close(got["nms_boxes"][:, 0], want["nms_boxes"][:, 0], atol=0.5, rtol=0)


def test_cli_evaluate_on_card(dev, tmp_path):
    """``cli.evaluate.main`` on the card over a 4-image PNG dataset, two
    passes (the second from the device cache): the CPU run's key set, every
    value finite, losses and seg metrics within 1e-2 of the CPU run's."""
    import dataclasses
    import json

    from multitask_bonetumor_yolo_tpu_torch.cli import evaluate
    from multitask_bonetumor_yolo_tpu_torch.data import make_synthetic_btxrd
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig
    from multitask_bonetumor_yolo_tpu_torch.train import (CheckpointManager, TrainConfig,
                                                          create_train_state)

    cfg = ModelConfig(**EVAL_CFG)
    root = make_synthetic_btxrd(str(tmp_path / "d"), n=4, seed=2, min_size=120, max_size=300,
                                rich=True)
    state = create_train_state(cfg, TrainConfig(), model=perturbed_model(cfg))
    step_dir = CheckpointManager(str(tmp_path / "ckpt")).save(state, 1)
    (tmp_path / "ckpt" / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(cfg),
        "loss": dataclasses.asdict(LossConfig(img_size=160, assigner="tal")),
        "data": {"img_size": 160, "max_boxes": 8, "upload_streams": 4}}, default=list))
    runs = {}
    for where in ("cpu", "cuda"):
        before = cnb.convnext_block.launches
        runs[where] = evaluate.main([
            "--checkpoint-path", str(step_dir), "--root", str(root), "--split", "all",
            "--batch-size", "4", "--image-ext", ".png", "--dtype", "float32", "--epochs", "2",
            "--device", where, "--run-dir", str(tmp_path / f"run_{where}"), "--log-examples"])
        assert cnb.convnext_block.launches - before == (2 * 5 if where == "cuda" else 0)
    got, want = runs["cuda"], runs["cpu"]
    assert sorted(got) == sorted(want) and all(np.isfinite(v) for v in got.values())
    for k in want:
        if k.startswith(("loss_", "seg_dice", "seg_precision", "seg_recall")):
            assert abs(got[k] - want[k]) <= 1e-2 * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert len(list((tmp_path / "run_cuda" / "media").glob("*.png"))) >= 2
