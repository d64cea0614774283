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


@pytest.mark.parametrize("c", [48, 96, 192, 384, 512])
def test_hopper_design_matches_twin(dev, c):
    """K1's route sends bf16 up to C = 512 to its Hopper design: both forms
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


@pytest.mark.parametrize("c,hw", [(128, (13, 21)), (256, (13, 21)), (512, (13, 21)),
                                  (128, (160, 160)), (256, (80, 80)), (512, (40, 40))])
def test_base_widths_match_twins(dev, c, hw):
    """ConvNeXt-Base's trunk widths on K1's Hopper design (both forms) and
    K2's Hopper pipeline: C = 128 and 256 on the CP = 192 and 384
    instantiations (the channels past C zero), C = 512 on its own (a packed
    w2'^T ring in K1; K2's split row pass), against the plain twins at an odd
    shape (partial tiles) and at the stage's own 640^2 map (batch 2), at the
    tolerances of the tests above; the saving form's out equal to the
    inference form's bit for bit."""
    assert cnb.forward_route(torch.bfloat16, c) and k2.hopper_route(torch.bfloat16, c)
    x, *params = block_args(15, 2, *hw, c, torch.bfloat16, dev)
    got = cnb.convnext_block(x, *params)
    out, y = cnb.convnext_block_saving(x, *params)
    want, want_y = cnb.convnext_block_plain_saving(x, *params)
    g = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(16),
                    device=dev).to(torch.bfloat16)
    grads = k2.convnext_block_bwd(x, want_y, g, *params)
    want_grads = k2.convnext_block_bwd_plain(x, want_y, g, *params)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(y.float(), want_y.float(), atol=3e-2, rtol=3e-2)
    assert torch.equal(out, got)
    check_bwd(grads, want_grads, 3e-2)


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


@pytest.mark.parametrize("c", [48, 96, 192, 384, 512])
def test_bwd_hopper_pipeline_launches(dev, c):
    """A bf16 call up to C = 512 runs K2's Hopper pipeline: at most five
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


def test_augment_batch_on_card_matches_cpu(dev):
    """The mosaic, HSV and flip stage on the card against the CPU on the same
    fixed draws (one mosaic group used, one not; one image flipped, one
    not): boxes, valid, masks, ``img_cls``, ``id`` and ``sample_valid``
    equal, images within 1e-5; and with draws from a generator on the card."""
    from multitask_bonetumor_yolo_tpu_torch.data import preprocess

    rs = np.random.RandomState(3)
    b, s = 8, 64
    boxes = rs.uniform(0.1, 0.9, (b, 4, 5)).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.uint8)
    mask[:, 10:30, 20:50] = 1
    batch = {"image": torch.from_numpy(rs.randint(0, 256, (b, s, s, 3)).astype(np.uint8)),
             "boxes": torch.from_numpy(boxes),
             "box_valid": torch.from_numpy(np.arange(4)[None] < (np.arange(b) % 4)[:, None]),
             "mask": torch.from_numpy(mask), "img_cls": torch.arange(b, dtype=torch.int32),
             "id": torch.arange(b, dtype=torch.int32),
             "sample_valid": torch.ones(b, dtype=torch.bool)}
    cfg = preprocess.AugmentConfig(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, hflip_prob=0.5,
                                   mosaic_prob=0.5)
    draws = {"gate": torch.tensor([True, False]), "hsv": torch.rand(2, 3) * 2 - 1,
             "flip": torch.tensor([False, True])}
    want = preprocess.augment_apply(batch, cfg, draws)
    got = preprocess.augment_apply({k: v.to(dev) for k, v in batch.items()}, cfg,
                                   {k: v.to(dev) for k, v in draws.items()})
    assert sorted(got) == sorted(want)
    for k in ("boxes", "box_valid", "mask", "img_cls", "id", "sample_valid"):
        assert torch.equal(got[k].cpu(), want[k]), k
    torch.testing.assert_close(got["image"].cpu(), want["image"], atol=1e-5, rtol=0)
    out = preprocess.augment_batch({k: v.to(dev) for k, v in batch.items()},
                                   torch.Generator(device=dev).manual_seed(0), cfg)
    assert out["image"].shape == (2, s, s, 3) and out["image"].device.type == "cuda"


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_trainer_epoch_on_card(dev, tmp_path, monkeypatch, fmt):
    """One epoch of ``Trainer.fit`` on the card at a tiny config (128 px,
    depths 1/1/1/1 at widths 48/96/192/384, BiFPN 64, bf16, 16 synthetic
    PNGs or JPEGs: 1 step of 8, 1 val batch): the step launches K1's saving
    form and K2 once per block (4) and K1 none, the validation forward K1 4
    times; from JPEGs, which the loader's thread and the val cache's primer
    decode on the card at once, K6a and K6b launch once per JPEG read;
    finite losses; the last checkpoint written."""
    import json

    from multitask_bonetumor_yolo_tpu_torch.data import DataConfig, imageio, make_synthetic_btxrd
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import jpeg as k6
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig
    from multitask_bonetumor_yolo_tpu_torch.train import TrainConfig
    from multitask_bonetumor_yolo_tpu_torch.train.loop import ExperimentConfig, Trainer

    img = 128
    root = make_synthetic_btxrd(str(tmp_path / "d"), n=16, seed=11, min_size=96, max_size=200,
                               image_format=fmt)
    reads = []
    read_jpeg = imageio.read_jpeg

    def counted_read(*args, **kw):
        reads.append(1)  # list.append is atomic: both reading threads land here
        return read_jpeg(*args, **kw)

    monkeypatch.setattr(imageio, "read_jpeg", counted_read)
    cfg = ExperimentConfig(
        model=ModelConfig(img_size=img, single_head=True, backbone_depths=(1, 1, 1, 1),
                          backbone_dims=(48, 96, 192, 384), bifpn_num_layers=1,
                          bifpn_feature_size=64, proto_ch=8, dtype="bfloat16"),
        data=DataConfig(root=str(root), img_size=img, max_boxes=8, batch_size=8,
                        image_ext=f".{fmt}"),
        loss=LossConfig(img_size=img, iou_match_thresh=0.15),
        train=TrainConfig(lr=3e-4, max_epochs=1, seed=0, eval_top_k=10),
        run_dir=str(tmp_path / "run"), log_every=1)
    decodes = (k6.jpeg_idct.launches, k6.jpeg_color.launches)
    trainer = Trainer(cfg)
    assert trainer.state.mu.device.type == "cuda" and trainer.train_cfg.steps_per_epoch == 1
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    calls = []
    step, evaluate = trainer.train_step, trainer.eval_step

    def counted(fn):
        def run(*args):
            before = tuple(c.launches for c in counts)
            out = fn(*args)
            calls.append(tuple(c.launches - b for c, b in zip(counts, before)))
            return out
        return run

    trainer.train_step, trainer.eval_step = counted(step), counted(evaluate)
    trainer.fit()
    torch.cuda.synchronize()
    assert calls == [(0, 4, 4), (4, 0, 0)]
    want = len(reads)
    assert (want > 0) == (fmt == "jpeg")
    assert (k6.jpeg_idct.launches - decodes[0], k6.jpeg_color.launches - decodes[1]) == (want, want)
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").open()]
    losses = [v for r in recs for k, v in r.items() if "/loss_" in k]
    assert losses and all(np.isfinite(v) for v in losses)
    assert (trainer.ckpt.last_path() / "weights.npz").exists()


def jpeg_fixtures():
    """Seeded JPEG files made by the port's own writer (the card's machine has
    no cv2): three odd sizes in every sampling, a restart interval, grey."""
    from multitask_bonetumor_yolo_tpu_torch.data import jpeg

    rs = np.random.RandomState(5)
    files = []
    for h, w in ((37, 53), (64, 48), (129, 97)):
        yy, xx = np.mgrid[0:h, 0:w]
        base = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
        img = np.clip(np.stack([base, base[::-1], np.roll(base, 5, 1)], -1)
                      + rs.randint(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        for sampling in ("444", "422", "440", "420"):
            files.append(jpeg.encode_jpeg(img, 75, sampling=sampling))
        files.append(jpeg.encode_jpeg(img, 95, restart=2))
        files.append(jpeg.encode_jpeg(img[..., 1], 90))
    return files


def test_jpeg_kernels_match_plain(dev):
    """K6 (the C entropy decoder, K6a and K6b) against the plain version
    (the Python entropy decoder and the integer torch pipeline): 0 differing
    bytes in colour and grey reads, one launch of each kernel per read."""
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import jpeg as k6

    for data in jpeg_fixtures():
        for gray in (False, True):
            before = (k6.jpeg_idct.launches, k6.jpeg_color.launches)
            got = k6.decode_jpeg(data, gray=gray, device=dev)
            assert (k6.jpeg_idct.launches, k6.jpeg_color.launches) == (before[0] + 1,
                                                                       before[1] + 1)
            want = k6.decode_jpeg(data, gray=gray, device="cpu")
            assert got.dtype == np.uint8 and np.array_equal(got, want), (len(data), gray)


def test_jpeg_host_entropy_matches_python(dev):
    """The C entropy decoder equals the Python one coefficient for
    coefficient, and both raise ValueError on a truncated scan; the C decoder
    refuses a scan of no or more than 4 components before it reads anything."""
    from multitask_bonetumor_yolo_tpu_torch.data import jpeg
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import jpeg as k6

    for data in jpeg_fixtures():
        frame = jpeg.parse(data)
        got = k6.entropy_decode(data, frame, pin=True).numpy()
        assert np.array_equal(got, jpeg.entropy_decode_py(data, frame))
        cut = data[:len(data) // 2]
        for decode in (lambda: k6.entropy_decode(cut, jpeg.parse(cut)),
                       lambda: jpeg.entropy_decode_py(cut, jpeg.parse(cut))):
            with pytest.raises(ValueError, match="truncated|corrupt"):
                decode()
    for ns in (0, 5):
        assert k6._library().jpeg_entropy_scan(b"", 0, 0, ns, None, None, 0, 0, 0, None) == 3


def test_nccl_ranks_over_every_card(dev, tmp_path):
    """``parallel.dist`` over NCCL with one rank per visible card (one rank
    on a one-card machine: the world-size-1 group), spawned as the CLIs
    spawn theirs: each rank on its own card, the sum of the ranks' tensors,
    the rows gathered in rank order (booleans too), rank 0's object."""
    import json

    import torch_parallel_worker as worker
    from multitask_bonetumor_yolo_tpu_torch.parallel import dist

    n = torch.cuda.device_count()
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "device": "cuda", "collectives": True}))
    dist.spawn(worker.run, (str(spec),), n, str(tmp_path), device="cuda", backend="nccl",
               deadline_s=300)
    for r in range(n):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["collectives"]
        assert got["device"] == f"cuda:{r}"
        assert torch.equal(got["sum"], torch.full((3,), n * (n + 1) / 2))
        assert torch.equal(got["rows"], torch.arange(n).repeat_interleave(2)[:, None].expand(-1, 2))
        assert got["flags"].tolist() == [i % 2 == 0 for i in range(n)]
        assert got["object"] == {"from": 0}


DDP_CFG = dict(img_size=128, single_head=False, backbone_depths=(1, 1, 1, 1),
               backbone_dims=(48, 96, 192, 384), bifpn_num_layers=1, bifpn_feature_size=64,
               proto_ch=8, dtype="float32")


def test_two_gloo_ranks_on_one_card_match_one(dev, tmp_path):
    """Two gloo ranks (rank r on card r modulo the cards: both on card 0 of
    a one-card machine; 4 rows each) against one rank on the global batch
    of 8 for a train step at a small width (128 px, widths 48-384, depths
    1, HSV and flip, ``pallas`` and ``block_bwd`` "auto"),
    in fp32 with TF32 off (K1's saving form and K2 in their fp32 designs):
    they launch once per block (4) on each rank and on the one; the loss
    within 1e-4, grad_norm and the applied gradient within 1e-3 relative
    norm (the conv biases in front of a train-mode BN, whose gradient is
    rounding noise, within 1e-3 of the largest gradient element), the BN
    statistics within 1e-3; the ranks' states equal bit for bit. (In bf16
    the gradient behind the neck's train-mode BNs is mostly rounding noise,
    which follows the order of the sums; chip_smoke.py's phase ``ddp``
    prints that gap at full width beside one rank's own.)"""
    import json
    import re

    import torch_parallel_worker as worker
    from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig
    from multitask_bonetumor_yolo_tpu_torch.parallel import create_mesh, dist

    sd = perturbed_model(ModelConfig(**DDP_CFG)).state_dict()
    host = {k: v.numpy() for k, v in synthetic_batch(8, 128, torch.Generator().manual_seed(2)).items()}
    host["mask"] = host["mask"].astype(np.uint8)
    torch.save({"state_dict": sd, "batch": {k: torch.from_numpy(v) for k, v in host.items()}},
               tmp_path / "steps.pt")
    steps = {"inputs": str(tmp_path / "steps.pt"), "model": DDP_CFG,
             "loss": {"img_size": 128, "iou_match_thresh": 0.15}, "train": {"lr": 1e-4},
             "augment": {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "hflip_prob": 0.5},
             "seed": 3, "n": 1}
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "device": "cuda", "steps": steps}))
    dist.spawn(worker.run, (str(spec),), 2, str(tmp_path), device="cuda", backend="gloo",
               deadline_s=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["steps"] for r in range(2)]
    one = worker.train_steps(DDP_CFG, steps["loss"], steps["train"], steps["augment"], sd, host,
                             create_mesh(device=dev, world_size=1, rank=0), steps["seed"], n=1)
    torch.cuda.synchronize()
    assert one["launches"] == [(0, 4, 4)] and all(r["launches"] == [(0, 4, 4)] for r in ranks)
    a, b = ranks[0]["metrics"][0], one["metrics"][0]
    assert b["step_skipped"] == 0.0 and a["step_skipped"] == 0.0
    assert abs(a["loss_total"] / b["loss_total"] - 1) <= 1e-4
    assert abs(a["grad_norm"] / b["grad_norm"] - 1) <= 1e-3
    names = [n for n, _ in one["state"].model.named_parameters()]
    noise = [bool(re.search(r"ConvBN_0\.Conv_0\.bias$", n)) for n in names]
    got, want = ranks[0]["applied"][0], [g.cpu() for g in one["applied"][0]]
    top = max(float(g.abs().max()) for g in want)

    def held(gs):
        return torch.cat([g.reshape(-1).double() for g, z in zip(gs, noise) if not z])

    assert float((held(got) - held(want)).norm() / held(want).norm()) <= 1e-3
    assert all(float((g - w).abs().max()) <= 1e-3 * top
               for g, w, z in zip(got, want, noise) if z)
    sd1 = one["state"].model.state_dict()
    stats = [k for k in sd1 if k.endswith(("running_mean", "running_var"))]
    s1 = torch.cat([sd1[k].reshape(-1).cpu().double() for k in stats])
    s2 = torch.cat([ranks[0]["state_dict"][k].reshape(-1).double() for k in stats])
    assert float((s2 - s1).norm() / s1.norm()) <= 1e-3
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(ranks[1]["state_dict"][k], v), k
