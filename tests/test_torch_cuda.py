"""The port's CUDA kernels (K1 in both forms, K2) and its device-side NMS on
the card.

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
