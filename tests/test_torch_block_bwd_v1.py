"""The block's recompute-form backward (kernel K4's plain version), the
explicit backward and the two autograd routes that run them, against the
JAX package on the CPU: ``fused_block_bwd`` (the v1 Pallas kernel) in
interpret mode, and ``_bwd_padded`` under ``CNB_EXPLICIT_BWD=1`` (its two
depthwise convolutions the Pallas ``dwconv7`` in interpret mode).

Inputs come from tests/test_torch_block.py's ``make_args`` (numpy, seeded;
JAX layouts) and ``to_port``; b=1, h=8, w=8, c=16, the single-chunk size of
tests/test_pallas_convnext.py. The CUDA kernels run only on the card:
tests/test_torch_cuda.py and chip_smoke.py. K4's Hopper pipeline computes
dw2 and dgamma in K2's derived forms; :func:`k4_hopper_math` writes that
math out in plain torch, so that the CPU holds the substitution against the
JAX kernel too.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block import (
    pad_for_blocks, unpad_from_blocks,
)
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as port
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as bwds
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import dwconv as k3
from test_torch_block import make_args, to_port
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

B, H, W, C = 1, 8, 8, 16


@pytest.fixture(scope="module")
def block():
    """Seeded block arguments (JAX layouts) and cotangent."""
    g = np.random.RandomState(31).randn(B, H, W, C).astype(np.float32)
    return make_args(30, b=B, h=H, w=W, c=C), g


@pytest.fixture(scope="module")
def jax_v1(block):
    """JAX ``fused_block_bwd(..., interpret=True)`` on the block's x, cotangent
    and raw weights in ``dtype``, in the port's layouts; each dtype's result
    is computed once (an interpret-mode call takes ~13 s)."""
    from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block_bwd import fused_block_bwd

    args, g = block
    cache = {}

    def get(dtype):
        if dtype not in cache:
            x, *params = map(jnp.asarray, args)
            x, gj = x.astype(dtype), jnp.asarray(g).astype(dtype)
            cache[dtype] = to_port_grads(fused_block_bwd(
                pad_for_blocks(x), pad_for_blocks(gj), *params, w=W, c=C, interpret=True))
        return cache[dtype]

    return get


def k4_hopper_math(x, g, *params, eps=1e-6):
    """K4's Hopper pipeline in plain torch: v1's operands (the plain
    version's: y, the LN moments and z in fp32, h1 from dt(z * ln_scale +
    ln_bias) and dt(w1), d_a from dt(g * gamma) and dt(w2)), with dw2 and
    dgamma in K2's derived forms, ``W = dt(g)^T dt(a)``, ``dw2 = gamma * W``
    and ``dgamma = sum_j dt(w2) W + b2 sum g``."""
    dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma = params
    out = list(bwds.convnext_block_bwd_v1_plain(x, g, *params, eps=eps))
    dt, c = x.dtype, x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), dw_kernel.float(), dw_bias.float(), padding=3,
                 groups=c).permute(0, 2, 3, 1).reshape(-1, c)
    mean = y.mean(-1, keepdim=True)
    r = torch.rsqrt(((y * y).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0) + eps)
    z2 = ((y - mean) * r * ln_scale + ln_bias).to(dt).float()
    a = port.gelu_tanh(z2 @ w1.to(dt).float().t() + b1).to(dt).float()
    gf = g.float().reshape(-1, c)
    wg = gf.t() @ a
    out[7] = gamma[:, None] * wg
    out[9] = (w2.to(dt).float() * wg).sum(1) + b2 * gf.sum(0)
    return out


def to_port_grads(grads, w=W, c=C):
    """JAX's ten cotangents (dx padded) -> the port's layouts: taps [7,7,1,C]
    -> [C,1,7,7], w1 [C,4C] and w2 [4C,C] transposed."""
    out = [np.asarray(unpad_from_blocks(grads[0], w, c)).astype(np.float32)]
    out += [np.asarray(t) for t in grads[1:]]
    out[1] = out[1].transpose(3, 2, 0, 1)
    out[5] = out[5].T
    out[7] = out[7].T
    return out


def check_grads(got, want, tol_dx, tol):
    """dx elementwise at ``tol_dx``; each parameter gradient, a sum over the
    64 pixels, within ``tol`` of its own scale (plus 1e-6)."""
    np.testing.assert_allclose(got[0].float().numpy(), want[0], atol=tol_dx, rtol=tol_dx)
    for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        a = a.detach().numpy()
        assert a.shape == b.shape and a.dtype == np.float32, i
        err = np.abs(a - b).max()
        assert err <= tol * np.abs(b).max() + 1e-6, (i, err, np.abs(b).max())


@pytest.mark.parametrize("dtype,tol_dx,tol", [
    ("float32", 1e-4, 1e-4),
    # both round the same operands to bf16 at the same places and sum in fp32
    # in other orders: dx within one bf16 rounding step (1/64 at |dx| < 4),
    # the fp32 gradients within 1e-4 of their scale
    ("bfloat16", 1.6e-2, 1e-4),
])
def test_v1_plain_matches_jax_fused_block_bwd(block, jax_v1, dtype, tol_dx, tol):
    """K4's plain version against JAX ``fused_block_bwd(..., interpret=True)``
    on the same x, cotangent and raw weights."""
    args, g = block
    want = jax_v1(dtype)
    tdt = getattr(torch, dtype)
    xt, *pt = to_port(args, tdt)
    got = bwds.convnext_block_bwd_v1_plain(xt, torch.from_numpy(g).to(tdt), *pt)
    assert got[0].dtype == tdt
    check_grads(got, want, tol_dx, tol)


def test_k4_hopper_math_matches_jax_fused_block_bwd(block, jax_v1):
    """K4's Hopper math (:func:`k4_hopper_math`, the derived forms of dw2 and
    dgamma) against JAX ``fused_block_bwd`` in bf16, at the tolerance the
    card holds K4 to (3e-2: dx elementwise, each gradient of its scale)."""
    args, g = block
    xt, *pt = to_port(args, torch.bfloat16)
    got = k4_hopper_math(xt, torch.from_numpy(g).to(torch.bfloat16), *pt)
    check_grads(got, jax_v1("bfloat16"), 3e-2, 3e-2)


def test_explicit_matches_jax_explicit_bwd(block, monkeypatch):
    """``convnext_block_bwd_explicit`` against JAX ``_bwd_padded`` with
    ``CNB_EXPLICIT_BWD=1`` (called directly: the variable is read when the
    function runs, and no jit caches an earlier trace), fp32: dx at 1e-4 and
    each gradient within 1e-4 of its scale."""
    from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block import _bwd_padded

    monkeypatch.setenv("CNB_EXPLICIT_BWD", "1")
    monkeypatch.delenv("CNB_FUSED_BWD", raising=False)
    args, g = block
    x, *params = map(jnp.asarray, args)
    residuals = (pad_for_blocks(x), *params)
    want = to_port_grads(_bwd_padded(W, C, 1e-6, True, 0, "ref", True, residuals,
                                     pad_for_blocks(jnp.asarray(g))))
    before = k3.dwconv7.launches
    xt, *pt = to_port(args)
    got = bwds.convnext_block_bwd_explicit(xt, torch.from_numpy(g), *pt)
    assert k3.dwconv7.launches == before  # CPU tensors: K3's plain version
    check_grads(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("route,fn", [
    ("fused_v1", bwds.convnext_block_bwd_v1_plain),
    ("explicit", bwds.convnext_block_bwd_explicit),
])
def test_autograd_route_on_cpu_is_its_backward(block, route, fn):
    """``convnext_block(..., bwd=route)`` recorded by autograd on the CPU:
    the forward is K1's plain twin (inference form), the gradients are
    exactly ``fn``'s on the same cotangent, and nothing launches."""
    args, g = block
    leaves = [t.requires_grad_() for t in to_port(args)]
    counts = (port.convnext_block.launches, port.convnext_block_saving.launches,
              bwds.convnext_block_bwd.launches, bwds.convnext_block_bwd_v1.launches,
              k3.dwconv7.launches)
    out = port.convnext_block(*leaves, bwd=route)
    out.backward(torch.from_numpy(g))
    assert (port.convnext_block.launches, port.convnext_block_saving.launches,
            bwds.convnext_block_bwd.launches, bwds.convnext_block_bwd_v1.launches,
            k3.dwconv7.launches) == counts
    plain = [t.detach() for t in leaves]
    assert torch.equal(out.detach(), port.convnext_block_plain(*plain))
    want = fn(plain[0], torch.from_numpy(g), *plain[1:])
    for i, (t, w) in enumerate(zip(leaves, want)):
        assert torch.equal(t.grad, w), i


def test_unknown_backward_raises(block):
    args, _ = block
    with pytest.raises(ValueError, match="unknown block backward"):
        port.convnext_block(*to_port(args), bwd="v1")
