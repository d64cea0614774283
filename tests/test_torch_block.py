"""The port's ConvNeXt block (kernel K1's plain twin, the eager erf
reference, and the wrapper's CPU route) against the JAX package, on the CPU.

Inputs are made with numpy from a seed (as tests/test_pallas_convnext.py's
``make_args``: gamma ~0.5, LN scale ~1) and handed to both packages; the
port takes them in its torch layouts (dw [C,1,7,7], w1 [4C,C], w2 [C,4C]).
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block import (
    convnext_block as jax_convnext_block,
    convnext_block_ref as jax_convnext_block_ref,
)
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as port
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def make_args(seed, b=2, h=16, w=16, c=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    f = lambda *s: rng.randn(*s).astype(np.float32) * 0.1  # noqa: E731
    return (x, f(7, 7, 1, c), f(c), f(c) + 1.0, f(c), f(c, 4 * c), f(4 * c),
            f(4 * c, c), f(c), f(c) * 0.5)


def to_port(args, dtype=torch.float32, device="cpu"):
    """numpy JAX-layout args -> torch tensors in the port's layouts."""
    x, dw, dwb, lns, lnb, w1, b1, w2, b2, g = args
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(x).to(dtype), t(dw.transpose(3, 2, 0, 1)), t(dwb), t(lns), t(lnb),
            t(w1.T), t(b1), t(w2.T), t(b2), t(g))


def test_twin_matches_jax_pallas_kernel_nonsquare():
    """The twin against the JAX Pallas kernel in interpret mode: b=1,
    h=12, w=20, c=16, fp32, atol 2e-4 (tests/test_pallas_convnext.py)."""
    args = make_args(0, b=1, h=12, w=20, c=16)
    want = jax_convnext_block(*map(jnp.asarray, args), 1e-6, True)
    got = port.convnext_block_plain(*to_port(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_ref_matches_jax_ref():
    """Eager erf reference against JAX ``convnext_block_ref`` at 1e-5."""
    args = make_args(1)
    with jax.default_matmul_precision("highest"):
        want = jax_convnext_block_ref(*map(jnp.asarray, args))
    got = port.convnext_block_ref(*to_port(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_ref_matches_jax_ref_bf16():
    """bf16 compute dtype: both references round at the same places up to
    accumulation order; bf16 tolerance 3e-2."""
    args = make_args(2, b=1, h=8, w=12, c=32)
    jargs = list(map(jnp.asarray, args))
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    want = np.asarray(jax_convnext_block_ref(*jargs)).astype(np.float32)
    got = port.convnext_block_ref(*to_port(args, torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_twin_matches_ref_within_gelu_gap():
    """tanh-GELU twin vs erf reference: the ~3e-4 GELU gap, scaled by the
    fc2 weights, stays far inside 2e-3 at these magnitudes."""
    args = to_port(make_args(3, b=1, h=9, w=7, c=48))
    np.testing.assert_allclose(port.convnext_block_plain(*args).numpy(),
                               port.convnext_block_ref(*args).numpy(), atol=2e-3)


def test_wrapper_on_cpu_is_the_twin_and_does_not_launch():
    args = to_port(make_args(4, b=1, h=5, w=6, c=16))
    before = port.convnext_block.launches
    got = port.convnext_block(*args)
    assert port.convnext_block.launches == before
    assert torch.equal(got, port.convnext_block_plain(*args))


def test_fold_matches_unfolded_math():
    """The LN/gamma folds are exact in fp32: LN(y) @ w1 + b1 ==
    z @ (ln_scale*w1) + (ln_bias@w1 + b1)."""
    _, dw, dwb, lns, lnb, w1, b1, w2, b2, g = to_port(make_args(5, c=16))
    _, _, w1f, b1f, w2f, b2f = port.fold_block_params(dw, dwb, lns, lnb, w1, b1, w2, b2, g)
    z = torch.from_numpy(np.random.RandomState(6).randn(10, 16).astype(np.float32))
    torch.testing.assert_close(z @ w1f + b1f, (z * lns + lnb) @ w1.T + b1, atol=1e-5, rtol=1e-5)
    hid = torch.from_numpy(np.random.RandomState(7).randn(10, 64).astype(np.float32))
    torch.testing.assert_close(hid @ w2f + b2f, (hid @ w2.T + b2) * g, atol=1e-5, rtol=1e-5)
