"""The training forms of the port's ConvNeXt block against the JAX package,
on the CPU: K1's residual-saving twin, K2's plain version and the autograd
Function that ties them, each against the Pallas kernels in interpret mode.

Inputs come from tests/test_torch_block.py's ``make_args`` (numpy, seeded;
JAX layouts) and ``to_port``. These tests live apart from that file so
that each test file holds fewer tests than tests/test_train_fast.py: the
parallel runner hands out files in order of their test counts, and the
suite's longest file should start first.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block import (
    convnext_block as jax_convnext_block,
)
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as port
from test_torch_block import make_args, to_port
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def _jax_padded(args, save_res):
    """JAX ``_forward_padded`` in interpret mode, unpadded: (out, y) or out."""
    from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block import (
        _forward_padded, pad_for_blocks, unpad_from_blocks,
    )

    x, *params = map(jnp.asarray, args)
    w, c = x.shape[2], x.shape[3]
    res = _forward_padded(pad_for_blocks(x), *params, w, c, 1e-6, True, save_res=save_res)
    return tuple(unpad_from_blocks(t, w, c) for t in res)


@pytest.fixture(scope="module")
def saved():
    """Block arguments at b=1, h=8, w=8, c=16 (tests/test_pallas_convnext.py's
    single-chunk size) and JAX's residual-saving forward of them, (out, y),
    shared by the two tests below (each interpret-mode run takes seconds)."""
    args = make_args(10, b=1, h=8, w=8, c=16)
    return args, *_jax_padded(args, save_res=True)


def test_saving_twin_matches_jax_save_res(saved):
    """The saving twin's ``y`` (and ``out``) against JAX ``_forward_padded(...,
    save_res=True, interpret=True)``, fp32: ``y`` is the fp32 dwconv plus bias
    in both (1e-5); ``out`` differs only by the z-free LN form (2e-4)."""
    args, want_out, want_y = saved
    out, y = port.convnext_block_plain_saving(*to_port(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-4)
    assert torch.equal(out, port.convnext_block_plain(*to_port(args)))


def test_bwd_plain_matches_jax_fused_bwd_v2(saved):
    """K2's plain version against JAX ``fused_block_bwd_v2(..., interpret=True)``
    at b=1, h=8, w=8, c=16, fp32, from the same saved y and cotangent: dx at
    1e-4; each parameter gradient, a sum over 64 pixels, within 1e-4 of its
    own scale (max |got - want| <= 1e-4 * max |want|, plus 1e-6)."""
    from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block import (
        pad_for_blocks, unpad_from_blocks,
    )
    from multitask_bonetumor_yolo_tpu.ops.pallas.convnext_block_bwd import fused_block_bwd_v2

    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2

    args, _, y = saved
    g = np.random.RandomState(11).randn(1, 8, 8, 16).astype(np.float32)
    x, *params = map(jnp.asarray, args)
    want = fused_block_bwd_v2(pad_for_blocks(x), pad_for_blocks(y), pad_for_blocks(jnp.asarray(g)),
                              *params, w=8, c=16, interpret=True)
    xt, *pt = to_port(args)
    got = k2.convnext_block_bwd_plain(xt, torch.tensor(np.asarray(y)), torch.from_numpy(g), *pt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(unpad_from_blocks(want[0], 8, 16)),
                               atol=1e-4, rtol=1e-4)
    # JAX layouts -> the port's: taps [7,7,1,C] -> [C,1,7,7], w1 [C,4C] and w2 [4C,C] transposed
    jax_in_port = [np.asarray(t) for t in want[1:]]
    jax_in_port[0] = jax_in_port[0].transpose(3, 2, 0, 1)
    jax_in_port[4] = jax_in_port[4].T
    jax_in_port[6] = jax_in_port[6].T
    for i, (a, b) in enumerate(zip(got[1:], jax_in_port)):
        b = b.reshape(a.shape)
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-4 * np.abs(b).max() + 1e-6, (i, err, np.abs(b).max())


def test_autograd_function_on_cpu_matches_jax_grad():
    """``convnext_block`` recorded by autograd on the CPU (plain saving form
    forward, plain K2 backward) against ``jax.grad`` through ``convnext_block
    (..., bwd="fused", interpret=True)``: the gradient of sum(out * w) for a
    fixed random w, every argument, fp32, at 2e-4 of each gradient's scale;
    and ``bwd="ref"`` (the vjp of the eager erf block) against it within the
    ~3e-4 tanh/erf GELU gap (2e-3 of scale)."""
    args = make_args(12, b=1, h=8, w=8, c=16)
    wgt = np.random.RandomState(13).randn(1, 8, 8, 16).astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_convnext_block(*a, 1e-6, True, 0, "fused") * wgt)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(10))))(*map(jnp.asarray, args))
    want = [np.asarray(want[0]), np.asarray(want[1]).transpose(3, 2, 0, 1),
            *[np.asarray(t) for t in want[2:5]], np.asarray(want[5]).T, np.asarray(want[6]),
            np.asarray(want[7]).T, *[np.asarray(t) for t in want[8:]]]
    for bwd, tol in (("fused", 2e-4), ("ref", 2e-3)):
        leaves = [t.requires_grad_() for t in to_port(args)]
        before = port.convnext_block.launches, port.convnext_block_saving.launches
        out = port.convnext_block(*leaves, bwd=bwd)
        (out * torch.from_numpy(wgt)).sum().backward()
        assert (port.convnext_block.launches, port.convnext_block_saving.launches) == before
        for i, (t, b) in enumerate(zip(leaves, want)):
            err = np.abs(t.grad.numpy() - b).max()
            assert err <= tol * np.abs(b).max() + 1e-6, (bwd, i, err, np.abs(b).max())
