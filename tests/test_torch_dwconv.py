"""The port's depthwise 7x7 convolution (kernel K3's plain version and the
wrapper's CPU route) against the JAX package's Pallas ``dwconv7``, run in
interpret mode on the CPU as tests/test_pallas_convnext.py runs it.

Inputs are made with numpy from a seed and handed to both packages in the
JAX layout (x NHWC, taps [7, 7, C]). The CUDA kernel runs only on the card:
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.ops.pallas.dwconv import dwconv7 as jax_dwconv7
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import dwconv as k3
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (1, 8, 12, 16)  # b, h, w (not h: a transposed tap shows), c


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    """Seeded x (rounded to the dtype) and taps, and JAX's interpret-mode
    ``dwconv7`` of them (one run per dtype: each takes seconds)."""
    rs = np.random.RandomState(20)
    x = jnp.asarray(rs.randn(*SHAPE).astype(np.float32)).astype(request.param)
    taps = rs.randn(7, 7, SHAPE[-1]).astype(np.float32) * 0.1
    want = np.asarray(jax_dwconv7(x, jnp.asarray(taps), interpret=True))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, request.param))
    return xt, torch.from_numpy(taps), want


def test_plain_matches_jax_dwconv7(case):
    """fp32 taps and accumulation in both, fp32 out; the bf16 input is exact
    in fp32, so both dtypes agree up to the order of the 49 sums (1e-4)."""
    x, taps, want = case
    got = k3.dwconv7_plain(x, taps)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_wrapper_on_cpu_is_plain_and_does_not_launch(case):
    x, taps, _ = case
    before = k3.dwconv7.launches
    got = k3.dwconv7(x, taps)
    assert k3.dwconv7.launches == before
    assert torch.equal(got, k3.dwconv7_plain(x, taps))
