"""The port's kernel lab (K5: the plain versions of its variants, through the
entry point's ``build_variant`` on the CPU, and the wrapper's CPU route)
against the JAX lab, ``scripts/kernel_lab.py``, run in Pallas interpret mode.

The JAX lab is loaded from its path (it is a script, not a module of the
package) with ``jax.experimental.pallas.pallas_call`` wrapped as
``partial(..., interpret=True)`` for this module only; nothing in the JAX
package or the script changes. Both sides draw the same seeded inputs
(``RandomState(0)``), so the port's x is the JAX lab's and its output is
compared with the JAX output's first C channels. Tolerances: ``copy``
bit-exact; the dw family and ``dwln`` within one bf16 step (rtol 2^-7,
atol 1e-3: fp32 sums in another order, and K1's one-pass LN moments against
the JAX lab's two-pass ones, round to neighbouring bf16 values); the rest
atol/rtol 3e-2, the repo's bf16 kernel tolerance. The other eight variants
and the entry point itself: tests/test_torch_kernel_lab_variants.py. The
CUDA kernels run only on the card: tests/test_torch_cuda.py.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas

from multitask_bonetumor_yolo_tpu_torch.ops.kernels import kernel_lab as lab
from multitask_bonetumor_yolo_tpu_torch.tools import kernel_lab as tools
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "kernel_lab.py"
SHAPES = [(1, 8, 8, 48, 4), (2, 16, 16, 96, 8)]  # b, h, w, c, the JAX lab's rc
NAMES = ("copy", "dw", "dwln", "mlp", "mlpgelu", "full")
ONE_BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def jax_lab_outputs(names, shapes):
    """{(name, shape): (x, out[..., :c])} of the JAX lab in interpret mode,
    both as fp32 numpy arrays."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call",
                   functools.partial(pallas.pallas_call, interpret=True))
        spec = importlib.util.spec_from_file_location("jax_kernel_lab", SCRIPT)
        jlab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jlab)
        for shape in shapes:
            b, h, w, c, rc = shape
            for name in names:
                run, x = jlab.build_variant(name, b, h, w, c, rc, jnp.bfloat16)
                out[name, shape] = (np.asarray(x.astype(jnp.float32)),
                                    np.asarray(run(x).astype(jnp.float32))[..., :c])
    return out


def check_against_jax(outputs, name, shapes, tol):
    """The port's ``build_variant(name, ..., device="cpu")`` on the same
    seeded x as the JAX lab, within ``tol`` of its output."""
    for shape in shapes:
        b, h, w, c, _ = shape
        want_x, want = outputs[name, shape]
        run, x = tools.build_variant(name, b, h, w, c, 0, torch.bfloat16, device="cpu")
        np.testing.assert_array_equal(x.float().numpy(), want_x)
        got = run(x)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
        np.testing.assert_allclose(got.float().numpy(), want, **tol,
                                   err_msg=f"{name} at {shape}")


@pytest.fixture(scope="module")
def jax_outputs():
    return jax_lab_outputs(NAMES, SHAPES)


def test_copy(jax_outputs):
    check_against_jax(jax_outputs, "copy", SHAPES, dict(rtol=0, atol=0))


def test_dw(jax_outputs):
    check_against_jax(jax_outputs, "dw", SHAPES, ONE_BF16_STEP)


def test_dwln(jax_outputs):
    """K1's LN (one-pass fp32 moments) against the JAX lab's two-pass LN,
    which masks the padded lanes at C = 48 and divides by C."""
    check_against_jax(jax_outputs, "dwln", SHAPES, ONE_BF16_STEP)


def test_mlp(jax_outputs):
    check_against_jax(jax_outputs, "mlp", SHAPES, BF16_TOL)


def test_mlpgelu(jax_outputs):
    check_against_jax(jax_outputs, "mlpgelu", SHAPES, BF16_TOL)


def test_full(jax_outputs):
    check_against_jax(jax_outputs, "full", SHAPES, BF16_TOL)


def test_cpu_route_is_the_plain_version_and_does_not_launch():
    """On a CPU tensor ``lab_variant`` returns the plain version and counts no
    launch; on either device it refuses an unknown name, fp32, C not a
    multiple of 16 and C > 768."""
    x, dw, w1, w2 = tools.lab_inputs(1, 5, 6, 32, device="cpu")
    ops = tools.fold(dw, w1, w2, 32)[:3]
    before = lab.lab_variant.launches
    for name in lab.VARIANTS:
        torch.testing.assert_close(lab.lab_variant(name, x, *ops),
                                   lab.lab_variant_plain(name, x, *ops), rtol=0, atol=0)
    assert lab.lab_variant.launches == before
    with pytest.raises(ValueError, match="unknown variant"):
        lab.lab_variant("dwfast", x, *ops)
    with pytest.raises(TypeError):
        lab.lab_variant("dw", x.float(), *ops)
    with pytest.raises(ValueError, match="multiple of 16"):
        lab.lab_variant("dw", torch.zeros(1, 4, 4, 24, dtype=torch.bfloat16), *ops)
    with pytest.raises(ValueError, match="multiple of 16"):
        lab.lab_variant("dw", torch.zeros(1, 2, 2, 784, dtype=torch.bfloat16), *ops)
    assert lab.lab_variant.launches == before
