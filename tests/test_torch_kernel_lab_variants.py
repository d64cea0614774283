"""The kernel lab's (K5) other eight variants, and its entry point
(``tools/kernel_lab.py``), against the JAX lab in Pallas interpret mode on
the CPU, as tests/test_torch_kernel_lab.py runs it (same loader, same
seeded inputs, same tolerances: the dw schedules within one bf16 step, the
bf16-arithmetic variants at the bf16 tolerance 3e-2, since JAX on the CPU
may keep excess precision inside a fused bf16 expression where the port
rounds after each op).
"""

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.ops.kernels import kernel_lab as lab
from multitask_bonetumor_yolo_tpu_torch.tools import kernel_lab as tools
from test_torch_kernel_lab import (BF16_TOL, ONE_BF16_STEP, check_against_jax,
                                   jax_lab_outputs)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(1, 8, 8, 48, 4)]
SCHEDULES = ("dwexpr", "dwrow", "dwrow2", "dwrownh", "dwrowreg")
NAMES = ("dwbf16", "mlpgelubf16", "mlptanh") + SCHEDULES


@pytest.fixture(scope="module")
def jax_outputs():
    return jax_lab_outputs(NAMES, SHAPES)


def test_dwbf16(jax_outputs):
    check_against_jax(jax_outputs, "dwbf16", SHAPES, BF16_TOL)


def test_mlpgelubf16(jax_outputs):
    check_against_jax(jax_outputs, "mlpgelubf16", SHAPES, BF16_TOL)


def test_dw_schedules(jax_outputs):
    """Five more schedules of one function: each within one bf16 step of the
    JAX lab's output under the same name, and the port's plain versions of
    all six identical."""
    for name in SCHEDULES:
        check_against_jax(jax_outputs, name, SHAPES, ONE_BF16_STEP)
    outs = [tools.build_variant(n, 1, 8, 8, 48, 0, torch.bfloat16, device="cpu")
            for n in ("dw",) + SCHEDULES]
    for run, x in outs[1:]:
        torch.testing.assert_close(run(x), outs[0][0](outs[0][1]), rtol=0, atol=0)


def test_mlptanh(jax_outputs):
    """The JAX lab's explicit tanh-GELU: the same function as ``mlpgelu``,
    and in the port the same instantiation."""
    check_against_jax(jax_outputs, "mlptanh", SHAPES, BF16_TOL)
    assert lab.SHARES["mlptanh"] == "mlpgelu"
    assert lab.VARIANTS["mlptanh"] == lab.VARIANTS["mlpgelu"]


def test_build_variant_padded_io_and_refusals():
    """``padded_io`` only moves the operands' fold out of ``run``: the same
    x and output; ``rc`` is the tile TM (K1's, or the other Hopper tile) and
    nothing else."""
    plain = tools.build_variant("full", 2, 4, 6, 48, 0, torch.bfloat16, device="cpu")
    padded = tools.build_variant("full", 2, 4, 6, 48, 128, torch.bfloat16, padded_io=True,
                                 device="cpu")
    torch.testing.assert_close(plain[1], padded[1], rtol=0, atol=0)
    torch.testing.assert_close(plain[0](plain[1]), padded[0](padded[1]), rtol=0, atol=0)
    assert tuple(padded[0](padded[1]).shape) == (2, 4, 6, 48)
    with pytest.raises(ValueError, match=r"legal: \(64, 128\)"):
        tools.build_variant("dw", 1, 4, 4, 96, 32, torch.bfloat16, device="cpu")
    with pytest.raises(TypeError):
        tools.build_variant("dw", 1, 4, 4, 96, 0, torch.float32, device="cpu")


def test_main_prints_one_line_per_variant(capsys):
    """``main`` on the CPU (plain versions): a header with the tile, one
    ``{variant:<8s} {ms:7.3f} ms`` line per variant, the shared instantiation
    named; an illegal ``--rc`` raises and names the legal tiles."""
    names = ",".join(lab.VARIANTS)
    times = tools.main(["--device", "cpu", "--img", "32", "--batch", "1", "--iters", "1",
                        "--variants", names])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("stage0 8x8x96 TM=64 ") and "batch=1" in lines[0]
    assert len(lines) == 1 + len(lab.VARIANTS) and list(times) == list(lab.VARIANTS)
    for line, name in zip(lines[1:], lab.VARIANTS):
        assert line.startswith(f"  {name:<8s} ") and " ms" in line
        assert np.isfinite(times[name]) and times[name] > 0
    assert "(= mlpgelu)" in lines[1 + list(lab.VARIANTS).index("mlptanh")]
    with pytest.raises(ValueError, match=r"legal: \(64, 128\)"):
        tools.main(["--device", "cpu", "--img", "32", "--stage", "1", "--rc", "16"])


def test_main_runs_on_the_card_unless_told_cpu(monkeypatch):
    """``--device`` defaults to the card: without one ``main`` raises before
    doing any work, instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tools.main(["--img", "32", "--batch", "1", "--iters", "1"])
