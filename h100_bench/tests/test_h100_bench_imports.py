"""What the benchmark imports: no module of the JAX stack or of the JAX
package anywhere (a process that serves a run holds none), and nothing of
the program in the plain reference. Top-level module names are compared
whole: the program's name begins with the JAX package's.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from h100_bench.harness import FORBIDDEN

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PROGRAM = "multitask_bonetumor_yolo_tpu_torch"


def _held_after(code: str) -> list:
    """Top-level module names in ``sys.modules`` after ``code`` runs in a
    fresh interpreter at the checkout's root."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def _all_modules() -> str:
    """Code that imports every module of the benchmark, its drivers and
    readers by path, and the program's modules that the drivers import."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in BENCH.rglob("*.py")
            if "tests" not in p.parts and p.parent.name not in ("drivers", "metrics")]
    lines = [f"import {m}" for m in mods]
    lines += ["from h100_bench.spec import Bench", "b = Bench()",
              "[b.driver(k) for k in ('serve', 'train')]",
              "[b.metric_reader(m['name']) for m in b.data['per_layer']]",
              f"import {PROGRAM}.cli.infer, {PROGRAM}.train, {PROGRAM}.losses",
              f"import {PROGRAM}.ops.kernels.convnext_block, {PROGRAM}.ops.kernels.convnext_block_bwd"]
    return "\n".join(lines)


def test_nothing_of_jax_is_imported():
    held = set(_held_after(_all_modules()))
    assert PROGRAM in held  # the program is loaded: its own imports are walked too
    assert not held & set(FORBIDDEN), held & set(FORBIDDEN)


def test_forbidden_names_are_whole_top_level_names():
    from h100_bench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["multitask_bonetumor_yolo_tpu_torch_probe"] = sys
        assert "multitask_bonetumor_yolo_tpu" not in harness.forbidden_modules()
        sys.modules["multitask_bonetumor_yolo_tpu.core"] = sys
        assert "multitask_bonetumor_yolo_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_reference_imports_nothing_of_the_program():
    refs = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in (BENCH / "reference").glob("*.py")]
    held = set(_held_after("\n".join(f"import {m}" for m in refs)))
    assert PROGRAM not in held and not held & set(FORBIDDEN)
    for p in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else []
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "__future__", "math",
                                           "dataclasses", "typing", "contextlib"), (p.name, n)
