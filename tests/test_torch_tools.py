"""The port's profiling tools (``tools/bench_block.py``, ``tools/profile_infer.py``,
``tools/profile_train.py``) against the JAX repo's scripts of the same names.

The JAX scripts are read, never run: :func:`jax_rows` takes the names of
their rows from their ``report(...)`` calls (``ast``), and a name built in
the per-stage loop is formatted at each stage's shape. Each port tool runs
on the CPU at 64^2, batch 2 (the plain versions of the kernels), and must
print those names in that order; ``profile_train``'s per-stage row is named
by the port's route, ``ref``, where the JAX script says ``default`` (the
tool's docstring maps the columns). ``timeloop`` is replaced by one call per
row here: these tests hold the rows and what each row computes, not times
(on the CPU a full-width AdamW update alone takes seconds). The component
rows of ``profile_infer`` chained give the model's own outputs. The CUDA
kernels the tools launch on the card are held by ``chip_smoke.py``'s phase
``tools``.
"""

import ast
import time
from pathlib import Path

import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from multitask_bonetumor_yolo_tpu_torch.tools import bench_block, common, profile_infer
from multitask_bonetumor_yolo_tpu_torch.tools import profile_train
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
IMG, BATCH = 64, 2
ARGV = ["--img", str(IMG), "--batch", str(BATCH), "--iters", "1", "--device", "cpu"]


def template(node) -> str:
    """A ``str`` constant, or an f-string as a ``str.format`` template."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant) else "{" + ast.unparse(v.value) + "}"
                   for v in node.values)


def jax_rows(script: str) -> list:
    """The row names of ``scripts/<script>``'s ``report`` calls in source
    order, a per-stage name once per stage at the 64^2 shapes."""
    tree = ast.parse((SCRIPTS / script).read_text())
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "report"), key=lambda n: n.lineno)
    names = []
    for call in calls:
        name = template(call.args[0])
        if "{si}" in name:
            names += [name.format(si=si, hw=hw, c=c)
                      for si, (hw, c, _) in enumerate(bench_block.stage_shapes(IMG))]
        else:
            names.append(name)
    return names


@pytest.fixture
def one_call(monkeypatch):
    """``timeloop`` as one call of ``fn`` on the host clock."""
    def once(fn, n_iters, reps=3, device="cuda"):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(common, "timeloop", once)


def test_bench_block_lines(one_call, capsys, monkeypatch):
    """One line per stage, led as the JAX line is (``stage0 16x16x96:``),
    with both times, the speedup, the maxdiff and the stage total; on the
    CPU no peak share and no kernel launch. K1's plain twin (tanh GELU)
    stays within one bf16 step of the eager block (erf GELU). Without a
    card and without ``--device cpu`` the tool raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_block.main(ARGV[:-2])
    src = (SCRIPTS / "bench_block.py").read_text()
    line = next(template(n.args[0]) for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "print"
                and n.args and isinstance(n.args[0], ast.JoinedStr)
                and template(n.args[0]).startswith("stage{si}"))
    lead = line.split(":")[0]
    out = bench_block.main(ARGV)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("stage")]
    shapes = bench_block.stage_shapes(IMG)
    assert [ln.split(":")[0] for ln in lines] == [
        lead.format(si=si, hw=hw, c=c) for si, (hw, c, _) in enumerate(shapes)]
    for ln in lines:
        for key in (" k1 ", " eager ", " speedup ", " maxdiff ", "(|y|max ", "-> stage total "):
            assert key in ln, ln
        assert "mlp-mfu" not in ln
    for si, row in out.items():
        assert row["launches"] == {}
        assert row["maxdiff"] <= 2.0 ** -7 * max(1.0, row["scale"]), (si, row)


def test_profile_infer_rows(one_call, capsys):
    """The JAX script's rows in its order; the NMS row names its candidate
    count (every anchor at conf 0.05 for this input); the summary repeats
    the rows and adds the components' sum without NMS."""
    rows = profile_infer.main(ARGV)
    assert [r["name"] for r in rows] == jax_rows("profile_infer.py")
    na = sum((IMG // s) ** 2 for s in (8, 16, 32))
    nms = next(r for r in rows if r["name"] == "NMS postprocess")
    assert f"of {na} anchors per image pass conf 0.05" in nms["note"]
    assert all(r["ms"] > 0 and r["launches"] == {} for r in rows)
    assert rows[0]["device_ms"] is None
    out = capsys.readouterr().out
    assert "components without NMS" in out and "full model throughput" in out


def test_profile_train_rows(one_call, capsys):
    """The JAX script's rows in its order, ``default`` named ``ref``; each
    per-stage row times the four routes; the components' sum follows;
    ``--skip-full`` drops exactly the rows the JAX script guards with
    ``skip_full``, and the sum."""
    rows = profile_train.main(ARGV)
    assert "components (backbone .. Detect, loss, AdamW)" in capsys.readouterr().out
    want = [n.replace(" fwd+bwd default", " fwd+bwd ref") for n in jax_rows("profile_train.py")]
    assert [r["name"] for r in rows] == want
    stages = [r for r in rows if "routes" in r]
    assert len(stages) == 4
    assert all(set(r["routes"]) == set(profile_train.ROUTES) for r in stages)
    for route in profile_train.ROUTES:
        total = sum(r["routes"][route] * d
                    for r, (_, _, d) in zip(stages, bench_block.stage_shapes(IMG)))
        trunk = next(r for r in rows if r["name"] == "TRUNK fwd+bwd totals")
        shown = trunk["ms"] if route == "ref" else float(
            trunk["note"].split(f"{route}=")[1].split()[0])
        assert shown == pytest.approx(total, abs=0.01)

    tree = ast.parse((SCRIPTS / "profile_train.py").read_text())
    guard = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                 and ast.unparse(n.test) == "not args.skip_full")
    guarded = sum(1 for n in ast.walk(guard) if isinstance(n, ast.Call)
                  and getattr(n.func, "id", None) == "report")
    skipped = profile_train.main(ARGV + ["--skip-full"])
    assert [r["name"] for r in skipped] == want[guarded:]
    assert "components (" not in capsys.readouterr().out


def test_profile_infer_components_chain_to_the_model():
    """The component rows' functions, chained trunk -> C2f -> BiFPN -> heads
    -> decode on the model's own weights, give ``MultitaskModel``'s infer
    outputs bit for bit (fp32, a narrow model); the backbone row's function
    is the trunk and the C2f adapters chained."""
    cfg = ModelConfig(img_size=IMG, backbone_depths=(1, 1, 2, 1), backbone_dims=(16, 24, 32, 48),
                      bifpn_feature_size=64, proto_ch=8)
    model = build_model(cfg, seed=3, device="cpu")
    x = torch.rand(BATCH, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    fn = profile_infer.component_fns(model)
    with torch.no_grad():
        want = model(x, train=False, mode="infer")
        xb = profile_infer.nchw(x)
        p = fn["c2f"](*fn["trunk"](xb))
        for a, b in zip(p, fn["backbone"](xb)):
            assert torch.equal(a, b)
        feats = fn["neck"](*p)
        seg_raw, coeffs, protos = fn["segment"](*feats)
        det = fn["decode"](*[r.permute(0, 2, 3, 1) for r in fn["detect"](*feats)])
        seg = fn["decode"](*[r.permute(0, 2, 3, 1) for r in seg_raw])
    assert torch.equal(det, want["det_preds"])
    assert torch.equal(torch.cat([seg, coeffs.float()], -1), want["seg_preds"])
    assert torch.equal(protos.permute(0, 2, 3, 1), want["protos"])
