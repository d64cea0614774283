"""Where the time of K1's Hopper design goes: the kernel with parts cut out,
timed on the card.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.k1_knockout [--iters 30]

Builds edited copies of the Hopper design's source
(``csrc/convnext_block_h.cuh``, compiled through a copy of
``csrc/convnext_block.cu`` beside it), one library per variant and all at
once, into ``build/kernels/knockout/``, and times each variant's bf16
inference launch alone (operands folded once, CUDA events, two turns
in turn with the others) at the batch-16 640^2 stage shapes C = 96 / 192 /
384. A variant computes wrong outputs on purpose: nothing checks them, and
no path of the port loads these libraries.

  * ``full`` — the source as it is;
  * ``no_loop`` — phase 1 (halo, taps, LN), the first chunk's products and
    the epilogue: the chunk loop cut out;
  * ``no_weight_loads`` — the weight copies read nothing (cp.async's
    zero-fill: every tile is zeros): the chunk loop without its stream of
    weights from L2;
  * ``other_tile`` — 128 pixels per CTA at C = 96 and 64 at C = 192, the
    route's choice the other way round.

Prints one line per stage, ``C=..: variant ms, ...`` (two turns), and the
card's name and power limit. Raises without a card. (ptxas crashes,
signal 11, on copies without the chunk loop's wgmma or with a rotated
chunk order, so those two cuts are not offered.)
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops.kernels import build
from ..ops.kernels import convnext_block as cnb

SOURCE = build.CSRC / "convnext_block_h.cuh"  # K1's Hopper device code
STAGES = ((96, 160), (192, 80), (384, 40))  # C, H = W at 640^2
BATCH = 16

# each variant's edits of the source: (text, replacement), every text found once
EDITS = {
    "full": (),
    "no_loop": (
        ("  for (int k = 0; k + 1 < nchunk; ++k) {",
         "  for (int k = 0; k + 1 < (C < 0 ? nchunk : 1); ++k) {"),
    ),
    "no_weight_loads": (
        ("    const bool in = ch * 8 < C;\n    cp_async16_zfill(dst + sm90::swz(NC, n, ch * 8)",
         "    const bool in = false;\n    cp_async16_zfill(dst + sm90::swz(NC, n, ch * 8)"),
        ("    const bool in = c < C;\n    cp_async16_zfill(dst + sm90::swz(L::CP, c, k0 + ch * 8)",
         "    const bool in = false;\n    cp_async16_zfill(dst + sm90::swz(L::CP, c, k0 + ch * 8)"),
    ),
    "other_tile": (
        ("  if (C <= 96) return K1H_LAUNCH(96, 64, 64);",
         "  if (C <= 96) return K1H_LAUNCH(96, 64, 128);"),
        ("  if (C <= 192) return K1H_LAUNCH(192, 64, 128);",
         "  if (C <= 192) return K1H_LAUNCH(192, 64, 64);"),
    ),
}


def edited_source(name: str, text: str) -> str:
    """The source ``text`` with variant ``name``'s edits; raises when one of
    them does not find its text exactly once."""
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise ValueError(f"k1_knockout {name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_variant(name: str, out_dir: Path) -> Path:
    # the edited header beside a copy of K1's source, which includes it from
    # its own directory first
    var_dir = out_dir / name
    var_dir.mkdir(exist_ok=True)
    (var_dir / SOURCE.name).write_text(edited_source(name, SOURCE.read_text()))
    src = var_dir / "convnext_block.cu"
    src.write_text((build.CSRC / "convnext_block.cu").read_text())
    lib = var_dir / f"k1_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{proc.stderr[-3000:]}")
    return lib


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--variants", default=",".join(EDITS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("k1_knockout needs an NVIDIA GPU")
    out_dir = build.BUILD_DIR / "knockout"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(lambda n: build_variant(n, out_dir), names)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).cnb_forward
        fn.argtypes = [vp] * 9 + [ci] * 4 + [ctypes.c_float, ci, vp]
        fn.restype = ci
        fns[name] = fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[k1-knockout] {card}; kernel alone, ms per launch, two turns", flush=True)
    times = {}
    for c, s in STAGES:
        x = torch.randn(BATCH, s, s, c, generator=gen, device=dev).to(torch.bfloat16)
        params = [torch.randn(*shape, generator=gen, device=dev) * 0.1 for shape in (
            (c, 1, 7, 7), (c,), (c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,), (c,))]
        params[2] += 1.0
        ops = cnb.kernel_operands(params, torch.bfloat16, hopper=True)
        ptrs = [ops[k].data_ptr() for k in ("taps", "dw_bias", "w1f_t", "b1f", "w2f_t", "b2f")]
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {name: [] for name in names}
        for _ in range(2):
            for name, fn in fns.items():
                def launch(fn=fn, name=name):
                    rc = fn(x.data_ptr(), out.data_ptr(), None, *ptrs, BATCH, s, s, c, 1e-6, 1,
                            stream)
                    if rc != 0:
                        raise RuntimeError(f"k1_knockout {name}: CUDA error {rc}")
                row[name].append(cuda_ms(launch, args.iters))
        times[c] = row
        print(f"[k1-knockout] C={c} ({BATCH},{s},{s}): " + ", ".join(
            f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in row.items()), flush=True)
    return times


if __name__ == "__main__":
    main()
