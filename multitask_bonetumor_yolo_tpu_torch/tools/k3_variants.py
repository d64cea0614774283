"""K3's Hopper design beside its variants and parts cut out, timed on the
card: why it takes 5 pixels per thread, and which part holds it.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.k3_variants [--iters 20]

Builds edited copies of the Hopper design's source (``csrc/dwconv.cuh``,
compiled through a copy of ``csrc/dwconv.cu`` beside it), one library per
variant and all at once, into ``build/kernels/k3_variants/``, and gives each
variant's bf16 launch its device time (``torch.profiler``, mean per launch)
at the batch-8 640^2 stage shapes, beside the first design
(``dwconv7_v0``) and ``x.float()``, a copy that moves the same bytes (2 in,
4 out per value): the memory system's own pace for them on this card.

  * ``hopper`` — the source as it is;
  * ``px8`` — 8 pixels per thread instead of 5 (fewer loads per output,
    more registers, fewer CTAs per SM);
  * ``no_loads`` — the x values are constants instead of shared-memory
    loads (the TMA ring still runs);
  * ``no_stores`` — the output rows are staged but never stored;
  * ``no_fmas`` — each accumulator takes the last x value instead of 49 FMAs.

``hopper`` and ``px8`` must equal the first design bit for bit; the cut
variants compute wrong outputs on purpose and nothing checks them. No path
of the port loads these libraries. Prints one line per stage and the card's
name and power limit; raises without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops.kernels import build
from ..ops.kernels import dwconv as k3

SOURCE = build.CSRC / "dwconv.cuh"  # K3's Hopper device code
STAGES = ((96, 160), (192, 80), (384, 40), (768, 20))  # C, H = W at 640^2
BATCH = 8

# each variant's edits of the source: (text, replacement), every text found once
EDITS = {
    "hopper": (),
    "px8": (("constexpr int PX = 5;", "constexpr int PX = 8;"),),
    "no_loads": (("x[j] = to_f(next[j]);", "x[j] = __int_as_float(0x3f800000 + j + r);"),),
    "no_stores": (("if (o.lane == 0) tma_store_4d(o.map, sb, o.c0, o.w, o.h0 + m, o.b);", ""),),
    "no_fmas": (("a[p] = fmaf(x[p + j], tap[i * 7 + j], i == 0 && j == 0 ? 0.f : a[p]);",
                 "a[p] = x[p + j];"),),
}
EXACT = ("hopper", "px8")  # the variants that compute K3's function


def edited_source(name: str, text: str) -> str:
    """The source ``text`` with variant ``name``'s edits; raises when one of
    them does not find its text exactly once."""
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise ValueError(f"k3_variants {name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_variant(name: str, out_dir: Path) -> tuple[Path, str]:
    # the edited header beside a copy of K3's source, which includes it from
    # its own directory first
    var_dir = out_dir / name
    var_dir.mkdir(exist_ok=True)
    (var_dir / SOURCE.name).write_text(edited_source(name, SOURCE.read_text()))
    src = var_dir / "dwconv.cu"
    src.write_text((build.CSRC / "dwconv.cu").read_text())
    lib = var_dir / f"k3_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{proc.stderr[-3000:]}")
    regs = [ln.split("Used ")[1].split()[0] for ln in (proc.stdout + proc.stderr).splitlines()
            if "Used " in ln and "registers" in ln]
    return lib, "/".join(regs)


def device_ms(fn, key: str, iters: int) -> float:
    """Mean device time per launch of the kernels whose name holds ``key``
    (every kernel for the empty key), ``torch.profiler`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name]
    if not times:
        raise RuntimeError(f"k3_variants: the profiler recorded no launch of {key or 'the call'}")
    return sum(times) / len(times) / 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default=",".join(EDITS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("k3_variants needs an NVIDIA GPU")
    out_dir = build.BUILD_DIR / "k3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(lambda n: build_variant(n, out_dir), names)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, (path, regs) in built.items():
        fn = ctypes.CDLL(str(path)).dwconv7_forward
        fn.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        fn.restype = ci
        fns[name] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[k3-variants] {card}; registers (bf16/fp32 kernels, ptxas): " + ", ".join(
        f"{n} {r}" for n, (_, r) in built.items()), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for c, s in STAGES:
        shape = (BATCH, s, s, c)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        taps = torch.randn(7, 7, c, generator=gen, device=dev) * 0.1
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        want = k3.dwconv7_v0(x, taps)
        row = {"first design": device_ms(lambda: k3.dwconv7_v0(x, taps), "cnb_dwconv7_v0",
                                         args.iters)}
        for name, fn in fns.items():
            def launch(fn=fn, name=name):
                rc = fn(x.data_ptr(), taps.data_ptr(), None, out.data_ptr(), *shape, 1, stream)
                if rc != 0:
                    raise RuntimeError(f"k3_variants {name}: CUDA error {rc}")
            launch()
            if name in EXACT and not torch.equal(out, want):
                raise RuntimeError(f"k3_variants {name} {shape}: differs from the first design")
            row[name] = device_ms(launch, "cnb_dwconv7", args.iters)
        row["x.float()"] = device_ms(lambda: x.float(), "", args.iters)
        times[shape] = row
        print(f"[k3-variants] {shape} device ms per launch: " + ", ".join(
            f"{n} {t:.4f}" for n, t in row.items()), flush=True)
    return times


if __name__ == "__main__":
    main()
