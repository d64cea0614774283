"""Build the CUDA sources under ``csrc/`` at first use and load them.

One library per ``csrc/<name>.cu``: ``convnext_block`` (K1), ``convnext_block_bwd``
(K2, K4), ``dwconv`` (K3), ``jpeg`` (K6 and its host entropy decoder),
``bn_act`` (K7), ``kernel_lab`` and ``kernel_lab_v0`` (K5). Each has a plain
C interface. It is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

(the kernel labs add ``--split-compile=0``, :data:`EXTRA_FLAGS`) into
``build/kernels/`` at the checkout's root (an installed package, which
has no checkout, uses ``$XDG_CACHE_HOME`` or ``~/.cache`` instead), named by
a hash of the source and the flags (so an edited source rebuilds), and
loaded with ``ctypes``.
Nothing is downloaded. Importing this module needs no ``nvcc``; only the first
call of :func:`load_library` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ...utils.profiling import count, span

CSRC = Path(__file__).resolve().parents[2] / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file():  # the package sits in its source tree
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "multitask_bonetumor_yolo_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per source: the kernel labs' ~90 instantiations each are optimised on all
# the host's cores (nvcc --split-compile), which cut the first lab's build
# beside the other three from 48-71 s to 34 s on the H100 machine (8 cores);
# the other sources keep the flags their kernels were measured with
EXTRA_FLAGS = {"kernel_lab": ("--split-compile=0",), "kernel_lab_v0": ("--split-compile=0",)}


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing. Returns
    the library's path and nvcc's report (empty when the cached library was
    used)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *nvcc_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        with span("kernels.build"):
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        count("kernels.built")
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


# the libraries the entry points' paths load (the kernel labs are tools')
PATH_LIBRARIES = ("convnext_block", "convnext_block_bwd", "dwconv", "jpeg", "bn_act")


def build_all() -> None:
    """Build the missing :data:`PATH_LIBRARIES` at once, one nvcc each. On N
    ranks, rank 0 calls this before the others load a library
    (``parallel/dist.py``), so that one process compiles each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(PATH_LIBRARIES)) as ex:
        list(ex.map(build, PATH_LIBRARIES))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    path, _ = build(name)
    with span("kernels.load"):
        lib = ctypes.CDLL(str(path))
    count("kernels.loaded")
    return lib
