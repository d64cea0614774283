"""Eval-mode BatchNorm + activation + cast in one pass (kernel K7): the CUDA
kernel's wrapper.

The chain after every conv of the neck, the heads and the backbone's C2f
adapters (``models/common.py::bn_act``, which also holds its eager form):
BN on the running statistics in fp32 on the conv's output, then ``act``
(:data:`ACTS`: SiLU, ELU with alpha 1, or none), then the cast back to the
input's dtype. Eagerly that is four launches (``x.float()``, the BN, the
activation, the cast); K7 (``csrc/bn_act.cu``) is one, which reads the
input once and writes the output once. K7 replaces no TPU kernel (XLA fuses
the chain into the conv there); ``csrc/bn_act.cu`` says what bounds it and
how it is laid out.

  * :func:`bn_act` — one launch of K7 on a CUDA tensor; it raises on
    anything K7 does not take, so a layout it cannot read is never served
    another way.
  * :func:`pixel_stride` — the layouts K7 reads in place: NCHW-logical
    tensors whose channels are adjacent in memory and whose pixels lie
    evenly apart (a ``channels_last`` map, or a channel slice of one), bf16
    or fp32, 16-byte aligned, with C and the pixel stride multiples of the
    16-byte vector (8 bf16 or 4 fp32 values).

The output is a new contiguous ``channels_last`` map of the input's shape
and dtype. Launch count: ``bn_act.launches`` is a plain integer that the
wrapper raises by one at each launch, and nowhere else.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ...utils.profiling import register_kernels
from .build import load_library

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
ACTS = {"none": 0, "silu": 1, "elu": 2}  # the library's act codes
MAX_VECTORS = 256  # 16-byte vectors per pixel: a block's threads (csrc/bn_act.cu)


def pixel_stride(x: torch.Tensor) -> int | None:
    """Elements between neighbouring pixels (in N, H, W order) of the
    NCHW-logical ``x`` when its channels are adjacent in memory and its
    pixels evenly apart, at least C; otherwise None. Size-1 dims may have
    any stride."""
    if x.dim() != 4:
        return None
    n, c, h, w = x.shape
    sn, sc, sh, sw = x.stride()
    if c > 1 and sc != 1:
        return None
    s = sw if w > 1 else sh if h > 1 else sn if n > 1 else c
    if s < c or (w > 1 and sw != s) or (h > 1 and sh != w * s) or (n > 1 and sn != h * w * s):
        return None
    return s


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("bn_act")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_act_forward.argtypes = [vp] * 6 + [ctypes.c_float, cll, ci, cll, ci, ci, vp]
    lib.bn_act_forward.restype = ci
    return lib


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, eps: float, act: str) -> torch.Tensor:
    """``act(batch_norm(x, mean, var, weight, bias, eps))`` in fp32, cast to
    ``x``'s dtype: one launch of K7 on the current stream of ``x``'s device.
    Raises on anything K7 does not take (device, dtype, layout, ``act``, the
    four fp32 ``[C]`` vectors)."""
    dev, dtype = x.device, x.dtype
    if dev.type != "cuda":
        raise ValueError(f"bn_act: unsupported device {dev}")
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"bn_act: dtype {dtype} not in {KERNEL_DTYPES}")
    if act not in ACTS:
        raise ValueError(f"bn_act: unknown act {act!r}, not one of {tuple(ACTS)}")
    stride, vec = pixel_stride(x), 16 // dtype.itemsize
    if stride is None or x.data_ptr() % 16 or x.shape[1] % vec or stride % vec \
            or x.shape[1] > MAX_VECTORS * vec:
        raise ValueError(
            f"bn_act: x {tuple(x.shape)} with strides {x.stride()} is not a channels-last map "
            f"(or a channel slice of one), 16-byte aligned, with C and the pixel stride multiples "
            f"of {vec} and at most {MAX_VECTORS * vec} channels")
    n, c, h, w = x.shape
    for name, t in (("mean", mean), ("var", var), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (c,) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"bn_act: {name} must be contiguous fp32 [{c}] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((n, c, h, w), dtype=dtype, device=dev, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    guard = torch.cuda.device(dev) if dev.index != torch.cuda.current_device() else _NO_GUARD
    with guard:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().bn_act_forward(
            x.data_ptr(), out.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), eps, n * h * w, c, stride, dtype == torch.bfloat16, ACTS[act],
            stream)
    if rc != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {rc}")
    bn_act.launches += 1
    return out


_NO_GUARD = contextlib.nullcontext()
bn_act.launches = 0
register_kernels({"K7": bn_act})
