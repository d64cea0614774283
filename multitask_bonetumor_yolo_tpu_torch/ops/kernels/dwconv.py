"""Depthwise 7x7 convolution (kernel K3): the CUDA kernel's wrapper and its
plain version.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/pallas/dwconv.py::dwconv7``
(stride 1, SAME, fp32 taps and accumulation, fp32 output), in its layout:
``x`` NHWC ``[B, H, W, C]`` in bf16 or fp32, ``taps [7, 7, C]`` fp32, the
result ``[B, H, W, C]`` fp32. The kernel is ``csrc/dwconv.cu`` (its device
code, ``csrc/dwconv.cuh``, says what bounds it and how it is laid out). It
takes C a multiple of 16 (every C of the ConvNeXt block kernels, 16 ... 768,
and any wider one).

  * :func:`dwconv7` — on a CUDA tensor it launches the kernel or raises; on
    a CPU tensor it returns the plain version.
  * :func:`dwconv7_plain` — ``F.conv2d(groups=C)`` on the fp32 input.

The block's explicit backward (``convnext_block_bwd.py::
convnext_block_bwd_explicit``) runs it twice. Launch count:
``dwconv7.launches`` is a plain integer that the wrapper raises by one at
each launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def dwconv7_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(x.float(), taps -> [C,1,7,7], padding=3, groups=C)`` in NHWC.
    On the card a caller that wants full fp32 turns cuDNN's TF32 off
    (``torch.backends.cudnn.allow_tf32 = False``: convolutions default to
    TF32), as the tests and ``chip_smoke.py`` do."""
    c = x.shape[-1]
    w = taps.float().permute(2, 0, 1).reshape(c, 1, 7, 7)
    return F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=3, groups=c).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("dwconv")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dwconv7_forward.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.dwconv7_forward.restype = ci
    return lib


def check_args(x: torch.Tensor, taps: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"dwconv7: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"dwconv7: x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dwconv7: dtype {x.dtype} not in {KERNEL_DTYPES}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("dwconv7: x must be contiguous NHWC, 16-byte aligned")
    c = x.shape[-1]
    if c % 16:
        raise ValueError(f"dwconv7: C={c} must be a multiple of 16")
    if tuple(taps.shape) != (7, 7, c) or taps.device != x.device:
        raise ValueError(f"dwconv7: taps must be [7, 7, {c}] on {x.device}, "
                         f"got {tuple(taps.shape)} on {taps.device}")


def dwconv7(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7, stride 1, SAME, fp32 accumulation and output. CUDA
    tensor: one launch of K3 (raises on anything it does not take); CPU
    tensor: :func:`dwconv7_plain`."""
    if x.device.type == "cpu":
        return dwconv7_plain(x, taps)
    check_args(x, taps)
    b, h, w, c = x.shape
    t = taps  # [7, 7, C] = [49][C] fp32, contiguous and 16-byte aligned, else copied so
    if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
        t = torch.empty((7, 7, c), dtype=torch.float32, device=x.device).copy_(taps)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dwconv7_forward(x.data_ptr(), t.data_ptr(), None, out.data_ptr(),
                                 b, h, w, c, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"dwconv7 kernel launch failed: CUDA error {rc}")
    dwconv7.launches += 1
    return out


dwconv7.launches = 0
