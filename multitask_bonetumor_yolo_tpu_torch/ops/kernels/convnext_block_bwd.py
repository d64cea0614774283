"""ConvNeXt block backward (kernel K2): the CUDA kernels' wrapper and its
plain version.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block_bwd.py::
fused_block_bwd_v2`` (the one-kernel ``_kernel_v2``). From the block input
``x``, the dwconv output ``y`` that the residual-saving forward kept
(``convnext_block.convnext_block_saving``) and the cotangent ``g`` of the
output, all NHWC in the compute dtype, it returns the gradients in the
forward's argument order: ``dx`` in the compute dtype, then fp32 gradients of
the raw parameters in the port's layouts (``dw_kernel [C,1,7,7]``,
``dw_bias``, ``ln_scale``, ``ln_bias``, ``w1 [4C,C]``, ``b1``, ``w2 [C,4C]``,
``b2``, ``gamma``). The LN moments are recomputed from ``y``, the hidden
layer from the folded ``w1'`` with the tanh-GELU derivative; ``d_z`` goes
through the folded ``w1'`` and the raw-space ``d_z2`` through the raw ``w1``.

  * :func:`convnext_block_bwd` — on a CUDA tensor it launches the kernels of
    ``csrc/convnext_block_bwd.cu`` (whose header says what bounds them and
    how they are laid out) or raises; on a CPU tensor it returns the plain
    version.
  * :func:`convnext_block_bwd_plain` — the same math and the same casts to
    the compute dtype in plain PyTorch.

Launch count: ``convnext_block_bwd.launches`` is a plain integer that the
wrapper raises by one each time it launches the kernels, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library
from .convnext_block import check_block_args, fold_block_params, kernel_operands

_GELU_C = 0.7978845608028654


def convnext_block_bwd_plain(
    x, y, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """K2's math in plain PyTorch; operands of every product are cast to the
    compute dtype where the kernel casts them, sums are fp32."""
    dt = x.dtype
    _, h, w, c = x.shape
    _, _, w1f, b1f, w2f, _ = fold_block_params(
        dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma
    )

    def op(t):  # a product operand: rounded to the compute dtype, summed in fp32
        return t.to(dt).float()

    def total(t):
        return t.reshape(-1, t.shape[-1]).sum(0)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    yf, gf = y.float(), g.float()
    mean = yf.mean(-1, keepdim=True)
    var = ((yf * yf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    r = torch.rsqrt(var + eps)
    z = (yf - mean) * r
    h1 = op(z) @ op(w1f) + b1f
    th = torch.tanh(_GELU_C * (h1 + 0.044715 * h1 * h1 * h1))
    du = _GELU_C * (1.0 + 3.0 * 0.044715 * h1 * h1)
    d_h = (op(gf) @ op(w2f).t()) * (0.5 * (1.0 + th) + h1 * 0.5 * (1.0 - th * th) * du)
    dhd = op(d_h)
    d_z = dhd @ op(w1f).t()
    d_z2 = dhd @ op(w1)
    m1 = d_z.mean(-1, keepdim=True)
    m2 = (d_z * z).mean(-1, keepdim=True)
    d_y = r * (d_z - m1 - z * m2)
    a = op(h1 * 0.5 * (1.0 + th))
    o = a @ op(w2).t() + b2.float()
    do = op(gf * gamma.float())
    z2 = op(z * ln_scale.float() + ln_bias.float())

    xp = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
    ddw = torch.stack([(xp[:, i:i + h, j:j + w, :] * d_y).sum((0, 1, 2))
                       for i in range(7) for j in range(7)])  # [49, C]
    dx = F.conv2d(d_y.permute(0, 3, 1, 2), dw_kernel.float().flip(2, 3), padding=3,
                  groups=c).permute(0, 2, 3, 1)
    return (
        (dx + gf).to(dt),
        ddw.t().reshape(c, 1, 7, 7),
        total(d_y),
        total(d_z2 * z),
        total(d_z2),
        flat(dhd).t() @ flat(z2),
        total(d_h),
        flat(do).t() @ flat(a),
        total(do),
        total(gf * o),
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("convnext_block_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cnb_backward_workspace.argtypes = [ci] * 5
    lib.cnb_backward_workspace.restype = ctypes.c_longlong
    lib.cnb_backward.argtypes = [vp, vp] + [ci] * 4 + [ctypes.c_float, ci, vp]
    lib.cnb_backward.restype = ci
    return lib


def convnext_block_bwd(
    x, y, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6,
    ops: dict | None = None,
):
    """Block backward. CUDA tensors: one run of K2's kernels (raises on
    anything they do not take), with the operands ``ops`` that
    ``kernel_operands(..., backward=True)`` folded for the forward, or folded
    here when not given. CPU tensors: the plain version."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return convnext_block_bwd_plain(x, y, g, *params, eps=eps)
    check_block_args(x, params)
    for name, t in (("y", y), ("g", g)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"convnext_block_bwd: {name} must match x {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"convnext_block_bwd: {name} must be contiguous NHWC")
    dt = x.dtype
    b, h, w, c = x.shape
    if ops is None:
        ops = kernel_operands(params, dt, backward=True)

    def vec(t):
        return t.float().contiguous()

    ins = (x, y, g, *(ops[k] for k in ("taps", "w1f", "w2f_t", "w1f_t", "w1", "w2_t", "b1f")),
           vec(b2), vec(gamma), vec(ln_scale), vec(ln_bias))
    f32 = dict(dtype=torch.float32, device=x.device)
    outs = (torch.empty_like(x), torch.empty(49, c, **f32), torch.empty(c, **f32),
            torch.empty(c, **f32), torch.empty(c, **f32), torch.empty(4 * c, c, **f32),
            torch.empty(4 * c, **f32), torch.empty(c, 4 * c, **f32), torch.empty(c, **f32),
            torch.empty(c, **f32))
    lib = _library()
    is_bf16 = int(dt == torch.bfloat16)
    ws = torch.empty(lib.cnb_backward_workspace(b, h, w, c, is_bf16), dtype=torch.uint8,
                     device=x.device)
    ptrs = (ctypes.c_void_p * len(ins + outs))(*[t.data_ptr() for t in ins + outs])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cnb_backward(ptrs, ws.data_ptr(), b, h, w, c, float(eps), is_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"convnext_block_bwd kernel launch failed: CUDA error {rc}")
    convnext_block_bwd.launches += 1
    dx, ddw, *rest = outs
    return (dx, ddw.t().reshape(c, 1, 7, 7), *rest)


convnext_block_bwd.launches = 0
