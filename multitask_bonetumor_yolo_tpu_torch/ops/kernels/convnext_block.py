"""Fused ConvNeXt block: the CUDA kernel's wrapper and its plain versions.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py``.
The kernel (``csrc/convnext_block.cu``; its header says what bounds it and
how it is laid out) computes

    out = x + fc2'(gelu_tanh(fc1'(LN(dwconv7x7(x) + b_dw))))

with LN scale/bias folded into fc1 and layer-scale gamma into fc2
(:func:`fold_block_params`). The functions here:

  * :func:`convnext_block` — the wrapper: on a CUDA tensor it launches the
    kernel or raises; on a CPU tensor it returns the plain twin. When
    autograd records the block (grad enabled and an input requires grad) it
    runs the residual-saving form instead, under an autograd Function whose
    backward is kernel K2 (``convnext_block_bwd.py``) for ``bwd="fused"``
    or the vjp of the eager reference for ``bwd="ref"``, as the JAX
    ``_bwd_padded`` does.
  * :func:`convnext_block_saving` — the residual-saving form (JAX
    ``save_res=True``): ``(out, y)`` with ``y = dwconv7x7(x) + b_dw`` in the
    compute dtype, the input of the backward.
  * :func:`convnext_block_plain` / :func:`convnext_block_plain_saving` — the
    kernel's plain twins: the same math (tanh-GELU, folds, fp32 dwconv/LN,
    casts where the kernel casts) in PyTorch. Tests and ``chip_smoke.py``
    hold the kernel against them.
  * :func:`convnext_block_ref` — the eager block with exact (erf) GELU, the
    counterpart of JAX's ``convnext_block_ref``; the model's ``pallas="off"``
    path and its CPU path.

Public layout: ``x`` is NHWC ``[B, H, W, C]`` (for the kernel: contiguous, the
``permute(0, 2, 3, 1)`` view of a ``channels_last`` tensor). Parameters are
in the port's torch layouts: ``dw_kernel [C, 1, 7, 7]``, ``w1 [4C, C]`` and
``w2 [C, 4C]`` (``nn.Linear``), vectors ``[C]`` / ``[4C]``.

Launch counts: ``convnext_block.launches`` (the inference form) and
``convnext_block_saving.launches`` (the residual-saving form) are plain
integers that the wrappers raise by one at each kernel launch, and nowhere
else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 768


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU, as the kernel (and the JAX Pallas kernel) computes it."""
    return x * 0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def fold_block_params(dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
    """Kernel-ready fp32 parameters: taps ``[49, C]``, dw bias, and
    ``w1' [C, 4C] = ln_scale * w1``, ``b1' = b1 + ln_bias @ w1``,
    ``w2' [4C, C] = w2 * gamma``, ``b2' = b2 * gamma``."""
    c = dw_kernel.shape[0]
    w1_t = w1.float().t()  # [C, 4C]
    w2_t = w2.float().t()  # [4C, C]
    g = gamma.float()
    return (
        dw_kernel.float().reshape(c, 49).t().contiguous(),
        dw_bias.float().contiguous(),
        (ln_scale.float()[:, None] * w1_t).contiguous(),
        (b1.float() + ln_bias.float() @ w1_t).contiguous(),
        (w2_t * g[None, :]).contiguous(),
        (b2.float() * g).contiguous(),
    )


def convnext_block_ref(
    x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """Eager ConvNeXt block (dwconv -> fp32 LN -> Linear 4C -> exact GELU ->
    Linear C -> gamma -> residual), NHWC in and out, compute dtype of ``x``."""
    dt = x.dtype
    c = x.shape[-1]
    y = F.conv2d(
        x.permute(0, 3, 1, 2), dw_kernel.to(dt), dw_bias.to(dt), padding=3, groups=c
    ).permute(0, 2, 3, 1)
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = ((yf - mean) ** 2).mean(-1, keepdim=True)
    yf = (yf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    h = F.linear(yf.to(dt), w1.to(dt)).float() + b1.float()
    h = F.gelu(h)
    o = F.linear(h.to(dt), w2.to(dt)).float() + b2.float()
    return x + (o * gamma.float()).to(dt)


def convnext_block_plain_saving(
    x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """The kernel's math in plain PyTorch, residual-saving form: ``(out, y)``.
    fp32 taps and accumulation in the dwconv, ``y`` its output plus bias cast
    to the compute dtype; fp32 LN moments as E[y^2] - mean^2 clamped at 0;
    the normalised tensor and the post-GELU hidden layer cast to the compute
    dtype, products of compute-dtype operands summed in fp32, residual added
    in fp32."""
    dt = x.dtype
    c = x.shape[-1]
    _, _, w1f, b1f, w2f, b2f = fold_block_params(
        dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma
    )
    y = F.conv2d(
        x.permute(0, 3, 1, 2).float(), dw_kernel.float(), dw_bias.float(),
        padding=3, groups=c,
    ).permute(0, 2, 3, 1)
    mean = y.mean(-1, keepdim=True)
    var = ((y * y).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    r = torch.rsqrt(var + eps)
    z = (y * r - mean * r).to(dt)
    h = z.float() @ w1f.to(dt).float() + b1f
    h = gelu_tanh(h).to(dt)
    o = h.float() @ w2f.to(dt).float() + b2f
    return (x.float() + o).to(dt), y.to(dt)


def convnext_block_plain(
    x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """The inference kernel's plain twin: :func:`convnext_block_plain_saving`
    without ``y``."""
    return convnext_block_plain_saving(
        x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps
    )[0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("convnext_block")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cnb_forward.argtypes = [vp] * 9 + [ci] * 4 + [ctypes.c_float, ci, vp]
    lib.cnb_forward.restype = ci
    return lib


def check_block_args(x, params):
    """Raise on anything the block kernels (K1, K2) do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"convnext_block: x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"convnext_block: dtype {x.dtype} not in {KERNEL_DTYPES}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("convnext_block: x must be contiguous NHWC, 16-byte aligned")
    c = x.shape[-1]
    if c % 16 or c > MAX_CHANNELS:
        raise ValueError(f"convnext_block: C={c} must be a multiple of 16 and <= {MAX_CHANNELS}")
    want = {
        "dw_kernel": (c, 1, 7, 7), "dw_bias": (c,), "ln_scale": (c,), "ln_bias": (c,),
        "w1": (4 * c, c), "b1": (4 * c,), "w2": (c, 4 * c), "b2": (c,), "gamma": (c,),
    }
    for (name, shape), p in zip(want.items(), params):
        if tuple(p.shape) != shape:
            raise ValueError(f"convnext_block: {name} shape {tuple(p.shape)} != {shape}")
        if p.device != x.device:
            raise ValueError(f"convnext_block: {name} on {p.device}, x on {x.device}")


def _dt_copy(t, dt):
    """A contiguous ``dt`` copy of ``t`` (a cast and a transpose in one launch)."""
    return torch.empty(t.shape, dtype=dt, device=t.device).copy_(t)


def kernel_operands(params, dt, backward: bool = False) -> dict:
    """The block's parameters as the kernels take them, folded once:
    K1's ``taps``, ``dw_bias``, ``w1f`` = dt(w1') [C,4C], ``b1f``, ``w2f`` =
    dt(w2') [4C,C], ``b2f``; with ``backward`` also K2's ``w2f_t`` [C,4C],
    ``w1f_t`` [4C,C] and the raw-space ``w1`` [4C,C] and ``w2_t`` [4C,C] in
    ``dt``. The autograd Function folds once per block and hands the same
    operands to K1's saving launch and to K2."""
    dw, dwb, w1f, b1f, w2f, b2f = fold_block_params(*params)
    ops = dict(taps=dw, dw_bias=dwb, w1f=w1f.to(dt), b1f=b1f, w2f=w2f.to(dt), b2f=b2f)
    if backward:
        w1, w2 = params[4], params[6]
        ops.update(w2f_t=_dt_copy(ops["w2f"].t(), dt), w1f_t=_dt_copy(ops["w1f"].t(), dt),
                   w1=w1.to(dt).contiguous(), w2_t=_dt_copy(w2.t(), dt))
    return ops


def _launch(x, params, eps, saving, ops=None):
    check_block_args(x, params)
    dt = x.dtype
    if ops is None:
        ops = kernel_operands(params, dt)
    dw, dwb, w1f, b1f, w2f, b2f = (ops[k] for k in ("taps", "dw_bias", "w1f", "b1f", "w2f", "b2f"))
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    y = torch.empty_like(x) if saving else None
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cnb_forward(
            x.data_ptr(), out.data_ptr(), None if y is None else y.data_ptr(),
            dw.data_ptr(), dwb.data_ptr(), w1f.data_ptr(), b1f.data_ptr(),
            w2f.data_ptr(), b2f.data_ptr(),
            b, h, w, c, float(eps), int(dt == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"convnext_block kernel launch failed: CUDA error {rc}")
    return out, y


def convnext_block_saving(
    x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6,
    ops: dict | None = None,
):
    """Residual-saving block forward: ``(out, y)``. CUDA tensor: one launch
    of the kernel's saving form (with the folded ``ops`` of
    :func:`kernel_operands`, when given); CPU tensor: the plain twin."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return convnext_block_plain_saving(x, *params, eps=eps)
    out, y = _launch(x, params, eps, saving=True, ops=ops)
    convnext_block_saving.launches += 1
    return out, y


convnext_block_saving.launches = 0


class _Block(torch.autograd.Function):
    """The block under autograd: forward K1 (saving form for ``"fused"``),
    backward K2 (``"fused"``) or the vjp of the eager reference (``"ref"``).
    Inputs and outputs NHWC; the cotangent is made contiguous."""

    @staticmethod
    def forward(ctx, x, eps, bwd, *params):
        ctx.eps, ctx.bwd, ctx.ops = eps, bwd, None
        if bwd == "fused":
            if x.device.type != "cpu":  # one fold for K1's saving launch and K2
                ctx.ops = kernel_operands(params, x.dtype, backward=True)
            out, y = convnext_block_saving(x, *params, eps=eps, ops=ctx.ops)
            ctx.save_for_backward(x, y, *params)
        else:
            out = _forward(x, params, eps)
            ctx.save_for_backward(x, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.bwd == "fused":
            from .convnext_block_bwd import convnext_block_bwd  # imports this module

            x, y, *params = ctx.saved_tensors
            dx, *dparams = convnext_block_bwd(x, y, g, *params, eps=ctx.eps, ops=ctx.ops)
            ctx.ops = None
        else:
            x, *params = ctx.saved_tensors
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (x, *params)]
                out = convnext_block_ref(*leaves, eps=ctx.eps)
                dx, *dparams = torch.autograd.grad(out, leaves, g)
        return (dx, None, None, *dparams)


def _forward(x, params, eps):
    """Inference form: the plain twin on a CPU tensor, one launch on CUDA."""
    if x.device.type == "cpu":
        return convnext_block_plain(x, *params, eps=eps)
    out, _ = _launch(x, params, eps, saving=False)
    convnext_block.launches += 1
    return out


def convnext_block(
    x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
    eps: float = 1e-6, bwd: str = "fused",
):
    """Fused ConvNeXt block on NHWC ``x``. CUDA tensor: the hand-written
    kernel (raises on anything it does not take). CPU tensor: the plain twin.
    Recorded by autograd, the residual-saving form with the backward ``bwd``
    ("fused": K2; "ref": the vjp of the eager reference)."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if bwd not in ("fused", "ref"):
        raise ValueError(f"unknown block backward {bwd!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _Block.apply(x, eps, bwd, *params)
    return _forward(x, params, eps)


convnext_block.launches = 0
