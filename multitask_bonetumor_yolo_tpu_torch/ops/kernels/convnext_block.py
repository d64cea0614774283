"""Fused ConvNeXt block: the CUDA kernel's wrapper and its plain versions.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py``.
The kernel K1 (``csrc/convnext_block.cu``; its header says what bounds it and
how its two designs are laid out) computes

    out = x + fc2'(gelu_tanh(fc1'(LN(dwconv7x7(x) + b_dw))))

with LN scale/bias folded into fc1 and layer-scale gamma into fc2
(:func:`kernel_operands`). Its route (:func:`forward_route`, the library's
rule) sends bf16 up to C = 512 to its Hopper design (the products on wgmma)
and fp32 and C = 768 to its first design (wmma); the two take the folded
weights in different layouts. The functions here:

  * :func:`convnext_block` — the wrapper: on a CUDA tensor it launches the
    kernel or raises; on a CPU tensor it returns the plain twin. When
    autograd records the block (grad enabled and an input requires grad) it
    runs an autograd Function whose backward is picked by ``bwd``, as the
    JAX ``_bwd_padded`` picks it: ``"fused"``, the residual-saving form with
    kernel K2 (``convnext_block_bwd.py``) as its backward; ``"ref"``, the
    inference form with the vjp of the eager reference; ``"fused_v1"``, the
    inference form with kernel K4, the recompute-form backward (JAX
    ``CNB_FUSED_BWD=1``); ``"explicit"``, the inference form with the
    explicit backward, whose two depthwise convolutions are kernel K3 (JAX
    ``CNB_EXPLICIT_BWD=1``). The port reads no environment variable.
  * :func:`convnext_block_saving` — the residual-saving form (JAX
    ``save_res=True``): ``(out, y)`` with ``y = dwconv7x7(x) + b_dw`` in the
    compute dtype, the input of the backward.
  * :func:`convnext_block_v0` — K1's first design whatever the route, both
    forms: the Hopper design's "before" and the kernel lab's ``full``. No
    model path, option or variable reaches it.
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

Launch counts: ``convnext_block.launches`` (the inference form),
``convnext_block_saving.launches`` (the residual-saving form) and
``convnext_block_v0.launches`` (the first-design entry) are plain integers
that the wrappers raise by one at each kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ...utils.profiling import register_kernels
from .build import load_library

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 768
# the widest C of K1's Hopper design and of K2's Hopper pipeline in bf16
# (``k1h::HMAXC``, ``k2h::HMAXC``): the libraries' routes (:func:`forward_route`,
# ``convnext_block_bwd.hopper_route``) hold the rule, ``chip_smoke.py`` holds
# this number against both, and the model's block route reads it
HOPPER_MAX_CHANNELS = 512


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU, as the kernel (and the JAX Pallas kernel) computes it."""
    return x * 0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def fold_block_vectors(dw_kernel, dw_bias, ln_bias, w1, b1, b2, gamma):
    """The folded fp32 vectors: taps ``[49, C]``, dw bias, ``b1' = b1 +
    ln_bias @ w1^T`` and ``b2' = b2 * gamma``."""
    c = dw_kernel.shape[0]
    return (
        dw_kernel.float().reshape(c, 49).t().contiguous(),
        dw_bias.float().contiguous(),
        (b1.float() + ln_bias.float() @ w1.float().t()).contiguous(),
        (b2.float() * gamma.float()).contiguous(),
    )


def fold_block_weights_t(ln_scale, w1, w2, gamma):
    """The folded fp32 weights in the torch layouts (K-major for both
    products, no transpose): ``w1'^T [4C, C] = w1 * ln_scale`` and ``w2'^T
    [C, 4C] = gamma * w2``."""
    return (w1.float() * ln_scale.float()[None, :]).contiguous(), (
        gamma.float()[:, None] * w2.float()).contiguous()


def fold_block_params(dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
    """Kernel-ready fp32 parameters: taps ``[49, C]``, dw bias, and
    ``w1' [C, 4C] = ln_scale * w1``, ``b1' = b1 + ln_bias @ w1``,
    ``w2' [4C, C] = w2 * gamma``, ``b2' = b2 * gamma`` (the transposes of
    :func:`fold_block_weights_t`, the same products)."""
    taps, dwb, b1f, b2f = fold_block_vectors(dw_kernel, dw_bias, ln_bias, w1, b1, b2, gamma)
    w1f_t, w2f_t = fold_block_weights_t(ln_scale, w1, w2, gamma)
    return taps, dwb, w1f_t.t().contiguous(), b1f, w2f_t.t().contiguous(), b2f


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
    for fn in (lib.cnb_forward, lib.cnb_forward_v0):
        fn.argtypes = [vp] * 9 + [ci] * 4 + [ctypes.c_float, ci, vp]
        fn.restype = ci
    lib.cnb_forward_route.argtypes = [ci, ci]
    lib.cnb_forward_route.restype = ci
    lib.cnb_forward_hopper_tile.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.cnb_forward_hopper_tile.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def forward_route(dt, c: int) -> bool:
    """Whether K1's CUDA calls in compute dtype ``dt`` at width ``c`` run its
    Hopper design (bf16 up to C = 512) rather than its first design: the
    library's own rule (``cnb_forward_route``), which also picks the weight
    layouts that :func:`kernel_operands` hands the kernel."""
    return bool(_library().cnb_forward_route(c, int(dt == torch.bfloat16)))


def hopper_tile(c: int, saving: bool = False) -> dict:
    """K1's Hopper design at width ``c`` (bf16, ``c`` <= 512) on the current
    card: its tile, CTAs per SM, shared memory per CTA and hidden chunk."""
    info = (ctypes.c_int * 6)()
    rc = _library().cnb_forward_hopper_tile(c, int(saving), info)
    if rc != 0:
        raise RuntimeError(f"cnb_forward_hopper_tile({c}) failed: CUDA error {rc}")
    keys = ("tm", "th", "tw", "ctas_per_sm", "smem_bytes", "hidden_chunk")
    return dict(zip(keys, info))


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


def dt_copy(t, dt):
    """A contiguous ``dt`` copy of ``t`` (a cast and a transpose in one launch)."""
    return torch.empty(t.shape, dtype=dt, device=t.device).copy_(t)


# K1's weight operands by design (the forward route), K2's by pipeline
# (convnext_block_bwd.hopper_route), all in the compute dtype
FWD_OPERANDS = {True: ("w1f_t", "w2f_t"), False: ("w1f", "w2f")}
BWD_OPERANDS = {True: ("w1f_t", "w2f", "w1_t"),
                False: ("w1f", "w2f_t", "w1f_t", "w1", "w2_t")}


def kernel_operands(params, dt, backward: bool = False, hopper: bool | None = None) -> dict:
    """The block's parameters as the kernels take them, folded once: the fp32
    ``taps`` [49,C], ``dw_bias``, ``b1f`` and ``b2f``, and in ``dt`` the
    weights that the routes name. K1 (:data:`FWD_OPERANDS`): on its Hopper
    design (``hopper``; None asks :func:`forward_route`, the library's rule)
    ``w1f_t`` = dt(w1')^T [4C,C] and ``w2f_t`` = dt(w2')^T [C,4C], folded in
    the torch layouts; on its first design ``w1f`` = dt(w1') [C,4C] and
    ``w2f`` = dt(w2') [4C,C]. With ``backward``, also K2's
    (:data:`BWD_OPERANDS`, by ``convnext_block_bwd.hopper_route``): on its
    Hopper pipeline ``w1f_t``, ``w2f`` and the raw-space ``w1_t`` = dt(w1)^T
    [C,4C]; on its first design ``w1f``, ``w2f_t``, ``w1f_t`` and the raw
    ``w1`` [4C,C] and ``w2_t`` [4C,C]. The autograd Function folds once per
    block and hands the same operands to K1's saving launch and to K2."""
    dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma = params
    c = w1.shape[1]
    if hopper is None:
        hopper = forward_route(dt, c)
    need = set(FWD_OPERANDS[hopper])
    if backward:
        from . import convnext_block_bwd as bwds  # imports this module

        need |= set(BWD_OPERANDS[bwds.hopper_route(dt, c)])
    taps, dwb, b1f, b2f = fold_block_vectors(dw_kernel, dw_bias, ln_bias, w1, b1, b2, gamma)
    w1f_t, w2f_t = fold_block_weights_t(ln_scale, w1, w2, gamma)
    make = {
        "w1f_t": lambda: w1f_t.to(dt), "w2f_t": lambda: w2f_t.to(dt),
        "w1f": lambda: dt_copy(w1f_t.t(), dt), "w2f": lambda: dt_copy(w2f_t.t(), dt),
        "w1_t": lambda: dt_copy(w1.t(), dt), "w1": lambda: w1.to(dt).contiguous(),
        "w2_t": lambda: dt_copy(w2.t(), dt),
    }
    return dict(taps=taps, dw_bias=dwb, b1f=b1f, b2f=b2f, **{k: make[k]() for k in sorted(need)})


def _launch(x, params, eps, saving, ops=None, first_design=False):
    """One launch of K1 (``first_design``: of its first design, through
    ``cnb_forward_v0``, whatever the route); ``ops`` as
    :func:`kernel_operands` folds them for this launch's design."""
    check_block_args(x, params)
    dt = x.dtype
    b, h, w, c = x.shape
    hopper = not first_design and forward_route(dt, c)
    if ops is None:
        ops = kernel_operands(params, dt, hopper=hopper)
    dw, dwb, w1k, b1f, w2k, b2f = (ops[k] for k in (
        "taps", "dw_bias", FWD_OPERANDS[hopper][0], "b1f", FWD_OPERANDS[hopper][1], "b2f"))
    out = torch.empty_like(x)
    y = torch.empty_like(x) if saving else None
    lib = _library()
    fn = lib.cnb_forward_v0 if first_design else lib.cnb_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), out.data_ptr(), None if y is None else y.data_ptr(),
            dw.data_ptr(), dwb.data_ptr(), w1k.data_ptr(), b1f.data_ptr(),
            w2k.data_ptr(), b2f.data_ptr(),
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


def convnext_block_v0(
    x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6,
    saving: bool = False,
):
    """K1's first design whatever the route (``cnb_forward_v0``): ``out``, or
    ``(out, y)`` with ``saving``. It is the Hopper design's "before", timed
    beside it, and the kernel lab's ``full``; no model path calls it. CUDA
    tensor: one launch; CPU tensor: the plain twin."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        out, y = convnext_block_plain_saving(x, *params, eps=eps)
    else:
        out, y = _launch(x, params, eps, saving=saving, first_design=True)
        convnext_block_v0.launches += 1
    return (out, y) if saving else out


convnext_block_v0.launches = 0


BWD_ROUTES = ("fused", "ref", "fused_v1", "explicit")


class _Block(torch.autograd.Function):
    """The block under autograd: forward K1 (the saving form for
    ``"fused"``, else the inference form, saving x), backward K2
    (``"fused"``), the vjp of the eager reference (``"ref"``), K4
    (``"fused_v1"``) or the explicit backward (``"explicit"``). Inputs and
    outputs NHWC; the cotangent is made contiguous."""

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
        from . import convnext_block_bwd as bwds  # imports this module

        if ctx.bwd == "fused":
            x, y, *params = ctx.saved_tensors
            dx, *dparams = bwds.convnext_block_bwd(x, y, g, *params, eps=ctx.eps, ops=ctx.ops)
            ctx.ops = None
        elif ctx.bwd in ("fused_v1", "explicit"):
            x, *params = ctx.saved_tensors
            fn = (bwds.convnext_block_bwd_v1 if ctx.bwd == "fused_v1"
                  else bwds.convnext_block_bwd_explicit)
            dx, *dparams = fn(x, g, *params, eps=ctx.eps)
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
    Recorded by autograd, with the backward ``bwd`` ("fused": K1's saving
    form and K2; "ref": the vjp of the eager reference; "fused_v1": K4;
    "explicit": the explicit backward through K3)."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if bwd not in BWD_ROUTES:
        raise ValueError(f"unknown block backward {bwd!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _Block.apply(x, eps, bwd, *params)
    return _forward(x, params, eps)


convnext_block.launches = 0
register_kernels({"K1": convnext_block, "K1 saving": convnext_block_saving,
                  "K1 first": convnext_block_v0})
