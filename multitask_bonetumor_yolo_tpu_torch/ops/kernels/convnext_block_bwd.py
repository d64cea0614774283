"""ConvNeXt block backwards: kernels K2 and K4 (their wrappers and plain
versions) and the explicit backward that runs kernel K3 twice.

K2 is the counterpart of ``multitask_bonetumor_yolo_tpu/ops/pallas/
convnext_block_bwd.py::fused_block_bwd_v2`` (the one-kernel ``_kernel_v2``).
From the block input
``x``, the dwconv output ``y`` that the residual-saving forward kept
(``convnext_block.convnext_block_saving``) and the cotangent ``g`` of the
output, all NHWC in the compute dtype, it returns the gradients in the
forward's argument order: ``dx`` in the compute dtype, then fp32 gradients of
the raw parameters in the port's layouts (``dw_kernel [C,1,7,7]``,
``dw_bias``, ``ln_scale``, ``ln_bias``, ``w1 [4C,C]``, ``b1``, ``w2 [C,4C]``,
``b2``, ``gamma``). The LN moments are recomputed from ``y``, the hidden
layer from the folded ``w1'`` with the tanh-GELU derivative. Where the TPU
kernel runs seven products, K2 and its plain version take the five that the
function needs, in derived forms (the same values up to rounding):
``d_z = ln_scale * d_z2`` from the raw-space ``d_z2 = dt(d_h) dt(w1)`` (the
TPU kernel runs a second product through the folded ``w1'``); ``W =
dt(g)^T dt(a)`` gives ``dw2 = gamma * W`` and ``dgamma = sum_j dt(w2) * W +
b2 * sum g`` (the TPU kernel forms ``o = dt(a) dt(w2)^T`` for dgamma and
``dt(g * gamma)^T dt(a)`` for dw2). They save two of the seven products.

  * :func:`convnext_block_bwd` — on a CUDA tensor it launches the kernels of
    ``csrc/convnext_block_bwd.cu`` (whose header says what bounds them and
    how they are laid out) or raises: in bf16 up to C = 512 its Hopper
    pipeline (four launches, wgmma products), otherwise its first design; on
    a CPU tensor it returns the plain version.
  * :func:`convnext_block_bwd_plain` — the same math and the same casts to
    the compute dtype in plain PyTorch.

K4 is the counterpart of ``fused_block_bwd`` (the one-kernel ``_kernel``,
v1): from ``x`` and ``g`` alone (no saved y) it recomputes ``y`` in fp32 and
returns the same ten gradients, with v1's math: LN moments from the fp32
y, the hidden layer through the raw ``dt(w1)`` from ``dt(z * ln_scale +
ln_bias)``, ``d_a`` from ``dt(g * gamma)`` through the raw ``dt(w2)``, ``d_z =
ln_scale * d_z2`` and ``db2`` summed before the rounding to dt.

  * :func:`convnext_block_bwd_v1` — on a CUDA tensor it launches K4 (the
    ``V1`` instantiation of the same kernels, behind ``cnb_backward_v1``) or
    raises: in bf16 up to C = 384 (:func:`bwd_v1_route`) K2's Hopper
    pipeline under ``V1`` (the recompute of y and four passes, five
    launches; its dw2 and dgamma in K2's derived forms), otherwise its
    first design; on a CPU tensor it returns the plain version.
  * :func:`convnext_block_bwd_v1_v0` — K4's first design whatever the route:
    the Hopper pipeline's "before", timed beside it. No model path calls it.
  * :func:`convnext_block_bwd_v1_plain` — v1's math and casts in PyTorch.
  * :func:`convnext_block_bwd_explicit` — the port of the JAX explicit
    backward (``convnext_block.py::_bwd_padded`` under
    ``CNB_EXPLICIT_BWD=1``): the two depthwise convolutions (y, and dx from
    the flipped taps) are :func:`~.dwconv.dwconv7` (K3 on a CUDA tensor),
    the LN/MLP chain is plain PyTorch with exact (erf) GELU.

Launch counts: ``convnext_block_bwd.launches``,
``convnext_block_bwd_v1.launches`` and ``convnext_block_bwd_v1_v0.launches``
are plain integers that the wrappers raise by one each time they launch
their kernels, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ...utils.profiling import register_kernels
from .build import load_library
from .convnext_block import (
    check_block_args, dt_copy, fold_block_params, kernel_operands,
)
from .dwconv import dwconv7

_GELU_C = 0.7978845608028654


def taps_grad(x, d_y):
    """The depthwise taps' gradient ``[C, 1, 7, 7]``: tap (i, j) is the sum
    over every pixel p of ``x[p + (i-3, j-3)] * d_y[p]`` (x zero outside)."""
    _, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
    ddw = torch.stack([(xp[:, i:i + h, j:j + w, :] * d_y).sum((0, 1, 2))
                       for i in range(7) for j in range(7)])  # [49, C]
    return ddw.t().reshape(c, 1, 7, 7)


def _dx_corr(d_y, dw_kernel):
    """fp32 ``d_y`` correlated with the flipped fp32 taps (the dwconv's
    input gradient, without the residual)."""
    return F.conv2d(d_y.permute(0, 3, 1, 2), dw_kernel.float().flip(2, 3), padding=3,
                    groups=d_y.shape[-1]).permute(0, 2, 3, 1)


def convnext_block_bwd_plain(
    x, y, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """K2's math in plain PyTorch, with the derived forms of ``d_z``, ``dw2``
    and ``dgamma`` (module docstring); operands of every product are cast to
    the compute dtype where the kernel casts them, sums are fp32."""
    dt = x.dtype
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
    d_z2 = dhd @ op(w1)
    d_z = ln_scale.float() * d_z2
    m1 = d_z.mean(-1, keepdim=True)
    m2 = (d_z * z).mean(-1, keepdim=True)
    d_y = r * (d_z - m1 - z * m2)
    a = op(h1 * 0.5 * (1.0 + th))
    wg = flat(op(gf)).t() @ flat(a)  # W = dt(g)^T dt(a) [C, 4C]
    z2 = op(z * ln_scale.float() + ln_bias.float())

    return (
        (_dx_corr(d_y, dw_kernel) + gf).to(dt),
        taps_grad(x, d_y),
        total(d_y),
        total(d_z2 * z),
        total(d_z2),
        flat(dhd).t() @ flat(z2),
        total(d_h),
        gamma.float()[:, None] * wg,
        total(op(gf * gamma.float())),
        (op(w2) * wg).sum(1) + b2.float() * total(gf),
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("convnext_block_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cnb_backward_workspace.argtypes = [ci] * 5
    lib.cnb_backward_workspace.restype = ctypes.c_longlong
    lib.cnb_backward.argtypes = [vp, vp] + [ci] * 4 + [ctypes.c_float, ci, vp]
    lib.cnb_backward.restype = ci
    ip = ctypes.POINTER(ci)
    lib.cnb_backward_row_config.argtypes = [ci, ci, ip, ip, ip]
    lib.cnb_backward_row_config.restype = ci
    for fn in (lib.cnb_backward_route, lib.cnb_backward_v1_route):
        fn.argtypes = [ci, ci]
        fn.restype = ci
    lib.cnb_backward_v1_workspace.argtypes = [ci] * 6
    lib.cnb_backward_v1_workspace.restype = ctypes.c_longlong
    for fn in (lib.cnb_backward_v1, lib.cnb_backward_v1_v0):
        fn.argtypes = [vp, vp] + [ci] * 4 + [ctypes.c_float, ci, vp]
        fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def hopper_route(dt, c: int) -> bool:
    """Whether K2's CUDA calls in compute dtype ``dt`` at width ``c`` run its
    Hopper pipeline (bf16 up to C = 512) rather than its first design: the
    library's own rule (``cnb_backward_route``), which also picks the
    pointer list that :func:`convnext_block_bwd` must pass."""
    return bool(_library().cnb_backward_route(c, int(dt == torch.bfloat16)))


# K4's route (bf16 up to C = 384: the Hopper pipeline; K2's goes on to 512,
# K4's row pass stops at Tiny's widths), mirrored from the
# library's rule ``cnb_backward_v1_route``; the wrapper picks its pointer list
# by it and holds it against the library's at each (dtype, C) it meets
V1_HOPPER_MAX_C = 384


def bwd_v1_route(dt, c: int) -> bool:
    """Whether K4's CUDA calls in compute dtype ``dt`` at width ``c`` run K2's
    Hopper pipeline under ``V1`` rather than K4's first design."""
    return dt == torch.bfloat16 and c <= V1_HOPPER_MAX_C


@functools.lru_cache(maxsize=None)
def _v1_route_checked(dt, c: int) -> bool:
    route = bwd_v1_route(dt, c)
    if bool(_library().cnb_backward_v1_route(c, int(dt == torch.bfloat16))) != route:
        raise RuntimeError(f"K4's route rule disagrees with the library's at {dt}, C={c}")
    return route


def row_pass_config(c: int, v1: bool = False) -> dict:
    """K2's (``v1``: K4's) Hopper row pass at width ``c`` (bf16, ``c`` <= 512;
    K4's <= 384) on the current card: its shared memory per CTA, CTAs per SM
    and hidden chunk."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _library().cnb_backward_row_config(c, int(v1), *[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise RuntimeError(f"cnb_backward_row_config({c}, v1={v1}) failed: CUDA error {rc}")
    return dict(zip(("smem_bytes", "ctas_per_sm", "hidden_chunk"), (v.value for v in vals)))


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

    # the pointer slots of cnb_backward's two pipelines (csrc/convnext_block_bwd.cu)
    if hopper_route(dt, c):
        ins = (x, y, g, *(ops[k] for k in ("taps", "w1f_t", "w2f", "w1_t")), vec(w2),
               ops["b1f"], vec(b2), vec(gamma), vec(ln_scale), vec(ln_bias))
    else:
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


def convnext_block_bwd_v1_plain(
    x, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """K4's math in plain PyTorch (JAX ``_kernel`` v1): y recomputed from x in
    fp32; operands of every product cast to the compute dtype where the
    kernel casts them, sums fp32."""
    dt = x.dtype

    def op(t):
        return t.to(dt).float()

    def total(t):
        return t.reshape(-1, t.shape[-1]).sum(0)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), dw_kernel.float(), dw_bias.float(), padding=3,
                 groups=c).permute(0, 2, 3, 1)
    gf = g.float()
    mean = y.mean(-1, keepdim=True)
    var = ((y * y).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    r = torch.rsqrt(var + eps)
    z = (y - mean) * r
    z2 = op(z * ln_scale.float() + ln_bias.float())
    h1 = z2 @ op(w1).t() + b1.float()
    th = torch.tanh(_GELU_C * (h1 + 0.044715 * h1 * h1 * h1))
    du = _GELU_C * (1.0 + 3.0 * 0.044715 * h1 * h1)
    a = h1 * 0.5 * (1.0 + th)
    do = gf * gamma.float()
    d_h = (op(do) @ op(w2)) * (0.5 * (1.0 + th) + h1 * 0.5 * (1.0 - th * th) * du)
    dhd = op(d_h)
    d_z2 = dhd @ op(w1)
    d_z = d_z2 * ln_scale.float()
    m1 = d_z.mean(-1, keepdim=True)
    m2 = (d_z * z).mean(-1, keepdim=True)
    d_y = r * (d_z - m1 - z * m2)
    o = op(a) @ op(w2).t() + b2.float()
    return (
        (_dx_corr(d_y, dw_kernel) + gf).to(dt),
        taps_grad(x, d_y),
        total(d_y),
        total(d_z2 * z),
        total(d_z2),
        flat(dhd).t() @ flat(z2),
        total(d_h),
        flat(op(do)).t() @ flat(op(a)),
        total(do),
        total(gf * o),
    )


def _launch_v1(x, g, params, eps, first_design):
    """One run of K4's kernels: its route's (``cnb_backward_v1``) or, with
    ``first_design``, its first design's (``cnb_backward_v1_v0``)."""
    name = "convnext_block_bwd_v1" + ("_v0" if first_design else "")
    check_block_args(x, params)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{name}: g must match x {tuple(x.shape)} {x.dtype} on {x.device}")
    if not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous NHWC")
    dt = x.dtype
    b, h, w, c = x.shape
    hopper = not first_design and _v1_route_checked(dt, c)
    dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma = params
    f32 = dict(dtype=torch.float32, device=x.device)

    def vec(t):  # a fresh fp32 copy: contiguous and 16-byte aligned
        return torch.empty(t.shape, **f32).copy_(t)

    taps = vec(dw_kernel.reshape(c, 49).t())
    w1_dt, w2_t = dt_copy(w1, dt), dt_copy(w2.t(), dt)
    # the V1 forms of the pointer slots (csrc/convnext_block_bwd.cu): of
    # k2h::backward on the Hopper pipeline, of the first design's `backward`
    if hopper:
        ins = (x, x, g, taps, w1_dt, w2_t, dt_copy(w1.t(), dt), vec(w2))
    else:
        ins = (x, x, g, taps, dt_copy(w1.t(), dt), dt_copy(w2, dt), w1_dt, w1_dt, w2_t)
    ins += (vec(b1), vec(b2), vec(gamma), vec(ln_scale), vec(ln_bias))
    outs = (torch.empty_like(x), torch.empty(49, c, **f32), torch.empty(c, **f32),
            torch.empty(c, **f32), torch.empty(c, **f32), torch.empty(4 * c, c, **f32),
            torch.empty(4 * c, **f32), torch.empty(c, 4 * c, **f32), torch.empty(c, **f32),
            torch.empty(c, **f32))
    ptrs = ins + outs + (vec(dw_bias),)
    lib = _library()
    is_bf16 = int(dt == torch.bfloat16)
    ws = torch.empty(lib.cnb_backward_v1_workspace(b, h, w, c, is_bf16, int(first_design)),
                     dtype=torch.uint8, device=x.device)
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    fn = lib.cnb_backward_v1_v0 if first_design else lib.cnb_backward_v1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(arr, ws.data_ptr(), b, h, w, c, float(eps), is_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    dx, ddw, *rest = outs
    return (dx, ddw.t().reshape(c, 1, 7, 7), *rest)


def convnext_block_bwd_v1(
    x, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """Recompute-form block backward (K4). CUDA tensors: one run of K4's
    kernels on its route (raises on anything they do not take); CPU tensors:
    the plain version. Returns dx in the compute dtype, then the nine fp32
    gradients in the forward's argument order and the port's layouts."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return convnext_block_bwd_v1_plain(x, g, *params, eps=eps)
    out = _launch_v1(x, g, params, eps, first_design=False)
    convnext_block_bwd_v1.launches += 1
    return out


convnext_block_bwd_v1.launches = 0


def convnext_block_bwd_v1_v0(
    x, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """K4's first design whatever the route (``cnb_backward_v1_v0``), in every
    dtype: the Hopper pipeline's "before", timed beside it; no model path
    calls it. CUDA tensors: one run of its kernels; CPU tensors: the plain
    version."""
    params = (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return convnext_block_bwd_v1_plain(x, g, *params, eps=eps)
    out = _launch_v1(x, g, params, eps, first_design=True)
    convnext_block_bwd_v1_v0.launches += 1
    return out


convnext_block_bwd_v1_v0.launches = 0
register_kernels({"K2": convnext_block_bwd, "K4": convnext_block_bwd_v1,
                  "K4 first": convnext_block_bwd_v1_v0})


def convnext_block_bwd_explicit(
    x, g, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps: float = 1e-6
):
    """The explicit block backward (JAX ``_bwd_padded`` with
    ``CNB_EXPLICIT_BWD=1``): ``y = dt(dwconv7(x, dt(taps))) + dt(b_dw)`` taken
    to fp32, two-pass LN variance, exact (erf) GELU and its derivative, raw
    weights with products of compute-dtype operands summed in fp32, ``dx =
    dt(dwconv7(dt(d_y), flipped dt(taps))) + dt(g)`` and the taps' gradient as
    49 shifted sums. The two depthwise convolutions are :func:`dwconv7` (K3
    on a CUDA tensor, its plain version on a CPU one); the rest is PyTorch."""
    dt = x.dtype

    def op(t):
        return t.to(dt).float()

    def total(t):
        return t.reshape(-1, t.shape[-1]).sum(0)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    gy = g.float()
    k77 = op(dw_kernel[:, 0].permute(1, 2, 0))  # [7, 7, C]
    y = (dwconv7(x, k77).to(dt) + dw_bias.to(dt)).float()
    mean = y.mean(-1, keepdim=True)
    var = ((y - mean) ** 2).mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    z = (y - mean) * r
    z2 = op(z * ln_scale + ln_bias)
    hm = z2 @ op(w1).t() + b1
    a = F.gelu(hm)
    ad = op(a)
    o = ad @ op(w2).t() + b2
    do = gy * gamma
    d_a = op(do) @ op(w2)
    cdf = 0.5 * (1.0 + torch.erf(hm * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * hm * hm)
    d_h = d_a * (cdf + hm * pdf)
    d_z2 = op(d_h) @ op(w1)
    d_z = d_z2 * ln_scale
    m1 = d_z.mean(-1, keepdim=True)
    m2 = (d_z * z).mean(-1, keepdim=True)
    d_y = r * (d_z - m1 - z * m2)
    dx = dwconv7(d_y.to(dt).contiguous(), k77.flip(0, 1)).to(dt) + g.to(dt)
    return (
        dx,
        taps_grad(x, d_y),
        total(d_y),
        total(d_z2 * z),
        total(d_z2),
        flat(d_h).t() @ flat(z2),
        total(d_h),
        flat(do).t() @ flat(ad),
        total(do),
        total(gy * o),
    )
