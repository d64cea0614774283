"""The kernel lab (K5): kernel K1 cut down phase by phase, and the plain
versions of its variants.

Counterpart of ``scripts/kernel_lab.py::build_variant`` (its Pallas ``kern``),
which strips the TPU's fused ConvNeXt block kernel to find where its time
goes. Its 14 variants, each a function of x bf16 ``[B, H, W, C]``, the taps
``[7, 7, C]`` fp32 (no bias), ``w1 [C, 4C]`` and ``w2 [4C, C]`` bf16:

  * ``copy`` — out = x.
  * ``dw`` and its five other schedules ``dwexpr``, ``dwrow``, ``dwrow2``,
    ``dwrownh``, ``dwrowreg`` — out = bf16(sum of 49 fp32(x) * tap), fp32
    accumulation. One function; on the TPU six Mosaic schedules of it, here
    six dw schedules of K1's dw phase (``csrc/convnext_block.cuh`` describes
    each). ``dwrowreg`` is K1's own.
  * ``dwbf16`` — the dwconv in bf16 arithmetic: per kernel column dx a bf16
    running sum over dy of bf16(x * bf16(tap)), each op rounded (a product,
    then a sum; no fused multiply-add), the 7 partials summed in fp32.
  * ``dwln`` — out = bf16(LN(dw(x))), no affine, eps 1e-6.
  * ``mlp`` — out = bf16(x + bf16(bf16(x) @ w1) @ w2), fp32 accumulation.
  * ``mlpgelu`` — ``mlp`` with fp32 tanh-GELU on the hidden layer. (The JAX
    lab imports ``_gelu_fast as _gelu_exact``: despite the name it is the
    tanh form.) ``mlptanh`` is the same function (bit-identical in JAX) and
    the same instantiation here.
  * ``mlpgelubf16`` — ``mlp`` with the tanh-GELU evaluated in bf16, each op
    rounded, on the bf16-rounded hidden layer.
  * ``full`` — dw -> LN -> fc1 -> tanh-GELU -> fc2 -> + x, no biases, unit LN
    and unit gamma: K1 itself, through its own C entry ``cnb_forward`` with
    zero biases (the fold of a unit LN and a unit gamma is the identity).

The lab follows K1's route up to Tiny's widths. In bf16 up to C = 384 it
cuts K1's Hopper design (``csrc/kernel_lab.cu`` on
``csrc/convnext_block_h.cuh``: the products on wgmma, K1's tile and loads),
which takes the weights as ``w1'^T [4C, C]`` and ``w2'^T [C, 4C]``
(:func:`hopper_operands`); wider, it cuts the first design: at C = 768,
where K1 runs that design too, and at 512, where K1 runs its Hopper design
and the lab has no phases of it (:func:`hopper_route`). The first
design's lab at every width (``csrc/kernel_lab_v0.cu``) stays callable as
:func:`lab_variant_v0`, the "before".

Where the LN forms differ, the port keeps K1's on both sides (the kernel
and its plain version): fp32 moments as E[y^2] - mean^2, clamped at 0. The
JAX lab's LN is two-pass; the tests' tolerance covers the difference.

The functions here:

  * :func:`lab_variant` — on a CUDA tensor it launches the variant's kernel
    (``csrc/kernel_lab.cu``, or K1's ``cnb_forward`` for ``full`` at K1's
    tile) or raises; on a CPU tensor it returns the plain version.
    :func:`lab_variant_v0` — the same on the first design's lab.
  * :func:`lab_variant_plain` — the variant step by step in PyTorch, with the
    casts where the JAX lab casts.
  * :func:`lab_tile` — the tile a variant launches with (TM pixels per CTA,
    TH x TW, CTAs per SM), asked of the library; :func:`legal_tiles`, the
    tiles the lab has at a C: K1's, and the other where there is one.

Launch counts: ``lab_variant.launches`` and ``lab_variant_v0.launches`` are
plain integers that the wrappers raise by one at each kernel launch, and
nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import convnext_block as k1
from .build import load_library

MAX_CHANNELS = 768
LN_EPS = 1e-6

# the C side's phase and dw-schedule ids (csrc/convnext_block.cuh)
PHASES = {"full": 0, "copy": 1, "dw": 2, "dwbf16": 3, "dwln": 4, "mlp": 5, "mlpgelu": 6,
          "mlpgelubf16": 7}
SCHEDULES = {"rowreg": 0, "hoisted": 1, "expr": 2, "row": 3, "row2": 4, "nohoist": 5}

# name -> (phase, dw schedule): the instantiation each variant launches
VARIANTS = {
    "copy": ("copy", "rowreg"),
    "dw": ("dw", "hoisted"),
    "dwexpr": ("dw", "expr"),
    "dwrow": ("dw", "row"),
    "dwrow2": ("dw", "row2"),
    "dwrownh": ("dw", "nohoist"),
    "dwrowreg": ("dw", "rowreg"),
    "dwbf16": ("dwbf16", "rowreg"),
    "dwln": ("dwln", "rowreg"),
    "mlp": ("mlp", "rowreg"),
    "mlpgelu": ("mlpgelu", "rowreg"),
    "mlptanh": ("mlpgelu", "rowreg"),
    "mlpgelubf16": ("mlpgelubf16", "rowreg"),
    "full": ("full", "rowreg"),
}
# a variant that launches another's instantiation
SHARES = {"mlptanh": "mlpgelu"}
DW_FAMILY = ("dw", "dwexpr", "dwrow", "dwrow2", "dwrownh", "dwrowreg")
# the widest C at which the lab cuts K1's Hopper design into phases: Tiny's
# widths; K1's route goes on to ``convnext_block.HOPPER_MAX_CHANNELS`` = 512
HOPPER_MAX_CHANNELS = 384
V0_SECOND_TILE = 32  # TM of the first-design lab's second tile


def card_tolerance(name: str) -> tuple[float, float]:
    """(rtol, atol) of a variant's kernel against its plain version on the
    card: ``copy`` bit-exact; within one bf16 step (rtol 2^-7, atol 1e-3)
    where both sides sum fp32 products in another order or round the same
    bf16 operations one by one (the dw family, ``dwbf16``, ``dwln``,
    ``mlpgelubf16``); the other products' phases at the repo's bf16 kernel
    tolerance, 3e-2."""
    if name == "copy":
        return 0.0, 0.0
    if name in DW_FAMILY + ("dwbf16", "dwln", "mlpgelubf16"):
        return 2.0 ** -7, 1e-3
    return 3e-2, 3e-2


def check_variant_args(name: str, x: torch.Tensor) -> None:
    """Raise on anything the lab does not take (on either device)."""
    if name not in VARIANTS:
        raise ValueError(f"kernel lab: unknown variant {name!r}; known: {', '.join(VARIANTS)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel lab: x must be bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"kernel lab: x must be [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % 16 or c > MAX_CHANNELS:
        raise ValueError(f"kernel lab: C={c} must be a multiple of 16 and <= {MAX_CHANNELS}")


# ---------------------------------------------------------------- plain ----

def _shifts(x: torch.Tensor):
    """x zero-padded by 3 on H and W: the (dy, dx) window of shape x."""
    _, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 3, 3, 3, 3))
    return lambda dy, dx: xp[:, dy:dy + h, dx:dx + w, :]


def dw_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """fp32 sum of the 49 fp32(x) * tap products, dx outer, dy inner (the
    JAX lab's order)."""
    win = _shifts(x.float())
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dx in range(7):
        for dy in range(7):
            y = y + win(dy, dx) * taps[dy, dx].float()
    return y


def dwbf16_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Per kernel column a bf16 running sum over dy of bf16 products (each op
    rounded), the 7 partials summed in fp32."""
    win = _shifts(x)
    tb = taps.to(torch.bfloat16)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dx in range(7):
        part = torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
        for dy in range(7):
            part = part + win(dy, dx) * tb[dy, dx]
        y = y + part.float()
    return y


def ln_plain(y: torch.Tensor) -> torch.Tensor:
    """K1's LayerNorm without affine: fp32 moments, var = E[y^2] - mean^2
    clamped at 0."""
    mean = y.mean(-1, keepdim=True)
    var = ((y * y).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    r = torch.rsqrt(var + LN_EPS)
    return y * r - mean * r


def gelu_tanh_bf16(h: torch.Tensor) -> torch.Tensor:
    """tanh-GELU on a bf16 tensor in bf16 arithmetic, op by op in the JAX
    expression's order; the constants rounded to bf16 as JAX rounds a Python
    scalar against a bf16 array."""
    def const(v):
        return torch.tensor(v, dtype=torch.bfloat16, device=h.device)

    inner = h + const(0.044715) * h * h * h
    return h * const(0.5) * (const(1.0) + torch.tanh(const(0.7978845608028654) * inner))


def mlp_plain(z: torch.Tensor, x: torch.Tensor, w1, w2, act: str) -> torch.Tensor:
    """bf16(x + bf16(act(z @ w1)) @ w2): bf16 operands, fp32 sums."""
    h = z.float() @ w1.float()
    if act == "gelu":
        h = k1.gelu_tanh(h).to(torch.bfloat16)
    elif act == "gelu_bf16":
        h = gelu_tanh_bf16(h.to(torch.bfloat16))
    else:
        h = h.to(torch.bfloat16)
    return (x.float() + h.float() @ w2.float()).to(torch.bfloat16)


def lab_variant_plain(name: str, x: torch.Tensor, taps: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor) -> torch.Tensor:
    """The variant's function in plain PyTorch (see the module docstring):
    x bf16 ``[B, H, W, C]``, taps ``[7, 7, C]`` fp32, w1 ``[C, 4C]`` and w2
    ``[4C, C]`` bf16; bf16 ``[B, H, W, C]`` out."""
    check_variant_args(name, x)
    bf = torch.bfloat16
    if name == "copy":
        return x.clone()
    if name in DW_FAMILY:
        return dw_plain(x, taps).to(bf)
    if name == "dwbf16":
        return dwbf16_plain(x, taps).to(bf)
    if name == "dwln":
        return ln_plain(dw_plain(x, taps)).to(bf)
    if name == "full":
        return mlp_plain(ln_plain(dw_plain(x, taps)).to(bf), x, w1, w2, "gelu")
    act = {"mlp": None, "mlpgelu": "gelu", "mlptanh": "gelu", "mlpgelubf16": "gelu_bf16"}[name]
    return mlp_plain(x, x, w1, w2, act)


# --------------------------------------------------------------- kernel ----

@functools.lru_cache(maxsize=None)
def _library(v0: bool = False) -> ctypes.CDLL:
    """The Hopper lab (``kernel_lab``: ``cnb_lab``, ``cnb_lab_tile``) or,
    with ``v0``, the first design's (``kernel_lab_v0``: ``cnb_lab_v0``)."""
    lib = load_library("kernel_lab_v0" if v0 else "kernel_lab")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launch = lib.cnb_lab_v0 if v0 else lib.cnb_lab
    launch.argtypes = [ci] * 3 + [vp] * 8 + [ci] * 4 + [vp]
    launch.restype = ci
    if not v0:
        lib.cnb_lab_tile.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
        lib.cnb_lab_tile.restype = ci
    return lib


def hopper_route(c: int) -> bool:
    """Whether the lab runs K1's Hopper design at C = ``c``: where K1's bf16
    route (``cnb_forward_route``) does and ``c`` <= ``HOPPER_MAX_CHANNELS``;
    ``chip_smoke.py`` holds this against the library at every width the
    route knows, 512 included, where the lab stops and K1 does not."""
    return c <= HOPPER_MAX_CHANNELS


def k1_tile_pixels(c: int, v0: bool = False) -> int:
    """The TM of K1's bf16 inference launch at C = ``c`` without asking the
    library, for the CPU route's argument checks: on K1's route the Hopper
    design's 64 / 64 / 128 / 64 pixels at C <= 48 / 96 / 192 / 384
    (``k1h::forward``) and the first design's 32 at C = 768; with ``v0`` the
    first design's 128 / 64 / 32 at C <= 128 / 384 / 768 (``launch()`` in
    ``csrc/convnext_block.cu``). On the card :func:`k1_tile` asks the
    library, and ``chip_smoke.py`` checks that the two agree."""
    if v0 or not hopper_route(c):
        return 128 if c <= 128 else 64 if c <= 384 else 32
    return 128 if 96 < c <= 192 else 64


def legal_tiles(c: int, v0: bool = False) -> tuple[int, ...]:
    """The lab's tiles at C = ``c`` (TM pixels per CTA): K1's, and the other
    where the lab has one. The Hopper lab has 64 and 128 at C <= 192 and
    K1's tile alone at C = 384 and 768; the first design's lab (``v0``)
    has its K1 tile and TM = 32."""
    tm = k1_tile_pixels(c, v0)
    if v0:
        return tuple(sorted({tm, V0_SECOND_TILE}))
    return (64, 128) if c <= 192 else (tm,)


def check_tile(c: int, tm: int, v0: bool = False) -> int:
    """The tile ``tm`` resolved (0: K1's), or ValueError naming the legal ones."""
    legal = legal_tiles(c, v0)
    if tm != 0 and tm not in legal:
        raise ValueError(f"kernel lab: no tile TM={tm} at C={c}; legal: {legal} "
                         f"(0 asks for K1's, {k1_tile_pixels(c, v0)})")
    return tm or k1_tile_pixels(c, v0)


@functools.lru_cache(maxsize=None)
def k1_tile(c: int, v0: bool = False) -> tuple[int, int, int, int]:
    """(TM, TH, TW, CTAs per SM) of K1's bf16 inference launch at C = ``c``
    on its route (``v0``: of its first design), asked of K1's library
    (``cnb_forward_hopper_tile`` or ``cnb_forward_tile``; needs a card)."""
    if hopper_route(c) and not v0:
        t = k1.hopper_tile(c)
        return t["tm"], t["th"], t["tw"], t["ctas_per_sm"]
    lib = k1._library()
    ci = ctypes.c_int
    lib.cnb_forward_tile.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    lib.cnb_forward_tile.restype = ci
    info = (ci * 4)()
    rc = lib.cnb_forward_tile(c, 1, 0, info)
    if rc != 0:
        raise ValueError(f"kernel lab: K1 has no tile at C={c} (CUDA error {rc})")
    return tuple(info)


@functools.lru_cache(maxsize=None)
def lab_tile(name: str, c: int, tm: int = 0) -> tuple[int, int, int, int]:
    """(TM, TH, TW, CTAs per SM) of variant ``name`` at C = ``c`` channels
    and tile ``tm`` (0: K1's), asked of the CUDA libraries (needs a card).
    Raises ValueError, naming the legal tiles, where the lab has none."""
    if name not in VARIANTS:
        raise ValueError(f"kernel lab: unknown variant {name!r}")
    tm = check_tile(c, tm)
    phase, sched = VARIANTS[name]
    if phase == "full" and tm == k1_tile(c)[0]:
        return k1_tile(c)
    info = (ctypes.c_int * 4)()
    rc = _library().cnb_lab_tile(c, PHASES[phase], SCHEDULES[sched], tm, info)
    if rc != 0:
        raise ValueError(f"kernel lab: no tile TM={tm} at C={c} (CUDA error {rc})")
    return tuple(info)


def hopper_operands(w1: torch.Tensor, w2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The weights as K1's Hopper design takes them, from the lab's w1 ``[C,
    4C]`` and w2 ``[4C, C]``: ``w1'^T [4C, C]`` and ``w2'^T [C, 4C]`` in
    bf16, folded by K1's own fold (``fold_block_weights_t``) at unit LN
    scale and unit gamma, where the fold is the identity: the two
    transposes, bit for bit."""
    ones = torch.ones(w1.shape[0], dtype=torch.float32, device=w1.device)
    w1t, w2t = k1.fold_block_weights_t(ones, w1.t(), w2.t(), ones)
    return w1t.to(torch.bfloat16), w2t.to(torch.bfloat16)


def check_kernel_args(x: torch.Tensor, taps, w1, w2, wt=None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel lab: unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("kernel lab: x must be contiguous NHWC, 16-byte aligned")
    c = x.shape[-1]
    want = {"taps": ((7, 7, c), torch.float32), "w1": ((c, 4 * c), torch.bfloat16),
            "w2": ((4 * c, c), torch.bfloat16), "w1'^T": ((4 * c, c), torch.bfloat16),
            "w2'^T": ((c, 4 * c), torch.bfloat16)}
    for (label, (shape, dt)), t in zip(want.items(), (taps, w1, w2, *(wt or ()))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device:
            raise ValueError(f"kernel lab: {label} must be {dt} {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"kernel lab: {label} must be contiguous, 16-byte aligned")


def _launch(name, x, taps, w1, w2, tm, zeros, wt, v0) -> torch.Tensor:
    """One launch of variant ``name`` on CUDA tensors (see :func:`lab_variant`)."""
    b, h, w, c = x.shape
    tm = check_tile(c, tm, v0)
    hopper = hopper_route(c) and not v0
    check_kernel_args(x, taps, w1, w2, wt if hopper else None)
    if hopper and wt is None:
        wt = hopper_operands(w1, w2)
    if zeros is None:
        zeros = torch.zeros(4 * c, dtype=torch.float32, device=x.device)
    if zeros.numel() < 4 * c or zeros.dtype != torch.float32 or zeros.device != x.device:
        raise ValueError("kernel lab: zeros must be fp32 with at least 4C values on x's device")
    w1p, w2p = (wt[0].data_ptr(), wt[1].data_ptr()) if hopper else (w1.data_ptr(), w2.data_ptr())
    phase, sched = VARIANTS[name]
    out = torch.empty_like(x)
    bias = zeros.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if phase == "full" and tm == k1_tile_pixels(c, v0):  # K1's own launch
            lib = k1._library()
            fn = lib.cnb_forward_v0 if v0 else lib.cnb_forward
            rc = fn(x.data_ptr(), out.data_ptr(), None, taps.data_ptr(), bias, w1p, bias, w2p,
                    bias, b, h, w, c, LN_EPS, 1, stream)
        else:
            lib = _library(v0)
            fn = lib.cnb_lab_v0 if v0 else lib.cnb_lab
            rc = fn(PHASES[phase], SCHEDULES[sched], tm, x.data_ptr(), out.data_ptr(),
                    taps.data_ptr(), bias, w1p, bias, w2p, bias, b, h, w, c, stream)
    if rc != 0:
        raise RuntimeError(f"kernel lab {name} launch failed: CUDA error {rc}")
    return out


def lab_variant(name: str, x: torch.Tensor, taps: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, tm: int = 0, zeros: torch.Tensor | None = None,
                wt: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Variant ``name`` of the lab on x bf16 ``[B, H, W, C]`` with taps
    ``[7, 7, C]`` fp32, w1 ``[C, 4C]`` and w2 ``[4C, C]`` bf16 (contiguous).
    CUDA tensor: one launch at tile ``tm`` (0: K1's; else one of
    :func:`legal_tiles`), or raises. Up to C = 384 it launches K1's Hopper
    design cut down, on ``wt`` = :func:`hopper_operands` (made here when not
    given); at C = 768 the first design's. ``full`` at K1's tile is K1's own
    entry ``cnb_forward``; every bias is ``zeros`` (an fp32 zero vector of at
    least 4C values, made here when not given). CPU tensor: the plain
    version."""
    check_variant_args(name, x)
    if x.device.type == "cpu":
        return lab_variant_plain(name, x, taps, w1, w2)
    out = _launch(name, x, taps, w1, w2, tm, zeros, wt, v0=False)
    lab_variant.launches += 1
    return out


lab_variant.launches = 0


def lab_variant_v0(name: str, x: torch.Tensor, taps: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, tm: int = 0, zeros: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """:func:`lab_variant` on the first design's lab at every width (tiles
    ``legal_tiles(c, v0=True)``; ``full`` at that design's tile is its entry
    ``cnb_forward_v0``): the "before" of the Hopper lab. Only
    ``chip_smoke.py`` and the card's tests call it. CPU tensor: the plain
    version."""
    check_variant_args(name, x)
    if x.device.type == "cpu":
        return lab_variant_plain(name, x, taps, w1, w2)
    out = _launch(name, x, taps, w1, w2, tm, zeros, None, v0=True)
    lab_variant_v0.launches += 1
    return out


lab_variant_v0.launches = 0
