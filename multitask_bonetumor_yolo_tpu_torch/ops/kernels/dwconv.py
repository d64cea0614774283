"""Depthwise 7x7 convolution (kernel K3): the CUDA kernel's wrapper and its
plain version.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/pallas/dwconv.py::dwconv7``
(stride 1, SAME, fp32 taps and accumulation, fp32 output), in its layout:
``x`` NHWC ``[B, H, W, C]`` in bf16 or fp32, ``taps [7, 7, C]`` fp32, the
result ``[B, H, W, C]`` fp32. The kernel is ``csrc/dwconv.cu``: its Hopper
design (``csrc/dwconv.cuh``, which says what bounds it and how it is laid
out) and its first design (``csrc/dwconv_v0.cuh``), which give the same
bits. It takes C a multiple of 16 (every C of the ConvNeXt block kernels,
16 ... 768, and any wider one).

  * :func:`dwconv7` — on a CUDA tensor it launches the Hopper design or
    raises; on a CPU tensor it returns the plain version.
  * :func:`dwconv7_v0` — the first design, the "before" that
    ``chip_smoke.py`` and the ``cuda`` tests hold the Hopper design against.
  * :func:`dwconv7_plain` — ``F.conv2d(groups=C)`` on the fp32 input.
  * :func:`dwconv7_plan` — the Hopper design's tile, band, chunk, work units
    and CTAs for a shape: the Python mirror of ``csrc/dwconv.cuh::plan``
    (the library's own is :func:`library_plan`).

The block's explicit backward (``convnext_block_bwd.py::
convnext_block_bwd_explicit``) runs it twice. Launch counts:
``dwconv7.launches`` and ``dwconv7_v0.launches`` are plain integers that
each wrapper raises by one at each launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ...utils.profiling import register_kernels
from .build import load_library

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# The Hopper design's constants (csrc/dwconv.cuh)
BAND = 7  # input rows per ring stage, = the period of the 7 accumulator rows
CHUNK = 32  # channels per work unit, one per lane
MAX_WARPS = 6  # column groups (warps) per CTA
PX = 5  # pixels (columns) per thread
BARRIER_BYTES, ALIGN_SLACK = 64, 128
UNIT_ROWS = 3  # a unit's fixed cost in output rows: its start, taps and first band's latency
# the H100's limits per SM, for an estimate of the CTAs that fit when no card is asked
SM_SHARED_BYTES, CTA_RESERVED_BYTES, SM_REGISTERS, SM_THREADS, SM_CTAS = 233472, 1024, 65536, 2048, 32
# registers per thread, as ptxas reports them for the bf16 kernel (the
# estimate's input only: on the card the library asks the runtime)
REGISTERS = 160
# dwc::Plan's fields, in the order dwconv7_plan (csrc/dwconv.cu) returns them
PLAN_FIELDS = ("px", "warps", "tw", "strips", "chunks", "segs", "seg_rows", "units",
               "unit_stages", "ring", "stage_bytes", "smem", "ctas_per_sm", "grid", "sms")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align128(n: int) -> int:
    return _cdiv(n, 128) * 128


def estimated_ctas_per_sm(warps: int, smem: int) -> int:
    """CTAs of ``warps`` warps that fit on one SM by threads, shared memory
    and the registers of :data:`REGISTERS` (allocated in steps of 8)."""
    regs = _cdiv(REGISTERS, 8) * 8
    return min(SM_CTAS, SM_THREADS // (32 * warps), SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES),
               SM_REGISTERS // (regs * 32 * warps))


def dwconv7_plan(b: int, h: int, w: int, c: int, itemsize: int, sms: int = 132,
                 ctas_per_sm: int | None = None) -> dict:
    """The Hopper design's plan for x ``[b, h, w, c]`` of ``itemsize`` bytes
    (2: bf16, 4: fp32), a mirror of ``csrc/dwconv.cuh::plan``:

    * ``px`` pixels per thread (:data:`PX`) and ``warps`` per CTA: the
      fewest columns computed (``strips * tw``, strips of ``tw = warps *
      px``), ties to more warps;
    * ``chunks`` of 32 channels; ``ring`` stages of ``BAND`` rows of
      ``tw + 6`` pixels in shared memory (``stage_bytes`` each, ``smem`` in
      all with two fp32 output rows per warp, the barriers and the alignment
      slack);
    * ``segs`` row segments of ``seg_rows`` rows (``unit_stages`` stages
      each, the segment's rows plus the 6 halo rows): ``units = b * chunks *
      strips * segs`` over ``grid`` persistent CTAs, each taking at most
      ``rounds`` units; the fewest ``rounds * (seg_rows + unit_stages +
      UNIT_ROWS)``, ties to fewer segments.

    ``ctas_per_sm`` is what the runtime reports on the card (the library's
    plan carries it); without it, :func:`estimated_ctas_per_sm`."""
    if min(b, h, w, c) <= 0 or c % 16 or itemsize not in (2, 4):
        raise ValueError(f"dwconv7_plan: no plan for {(b, h, w, c)} x {itemsize} bytes")
    best = None
    for nw in range(MAX_WARPS, 0, -1):
        cols = _cdiv(w, nw * PX) * nw * PX
        if best is None or cols < best:
            best, warps = cols, nw
    px, tw = PX, warps * PX
    ring = 3 if itemsize == 2 else 2
    stage = _align128(BAND * (tw + 6) * CHUNK * itemsize)
    smem = ring * stage + 2 * tw * CHUNK * 4 + BARRIER_BYTES + ALIGN_SLACK  # + output staging
    if ctas_per_sm is None:
        ctas_per_sm = estimated_ctas_per_sm(warps, smem)
    p = {"px": px, "warps": warps, "tw": tw, "strips": _cdiv(w, tw), "chunks": _cdiv(c, CHUNK),
         "ring": ring, "stage_bytes": stage, "smem": smem, "ctas_per_sm": ctas_per_sm, "sms": sms}
    units0, slots = b * p["chunks"] * p["strips"], sms * max(ctas_per_sm, 1)
    best = None
    for segs in range(1, h + 1):
        rows = _cdiv(h, segs)
        if _cdiv(h, rows) != segs:  # the same split as fewer segments
            continue
        units = units0 * segs
        rounds, stages = _cdiv(units, slots), _cdiv(rows + 6, BAND)
        cost = rounds * (rows + stages + UNIT_ROWS)
        if best is None or cost < best:
            best = cost
            p.update(segs=segs, seg_rows=rows, unit_stages=stages, units=units,
                     grid=_cdiv(units, rounds))
    return {k: p[k] for k in PLAN_FIELDS}


def wasted_lanes(plan: dict, w: int, c: int) -> float:
    """The share of the lanes' outputs that fall outside the image: columns
    past W in the last strip, channels past C in the last chunk (rows past H
    are never computed: the guarded bands skip them)."""
    return 1.0 - (w * c) / (plan["strips"] * plan["tw"] * plan["chunks"] * CHUNK)


def dwconv7_plain(x: torch.Tensor, taps: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv2d(x.float(), taps -> [C,1,7,7], bias, padding=3, groups=C)``
    in NHWC. On the card a caller that wants full fp32 turns cuDNN's TF32 off
    (``torch.backends.cudnn.allow_tf32 = False``: convolutions default to
    TF32), as the tests and ``chip_smoke.py`` do."""
    c = x.shape[-1]
    w = taps.float().permute(2, 0, 1).reshape(c, 1, 7, 7)
    b = None if bias is None else bias.float()
    return F.conv2d(x.permute(0, 3, 1, 2).float(), w, b, padding=3, groups=c).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("dwconv")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("dwconv7_forward", "dwconv7_forward_v0"):
        getattr(lib, name).argtypes = [vp] * 4 + [ci] * 5 + [vp]
        getattr(lib, name).restype = ci
    lib.dwconv7_plan.argtypes = [ci] * 5 + [vp]
    lib.dwconv7_plan.restype = ci
    return lib


def library_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype) -> dict:
    """The plan the library launches for this shape on the current card
    (``dwconv7_plan``), by :data:`PLAN_FIELDS`."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    rc = _library().dwconv7_plan(b, h, w, c, int(dtype == torch.bfloat16), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"dwconv7_plan failed: CUDA error {rc}")
    return dict(zip(PLAN_FIELDS, out))


def check_args(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor | None = None) -> None:
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
    if bias is not None and (tuple(bias.shape) != (c,) or bias.device != x.device):
        raise ValueError(f"dwconv7: bias must be [{c}] on {x.device}, "
                         f"got {tuple(bias.shape)} on {bias.device}")


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous, 16-byte aligned fp32 (copied only if it is not)."""
    if t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)


def _launch(entry: str, x: torch.Tensor, taps: torch.Tensor,
            bias: torch.Tensor | None) -> torch.Tensor:
    check_args(x, taps, bias)
    b, h, w, c = x.shape
    t = _fp32(taps)  # [7, 7, C] = [49][C]
    bs = None if bias is None else _fp32(bias)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(x.data_ptr(), t.data_ptr(), None if bs is None else bs.data_ptr(),
                                 out.data_ptr(), b, h, w, c, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def dwconv7(x: torch.Tensor, taps: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise 7x7, stride 1, SAME, fp32 accumulation and output, plus an
    optional fp32 ``bias [C]`` (the library's bias pointer, which K4's
    recompute of y passes). CUDA tensor: one launch of K3's Hopper design
    (raises on anything it does not take); CPU tensor: :func:`dwconv7_plain`."""
    if x.device.type == "cpu":
        return dwconv7_plain(x, taps, bias)
    out = _launch("dwconv7_forward", x, taps, bias)
    dwconv7.launches += 1
    return out


def dwconv7_v0(x: torch.Tensor, taps: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`dwconv7` through K3's first design (the same bits). CPU tensor:
    :func:`dwconv7_plain`."""
    if x.device.type == "cpu":
        return dwconv7_plain(x, taps, bias)
    out = _launch("dwconv7_forward_v0", x, taps, bias)
    dwconv7_v0.launches += 1
    return out


dwconv7.launches = 0
dwconv7_v0.launches = 0
register_kernels({"K3": dwconv7, "K3 first": dwconv7_v0})
