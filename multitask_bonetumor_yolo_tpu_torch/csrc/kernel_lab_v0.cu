// The first design's kernel lab for Hopper (sm_90a): K1's first design
// (csrc/convnext_block.cuh) cut down phase by phase. CUDA C++ with a plain C
// interface (built with nvcc into a shared library, loaded with ctypes).
//
// The kernel lab (K5) replaces the TPU kernel scripts/kernel_lab.py::
// build_variant's `kern` (driven by its `run`): K1's Pallas kernel stripped
// to a DMA-only copy, +dwconv (six Mosaic schedules and a bf16 form), +LN,
// the MLP alone (with and without GELU, and a bf16 GELU), and the full block.
// Since K1's bf16 calls up to C = 384 run its Hopper design, the lab cuts
// that design (csrc/kernel_lab.cu); this library keeps the lab on the first
// design at every width, as that lab's "before" (entry cnb_lab_v0; only
// chip_smoke.py and the card's tests call it).
//
// Every phase here is an instantiation of the device code of K1's first
// design (csrc/convnext_block.cuh, whose header lists the phases and the six
// dw schedules) at its tile for the channel range, bf16 only: the same launch
// shape, the same threads and the same shared-memory size, so that two
// phases differ by their work and not by their occupancy. Its `full` is that
// design's own entry cnb_forward_v0 (csrc/convnext_block.cu); this library
// holds a FULL instantiation only at the second tile, TM = 32 pixels per CTA
// where the first design's tile is larger. Only the dw-only phases'
// instantiations carry a dw schedule, and they carry no MLP code. On the
// H100 the products of this design ran at 5-8 % of the bf16 tensor peak
// (PERF.md).
//
// What bounds each phase on an H100 (per pixel, bf16, C channels): every
// phase moves 4C bytes (x in, out out); the dwconv adds 98C flop on the
// fp32 units, the two products 16C^2 on the tensor cores.

#include "kernel_lab_v0.cuh"

namespace {

using namespace cnb;
using namespace cnb::lab;
using T = __nv_bfloat16;

// The first design's bf16 launch table (csrc/convnext_block.cu, launch()),
// and the second tile TM = 32 (RT = 2) with the same weight tiling; tm = 0
// is the first design's tile, where the lab has no FULL (cnb_forward_v0 is
// that launch). Every bf16 tile has NH = 128 and a 2-deep ring.
template <int RT, int KMAX, int KS> using Go = GoV0<Cfg<T, RT, KMAX, 128, KS, 2>>;

int dispatch(int phase, int sched, int tm, const Args& a) {
  const int C = a.C;
  if (C <= 128) {
    if (tm == 0 || tm == 128) return by_phase<Go<8, 2, 256>, false>(phase, sched, a);
    if (tm == 32) return by_phase<Go<2, 2, 256>, true>(phase, sched, a);
  } else if (C <= 192) {
    if (tm == 0 || tm == 64) return by_phase<Go<4, 3, 256>, false>(phase, sched, a);
    if (tm == 32) return by_phase<Go<2, 3, 256>, true>(phase, sched, a);
  } else if (C <= 384) {
    if (tm == 0 || tm == 64) return by_phase<Go<4, 6, 128>, false>(phase, sched, a);
    if (tm == 32) return by_phase<Go<2, 6, 128>, true>(phase, sched, a);
  } else {
    if (tm == 0 || tm == 32) return by_phase<GoV0<Wide>, false>(phase, sched, a);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One launch of the first design's lab phase `phase` (1 COPY, 2 DW, 3
// DWBF16, 4 DWLN, 5 MLP, 6 MLPGELU, 7 MLPGELUBF16; 0 FULL only at tm = 32
// where the first design's tile is larger) under dw schedule `sched` (0
// ROWREG, 1 HOISTED, 2 EXPR, 3 ROW, 4 ROW2, 5 NOHOIST; DW only, else 0) at
// tile `tm` pixels per CTA (0: the first design's). x, out: contiguous NHWC
// [B, H, W, C] bf16, 16-byte aligned, C a multiple of 16 and at most 768; dw
// [49][C] fp32 taps; w1 [C][4C] and w2 [4C][C] bf16; dwb [C], b1 [4C], b2
// [C] fp32, read by FULL only (nullptr otherwise). Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for what the lab does
// not take.
int cnb_lab_v0(int phase, int sched, int tm, const void* x, void* out, const void* dw,
               const void* dwb, const void* w1, const void* b1, const void* w2, const void* b2,
               int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || !valid_c(C)) return int(cudaErrorInvalidValue);
  if (phase != DW && sched != ROWREG) return int(cudaErrorInvalidValue);
  const Args a{x, out, static_cast<const float*>(dw), static_cast<const float*>(dwb), w1,
               static_cast<const float*>(b1), w2, static_cast<const float*>(b2), B, H, W, C,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(phase, sched, tm, a);
}

}  // extern "C"
