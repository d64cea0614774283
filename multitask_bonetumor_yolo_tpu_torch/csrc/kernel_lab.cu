// The kernel lab (K5) for Hopper (sm_90a): the fused ConvNeXt block forward
// (K1, csrc/convnext_block.cu) cut down phase by phase, to show where K1's
// time goes. CUDA C++ with a plain C interface (built with nvcc into a
// shared library, loaded with ctypes).
//
// Replaces the TPU kernel scripts/kernel_lab.py::build_variant's `kern`
// (driven by its `run`): K1's Pallas kernel stripped to a DMA-only copy,
// +dwconv (six Mosaic schedules and a bf16 form), +LN, the MLP alone (with
// and without GELU, and a bf16 GELU), and the full block.
//
// The lab follows K1's route. In bf16 up to C = 384 every phase is an
// instantiation of the device code of K1's Hopper design
// (csrc/convnext_block_h.cuh, whose header lists the phases; the products
// on wgmma, GELU on the accumulators, K1's cp.async loads) at K1's tile,
// threads and shared-memory size: 64 pixels per CTA at C <= 96 and at C =
// 384, 128 at C = 192 (k1h::forward). It also runs them at the other tile
// where that fits, 128 pixels at C <= 96 and 64 at C = 192; C = 384 takes
// no second tile (128 pixels would hold 192 accumulators a thread). The
// lab's `full` at K1's tile is K1's own entry cnb_forward (Python); this
// library holds a FULL instantiation only at the other tile. At C = 768,
// where K1 runs its first design, the lab runs the first design's phases
// (csrc/kernel_lab_v0.cuh) at that design's tile, as the whole
// first-design lab (csrc/kernel_lab_v0.cu) does at every width.
//
// What bounds each phase on an H100 (per pixel, bf16, C channels): every
// phase moves 4C bytes (x in, out out); the dwconv adds 98C flop on the
// fp32 units, the two products 16C^2 on the tensor cores. The split of K1's
// time between them is what this lab measures (PERF.md).

#include "convnext_block_h.cuh"
#include "kernel_lab_v0.cuh"

namespace {

using namespace cnb;
using namespace cnb::lab;

// A launcher of K1's Hopper phases at (CP, NC, TM): go<PHASE, SCHED>; the
// biases are the caller's zeros. With a.info, launch nothing and report
// {TM, TH, TW, CTAs per SM}.
template <int CP, int NC, int TM> struct GoH {
  template <int PHASE, int SCHED> static int go(const Args& a) {
    int info[6];
    const int rc = k1h::launch_h<CP, NC, TM, false, PHASE, SCHED>(
        a.x, a.out, nullptr, a.dw, a.dwb, a.w1, a.b1, a.w2, a.b2, a.B, a.H, a.W, a.C, LN_EPS,
        a.stream, a.info ? info : nullptr);
    if (a.info)
      for (int i = 0; i < 4; ++i) a.info[i] = info[i];
    return rc;
  }
};

// K1's route and tiles: k1h::forward's (CP, NC, TM) at tm = 0 or K1's TM,
// the other tile where it fits, the first design at C > 384. chip_smoke.py
// checks that the default tiles are cnb_forward_hopper_tile's.
int dispatch(int phase, int sched, int tm, const Args& a) {
  const int C = a.C;
  if (C <= 48) {
    if (tm == 0 || tm == 64) return by_phase<GoH<48, 64, 64>, false>(phase, sched, a);
    if (tm == 128) return by_phase<GoH<48, 64, 128>, true>(phase, sched, a);
  } else if (C <= 96) {
    if (tm == 0 || tm == 64) return by_phase<GoH<96, 64, 64>, false>(phase, sched, a);
    if (tm == 128) return by_phase<GoH<96, 64, 128>, true>(phase, sched, a);
  } else if (C <= 192) {
    if (tm == 0 || tm == 128) return by_phase<GoH<192, 64, 128>, false>(phase, sched, a);
    if (tm == 64) return by_phase<GoH<192, 64, 64>, true>(phase, sched, a);
  } else if (C <= 384) {  // the lab stops at Tiny's widths: no phases at K1's C = 512
    if (tm == 0 || tm == 64) return by_phase<GoH<384, 32, 64>, false>(phase, sched, a);
  } else {
    if (tm == 0 || tm == 32) return by_phase<GoV0<Wide>, false>(phase, sched, a);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One launch of lab phase `phase` (1 COPY, 2 DW, 3 DWBF16, 4 DWLN, 5 MLP,
// 6 MLPGELU, 7 MLPGELUBF16; 0 FULL only at the other tile) under dw
// schedule `sched` (0 ROWREG, 1 HOISTED, 2 EXPR, 3 ROW, 4 ROW2, 5 NOHOIST;
// DW only, else 0) at tile `tm` pixels per CTA (0: K1's). x, out:
// contiguous NHWC [B, H, W, C] bf16, 16-byte aligned, C a multiple of 16 and
// at most 768; dw [49][C] fp32 taps; the weights in the layouts of K1's
// route (cnb_forward): up to C = 384 w1 = dt(w1)^T [4C][C] and w2 =
// dt(w2)^T [C][4C], at C > 384 w1 [C][4C] and w2 [4C][C], bf16; dwb [C], b1
// [4C], b2 [C] fp32 zeros up to C = 384 (K1's code reads them in DWLN, the
// MLP phases and FULL), else read by FULL only (nullptr otherwise). Launches
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for what
// the lab does not take.
int cnb_lab(int phase, int sched, int tm, const void* x, void* out, const void* dw,
            const void* dwb, const void* w1, const void* b1, const void* w2, const void* b2,
            int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || !valid_c(C)) return int(cudaErrorInvalidValue);
  if (phase != DW && sched != ROWREG) return int(cudaErrorInvalidValue);
  const Args a{x, out, static_cast<const float*>(dw), static_cast<const float*>(dwb), w1,
               static_cast<const float*>(b1), w2, static_cast<const float*>(b2), B, H, W, C,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(phase, sched, tm, a);
}

// The tile of cnb_lab(phase, sched, tm, ...) at C channels: info = {TM, TH,
// TW, CTAs per SM}. Launches nothing; returns cudaErrorInvalidValue where
// cnb_lab would refuse, else the CUDA error of the query, or 0.
int cnb_lab_tile(int C, int phase, int sched, int tm, int* info) {
  if (!valid_c(C) || !info) return int(cudaErrorInvalidValue);
  if (phase != DW && sched != ROWREG) return int(cudaErrorInvalidValue);
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1,
               C, nullptr, info};
  return dispatch(phase, sched, tm, a);
}

}  // extern "C"
