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
// Every phase here is an instantiation of the device code of K1's first
// design (csrc/convnext_block.cuh, whose header lists the phases and the six
// dw schedules) at its tile for the channel range, bf16 only: the same launch
// shape, the same threads and the same shared-memory size, so that two
// phases differ by their work and not by their occupancy. The lab's `full`
// is that design's own entry cnb_forward_v0 (csrc/convnext_block.cu; K1's
// bf16 calls up to C = 384 run its Hopper design instead); this library holds
// a FULL instantiation only at the second tile, TM = 32 pixels per CTA
// where K1's own tile is larger. Only the dw-only phases' instantiations
// carry a dw schedule, and they carry no MLP code.
//
// What bounds each phase on an H100 (per pixel, bf16, C channels): every
// phase moves 4C bytes (x in, out out); the dwconv adds 98C flop on the
// fp32 units, the two products 16C^2 on the tensor cores. The split of K1's
// time between them is what this lab measures (PERF.md).

#include "convnext_block.cuh"

namespace {

using namespace cnb;
using namespace cnb::blk;
using T = __nv_bfloat16;

struct Args {
  const void* x;
  void* out;
  const float* dw;
  const float* dwb;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  int B, H, W, C;
  cudaStream_t stream;
  int* info;
};

constexpr float LN_EPS = 1e-6f;  // the lab's LN: unit scale, no bias

template <typename K, int PHASE, int SCHED = ROWREG>
int go(const Args& a) {
  return launch_k<K, false, PHASE, SCHED>(a.x, a.out, nullptr, a.dw, a.dwb, a.w1, a.b1, a.w2,
                                          a.b2, a.B, a.H, a.W, a.C, LN_EPS, a.stream, a.info);
}

// ALT: the second tile (TM = 32) of a channel range whose K1 tile is larger;
// only there does the lab instantiate FULL (K1's own tile is cnb_forward_v0's)
template <typename K, bool ALT>
int by_phase(int phase, int sched, const Args& a) {
  switch (phase) {
    case FULL:
      if constexpr (ALT) return go<K, FULL>(a);
      return int(cudaErrorInvalidValue);
    case COPY: return go<K, COPY>(a);
    case DW:
      switch (sched) {
        case ROWREG: return go<K, DW, ROWREG>(a);
        case HOISTED: return go<K, DW, HOISTED>(a);
        case EXPR: return go<K, DW, EXPR>(a);
        case ROW: return go<K, DW, ROW>(a);
        case ROW2: return go<K, DW, ROW2>(a);
        case NOHOIST: return go<K, DW, NOHOIST>(a);
        default: return int(cudaErrorInvalidValue);
      }
    case DWBF16: return go<K, DWBF16>(a);
    case DWLN: return go<K, DWLN>(a);
    case MLP: return go<K, MLP>(a);
    case MLPGELU: return go<K, MLPGELU>(a);
    case MLPGELUBF16: return go<K, MLPGELUBF16>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

// K1's bf16 launch table (csrc/convnext_block.cu, launch()), and the second
// tile TM = 32 (RT = 2) with the same weight tiling; tm = 0 is K1's tile.
// chip_smoke.py checks that the default tiles are cnb_forward_tile's.
int dispatch(int phase, int sched, int tm, const Args& a) {
  const int C = a.C;
  if (C <= 128) {
    if (tm == 0 || tm == 128) return by_phase<Cfg<T, 8, 2, 128, 256, 2>, false>(phase, sched, a);
    if (tm == 32) return by_phase<Cfg<T, 2, 2, 128, 256, 2>, true>(phase, sched, a);
  } else if (C <= 192) {
    if (tm == 0 || tm == 64) return by_phase<Cfg<T, 4, 3, 128, 256, 2>, false>(phase, sched, a);
    if (tm == 32) return by_phase<Cfg<T, 2, 3, 128, 256, 2>, true>(phase, sched, a);
  } else if (C <= 384) {
    if (tm == 0 || tm == 64) return by_phase<Cfg<T, 4, 6, 128, 128, 2>, false>(phase, sched, a);
    if (tm == 32) return by_phase<Cfg<T, 2, 6, 128, 128, 2>, true>(phase, sched, a);
  } else {
    if (tm == 0 || tm == 32) return by_phase<Cfg<T, 2, 12, 128, 256, 2>, false>(phase, sched, a);
  }
  return int(cudaErrorInvalidValue);
}

bool valid_c(int C) { return C > 0 && C % 16 == 0 && C <= MAXC; }

}  // namespace

extern "C" {

// One launch of lab phase `phase` (1 COPY, 2 DW, 3 DWBF16, 4 DWLN, 5 MLP,
// 6 MLPGELU, 7 MLPGELUBF16; 0 FULL only at tm = 32 where K1's tile is
// larger) under dw schedule `sched` (0 ROWREG, 1 HOISTED, 2 EXPR, 3 ROW,
// 4 ROW2, 5 NOHOIST; DW only, else 0) at tile `tm` pixels per CTA (0:
// K1's). x, out: contiguous NHWC [B, H, W, C] bf16, 16-byte aligned, C a
// multiple of 16 and at most 768; dw [49][C] fp32 taps; w1 [C][4C] and
// w2 [4C][C] bf16; dwb [C], b1 [4C], b2 [C] fp32, read by FULL only
// (nullptr otherwise). Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the lab does not take.
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
