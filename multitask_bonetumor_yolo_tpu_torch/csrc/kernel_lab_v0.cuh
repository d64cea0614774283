// The kernel labs' launch arguments and phase switch, and the launcher of
// the first design's phases (K1's first design, csrc/convnext_block.cuh,
// cut down phase by phase), shared by csrc/kernel_lab_v0.cu (the whole
// first-design lab, the "before" of csrc/kernel_lab.cu) and
// csrc/kernel_lab.cu (which launches K1's Hopper phases through the same
// switch, and the first design's at C = 768, where K1 runs that design).

#pragma once

#include "convnext_block.cuh"

namespace cnb {
namespace lab {

using namespace blk;

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

inline bool valid_c(int C) { return C > 0 && C % 16 == 0 && C <= MAXC; }

// A launcher of the first design's phases at tile K: go<PHASE, SCHED>
template <typename K> struct GoV0 {
  template <int PHASE, int SCHED> static int go(const Args& a) {
    return launch_k<K, false, PHASE, SCHED>(a.x, a.out, nullptr, a.dw, a.dwb, a.w1, a.b1, a.w2,
                                            a.b2, a.B, a.H, a.W, a.C, LN_EPS, a.stream, a.info);
  }
};

// The launch of launcher L (L::go<PHASE, SCHED>) for a phase and a dw
// schedule picked at run time. FULL only with WITH_FULL: at a lab's second
// tile, since at K1's own tile `full` is K1's entry.
template <typename L, bool WITH_FULL>
int by_phase(int phase, int sched, const Args& a) {
  switch (phase) {
    case FULL:
      if constexpr (WITH_FULL) return L::template go<FULL, ROWREG>(a);
      return int(cudaErrorInvalidValue);
    case COPY: return L::template go<COPY, ROWREG>(a);
    case DW:
      switch (sched) {
        case ROWREG: return L::template go<DW, ROWREG>(a);
        case HOISTED: return L::template go<DW, HOISTED>(a);
        case EXPR: return L::template go<DW, EXPR>(a);
        case ROW: return L::template go<DW, ROW>(a);
        case ROW2: return L::template go<DW, ROW2>(a);
        case NOHOIST: return L::template go<DW, NOHOIST>(a);
        default: return int(cudaErrorInvalidValue);
      }
    case DWBF16: return L::template go<DWBF16, ROWREG>(a);
    case DWLN: return L::template go<DWLN, ROWREG>(a);
    case MLP: return L::template go<MLP, ROWREG>(a);
    case MLPGELU: return L::template go<MLPGELU, ROWREG>(a);
    case MLPGELUBF16: return L::template go<MLPGELUBF16, ROWREG>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

// K1's first-design tile at C = 768 (csrc/convnext_block.cu, launch())
using Wide = Cfg<__nv_bfloat16, 2, 12, 128, 256, 2>;

}  // namespace lab
}  // namespace cnb
