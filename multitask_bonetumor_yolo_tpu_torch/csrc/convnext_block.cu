// Fused ConvNeXt block forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built with nvcc into a shared library, loaded with ctypes).
//
//     out = x + fc2'(gelu_tanh(fc1'(LN(dwconv7x7(x) + b_dw))))
//
// Replaces the TPU kernel multitask_bonetumor_yolo_tpu/ops/pallas/
// convnext_block.py::_kernel (driven by _forward_padded), both forms: the
// inference form, and the residual-saving form (save_res=True, training)
// that also writes y = dwconv7x7(x) + b_dw in the compute dtype for the
// backward, csrc/convnext_block_bwd.cu (one extra write of C values per
// pixel, taken from shared memory while LayerNorm reads them).
// LayerNorm scale/bias are folded into fc1 and layer-scale gamma into fc2 by
// the caller (ops/kernels/convnext_block.py::kernel_operands), so the kernel
// applies only (y - mean) * rsqrt(var + eps) before fc1.
//
// What bounds it on an H100: a block does 2*C*(49 + 8*C) flop per pixel and,
// fused, moves 4*C bytes per pixel (bf16 in + out). At stage 0 (160x160x96 at
// 640^2) that is 408 flop/byte, near the card's ~295 flop/byte ridge, and the
// unfused torch path is bound by bytes: it writes and re-reads the 4C-wide
// hidden layer and the fp32 LayerNorm tensors (>10x the block's input). At
// stage 3 (20x20x768) it is ~3100 flop/byte: bound by tensor-core throughput,
// and for a fused kernel by how fast the 2 x 4C^2 weights reach the SMs:
// every CTA streams all of them from L2, 2 x 4C^2 x 2 bytes per TM pixels.
//
// Two designs share phase 1 (one launch per block; x read once as a +-3
// halo tile in shared memory, channel chunk by channel chunk, the next chunk
// copied in with cp.async while the current one is computed, plus once more
// for the residual; fp32 taps and sums; the fp32 dwconv output and LN's fp32
// moments in shared memory; the output written once). They differ in phase 2,
// the two products over the 4C hidden columns, which the first design ran at
// 5-8 % of the bf16 tensor peak (PERF.md):
//
//   * Hopper design (namespace k1h, device code and launch table in
//     csrc/convnext_block_h.cuh, which the kernel lab csrc/kernel_lab.cu
//     shares; bf16, C <= 512; the route below): TM =
//     64 pixels per CTA (an 8 x 8 tile; wgmma's M), 128 (8 x 16) at C = 192,
//     in two warpgroups. LN writes dt(z) straight into a K-major
//     128-byte-swizzled A tile (csrc/wgmma.cuh). For each chunk of NC hidden
//     columns: h1 = dt(z) w1'^T-chunk on wgmma, bias and tanh-GELU on the
//     accumulator registers, dt(a) written straight into a swizzled A tile,
//     then out[TM, C] += dt(a) w2'^T-chunk on wgmma into fp32 accumulators.
//     At TM = 64 both warpgroups share the 64 rows and split each product's
//     columns (C/2 accumulators each: 96 registers a thread at C = 384, 128
//     at C = 512, one m64n256k16 product per k step of fc2); at
//     TM = 128 each warpgroup owns 64 rows and all the columns. The products
//     are pipelined: chunk k's fc2 and chunk k+1's fc1 are in flight
//     together, GELU(k+1) runs under fc2(k), one barrier per chunk. The
//     weights, w1'^T [4C, C] and w2'^T [C, 4C] (both K-major: the torch
//     layouts of w1 and w2, folded without a transpose), come by cp.async
//     through two tiles each, w1'^T two chunks ahead of its product and
//     w2'^T one. The epilogue adds b2' and x in fp32 and writes 16 bytes per
//     store. NC = 64 (32 at C = 384 and 512, where the tiles, dt(z) and the
//     accumulators fill the SM; at C = 512 the two w2'^T chunks share one
//     tile, each in the half of its 128-byte rows that NC = 32 leaves free,
//     208 KB in all where two tiles would take 272); two CTAs per SM at
//     C <= 96; ptxas (CUDA 12.8): 167 registers at CP = 384, 186 at 512, no
//     spills. What holds it
//     (PERF.md, tools/k1_knockout.py): phase 1 and LN are half its time or
//     more at C <= 192; the chunk loop copies 8C^2 weight bytes per TM
//     pixels (944 MB per launch at TM = 64 at every stage of the batch-16
//     640^2 trunk), and deeper rings and an overlapped loop did not shorten
//     it. 128 pixels per CTA halve the copies per pixel: that won at C = 192
//     and not at C = 96 (where two 64-pixel CTAs per SM overlap one's phase
//     1 with the other's products). It is K2's row pass
//     (csrc/convnext_block_bwd.cu, k2h) turned round: the same helpers,
//     layouts and chunking.
//   * First design (namespace blk, device code in csrc/convnext_block.cuh,
//     which the first design's kernel lab shares): TM = 128 / 64 / 64 / 32
//     pixels per CTA at C <= 128 / 384 / 384 / 768; nvcuda::wmma on 16 x 16
//     fragments (bf16 x bf16 -> fp32, TF32 for fp32 inputs) by 8 warps as 2
//     rows x 4 columns; fc1 fragments staged through an fp32 tile for bias +
//     GELU; weights through a 2-deep ring of KS x NH tiles, one barrier per
//     tile. It runs fp32, bf16 at C > 512 (where the output accumulators
//     alone would take 192 registers a thread at 64 pixels), and, through its
//     own entry cnb_forward_v0, the "before" of the Hopper design and the
//     first-design lab's `full`.
//
// The route (cnb_forward_route, which the wrapper asks to pick the operands'
// layouts): bf16 up to C = 512 runs the Hopper design, the rest the first.
//
// Numerics (both designs; match the plain twin convnext_block_plain): dwconv
// with fp32 taps and fp32 accumulation; LN moments in fp32 as E[y^2] - mean^2
// clamped at 0; the normalised tensor and the post-GELU hidden layer are cast
// to the compute dtype before their matrix products; GELU in the sigmoid form
// of the tanh form (cuda_common.cuh); the residual is added in fp32, then
// cast. Phase 1 is the same code in both, so the saving form's y is the same
// bits; the products sum in other orders.

#include "convnext_block_h.cuh"  // includes convnext_block.cuh and wgmma.cuh

namespace {

using namespace cnb;
using namespace cnb::blk;

// One instantiation per channel range: the most pixels per CTA whose output
// tile (TM x C fp32 in registers, KMAX >= C/64 column tiles per warp) and
// shared memory (< 227 KB) fit. On an H100 at the batch-16 640^2 bf16 stage
// shapes, TM = 128 / 64 / 64 / 32 cut the time per block by 15 / 26 / 28 / 0 %
// against TM = 32 everywhere; TM = 64 at C = 96 was 8 % slower than TM = 32.
// With `info`, nothing is launched: launch_k reports the tile instead.
template <typename T, bool SAVE>
int launch(const void* x, void* out, void* y, const float* dw, const float* dwb, const void* w1,
           const float* b1, const void* w2, const float* b2, int B, int H, int W, int C,
           float eps, cudaStream_t stream, int* info = nullptr) {
#define CNB_LAUNCH(...)                                                                      \
  launch_k<Cfg<T, __VA_ARGS__>, SAVE>(x, out, y, dw, dwb, w1, b1, w2, b2, B, H, W, C, eps, \
                                      stream, info)
  if constexpr (sizeof(T) == 2) {
    if (C <= 128) return CNB_LAUNCH(8, 2, 128, 256, 2);
    if (C <= 192) return CNB_LAUNCH(4, 3, 128, 256, 2);
    if (C <= 384) return CNB_LAUNCH(4, 6, 128, 128, 2);
    return CNB_LAUNCH(2, 12, 128, 256, 2);
  } else {
    if (C <= 128) return CNB_LAUNCH(2, 2, 64, 128, 3);
    if (C <= 256) return CNB_LAUNCH(2, 4, 64, 128, 3);
    if (C <= 384) return CNB_LAUNCH(2, 6, 64, 128, 3);
    return CNB_LAUNCH(2, 12, 64, 128, 3);
  }
#undef CNB_LAUNCH
}

// K1 in bf16 on Hopper (C <= 512), namespace k1h: its device code and
// launch table are in csrc/convnext_block_h.cuh, which the kernel lab shares.

inline bool bad_shape(int B, int H, int W, int C) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || C > MAXC;
}

// K1's bf16 calls up to C = 512 run the Hopper design (namespace k1h); fp32
// and the wider bf16 calls, the first design
inline bool hopper_route(int C, int is_bf16) { return is_bf16 && C <= k1h::HMAXC; }

// The first design on every shape it takes.
int forward_v0(const void* x, void* out, void* y, const float* dw, const float* dwb,
               const void* w1, const float* b1, const void* w2, const float* b2, int B, int H,
               int W, int C, float eps, int is_bf16, cudaStream_t s) {
#define CNB_DISPATCH(T, SAVE) \
  return launch<T, SAVE>(x, out, y, dw, dwb, w1, b1, w2, b2, B, H, W, C, eps, s)
  if (is_bf16) {
    if (y) CNB_DISPATCH(__nv_bfloat16, true);
    CNB_DISPATCH(__nv_bfloat16, false);
  }
  if (y) CNB_DISPATCH(float, true);
  CNB_DISPATCH(float, false);
#undef CNB_DISPATCH
}

}  // namespace

extern "C" {

// x, out: contiguous NHWC [B, H, W, C] in the compute dtype (bf16 if is_bf16,
// else fp32), C a multiple of 16 and at most MAXC; y: nullptr, or a tensor
// like x that receives the dwconv output plus bias (the residual-saving form);
// dw [49][C] fp32; biases fp32; the folded weights in the compute dtype, in
// the layouts of the route (cnb_forward_route): on the Hopper design w1 is
// dt(w1')^T [4C][C] and w2 dt(w2')^T [C][4C], on the first design w1 is
// dt(w1') [C][4C] and w2 dt(w2') [4C][C]. Launches on `stream`; returns
// cudaGetLastError().
int cnb_forward(const void* x, void* out, void* y, const void* dw, const void* dwb,
                const void* w1, const void* b1, const void* w2, const void* b2, int B, int H,
                int W, int C, float eps, int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C)) return int(cudaErrorInvalidValue);
  const auto* f_dw = static_cast<const float*>(dw);
  const auto* f_dwb = static_cast<const float*>(dwb);
  const auto* f_b1 = static_cast<const float*>(b1);
  const auto* f_b2 = static_cast<const float*>(b2);
  auto s = static_cast<cudaStream_t>(stream);
  if (hopper_route(C, is_bf16)) {
    if (y)
      return k1h::forward<true>(x, out, y, f_dw, f_dwb, w1, f_b1, w2, f_b2, B, H, W, C, eps, s);
    return k1h::forward<false>(x, out, y, f_dw, f_dwb, w1, f_b1, w2, f_b2, B, H, W, C, eps, s);
  }
  return forward_v0(x, out, y, f_dw, f_dwb, w1, f_b1, w2, f_b2, B, H, W, C, eps, is_bf16, s);
}

// K1's first design on any shape cnb_forward takes, whatever the route
// (w1 dt(w1') [C][4C], w2 dt(w2') [4C][C]): the "before" of the Hopper
// design, and the `full` of the first design's kernel lab.
int cnb_forward_v0(const void* x, void* out, void* y, const void* dw, const void* dwb,
                   const void* w1, const void* b1, const void* w2, const void* b2, int B, int H,
                   int W, int C, float eps, int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C)) return int(cudaErrorInvalidValue);
  return forward_v0(x, out, y, static_cast<const float*>(dw), static_cast<const float*>(dwb), w1,
                    static_cast<const float*>(b1), w2, static_cast<const float*>(b2), B, H, W, C,
                    eps, is_bf16, static_cast<cudaStream_t>(stream));
}

// 1 if cnb_forward at width C and this dtype runs the Hopper design (and
// takes its weight layouts), 0 if it runs the first design.
int cnb_forward_route(int C, int is_bf16) { return int(hopper_route(C, is_bf16)); }

// The first design's tile for C channels in the compute dtype (bf16 if
// is_bf16, else fp32), inference form (save = 0) or saving form: info = {TM,
// TH, TW, CTAs per SM}. The first design's kernel lab matches its tiles to
// it. Launches nothing; returns the CUDA error of the query, or 0.
int cnb_forward_tile(int C, int is_bf16, int save, int* info) {
  if (C <= 0 || C % 16 != 0 || C > MAXC || !info) return int(cudaErrorInvalidValue);
#define CNB_TILE(T, SAVE) \
  return launch<T, SAVE>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, \
                         nullptr, 1, 1, 1, C, 0.f, nullptr, info)
  if (is_bf16) {
    if (save) CNB_TILE(__nv_bfloat16, true);
    CNB_TILE(__nv_bfloat16, false);
  }
  if (save) CNB_TILE(float, true);
  CNB_TILE(float, false);
#undef CNB_TILE
}

// The Hopper design's tile at width C (bf16, C <= 512), inference form (save
// = 0) or saving form: info = {TM, TH, TW, CTAs per SM, shared-memory bytes
// per CTA, hidden chunk NC}. Launches nothing; returns the CUDA
// error of the query, or 0.
int cnb_forward_hopper_tile(int C, int save, int* info) {
  if (C <= 0 || C % 16 != 0 || C > k1h::HMAXC || !info) return int(cudaErrorInvalidValue);
  if (save)
    return k1h::forward<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, 1, 1, 1, C, 0.f, nullptr, info);
  return k1h::forward<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, 1, 1, 1, C, 0.f, nullptr, info);
}

}  // extern "C"
