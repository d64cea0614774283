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
// the caller (ops/kernels/convnext_block.py::fold_block_params), so the kernel
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
// What the design does about it:
//   * one launch per block; x is read once (a +-3 halo tile in shared memory,
//     channel chunk by channel chunk, the next chunk copied in with cp.async
//     while the current one is computed) plus once more for the residual, and
//     the output is written once. The dwconv output, the normalised tensor
//     and the 4C hidden layer live only in shared memory and registers.
//   * a CTA owns TM = 16*RT output pixels (a TH x TW spatial tile). The
//     weight stream per pixel falls as 1/TM, and TM is bounded by the
//     registers that hold the TM x C fp32 output tile: TM = 128 for C <= 128,
//     64 for C <= 384, 32 above (see launch()).
//   * the hidden layer is walked in chunks of NH columns: fc1 for the chunk
//     (tensor cores, fp32 accumulate), bias + tanh-GELU by each warp on its
//     own fc1 fragments (staged through shared memory), then the chunk's
//     share of fc2 accumulates into register fragments that hold the whole
//     TM x C output tile. The 8 warps form 2 rows x 4 columns: a warp owns
//     RT/2 row tiles and every 4th 16-column tile.
//   * the weights stream through a ring of shared-memory tiles (fc1: KS rows
//     x NH hidden columns, fc2: NH hidden rows x KS output columns) filled
//     with cp.async by all threads while the tensor cores work on the
//     previous tile.
//   * matrix products use nvcuda::wmma: bf16 x bf16 -> fp32 for bf16 inputs,
//     TF32 for fp32 inputs.
// Not yet done (later work): mma.sync/ldmatrix or wgmma in place of wmma (and
// GELU on the accumulators instead of through shared memory), TMA multicast
// of weight tiles across a cluster (to cut the weight stream at stage 3).
//
// The device code is in csrc/convnext_block.cuh, which the kernel lab
// (csrc/kernel_lab.cu) shares; this file holds K1's instantiations, its
// launch table and its C entry.
//
// Numerics (match the plain twin convnext_block_plain): dwconv with fp32 taps
// and fp32 accumulation; LN moments in fp32 as E[y^2] - mean^2 clamped at 0;
// the normalised tensor and the post-GELU hidden layer are cast to the compute
// dtype before their matrix products; the residual is added in fp32, then cast.

#include "convnext_block.cuh"

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

}  // namespace

extern "C" {

// x, out: contiguous NHWC [B, H, W, C] in the compute dtype (bf16 if is_bf16,
// else fp32), C a multiple of 16 and at most MAXC; y: nullptr, or a tensor
// like x that receives the dwconv output plus bias (the residual-saving form);
// dw [49][C] fp32; w1 [C][4C] and w2 [4C][C] in the compute dtype; biases
// fp32. Launches on `stream`; returns cudaGetLastError().
int cnb_forward(const void* x, void* out, void* y, const void* dw, const void* dwb,
                const void* w1, const void* b1, const void* w2, const void* b2, int B, int H,
                int W, int C, float eps, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || C > MAXC)
    return int(cudaErrorInvalidValue);
  const auto* f_dw = static_cast<const float*>(dw);
  const auto* f_dwb = static_cast<const float*>(dwb);
  const auto* f_b1 = static_cast<const float*>(b1);
  const auto* f_b2 = static_cast<const float*>(b2);
  auto s = static_cast<cudaStream_t>(stream);
#define CNB_DISPATCH(T, SAVE) \
  return launch<T, SAVE>(x, out, y, f_dw, f_dwb, w1, f_b1, w2, f_b2, B, H, W, C, eps, s)
  if (is_bf16) {
    if (y) CNB_DISPATCH(__nv_bfloat16, true);
    CNB_DISPATCH(__nv_bfloat16, false);
  }
  if (y) CNB_DISPATCH(float, true);
  CNB_DISPATCH(float, false);
#undef CNB_DISPATCH
}

// K1's tile for C channels in the compute dtype (bf16 if is_bf16, else
// fp32), inference form (save = 0) or saving form: info = {TM, TH, TW, CTAs
// per SM}. Launches nothing; returns the CUDA error of the query, or 0.
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

}  // extern "C"
