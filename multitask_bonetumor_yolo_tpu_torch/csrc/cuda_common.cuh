// Helpers shared by the port's CUDA sources (csrc/*.cu): tensor-core fragment
// types per compute dtype, fp32 <-> compute-dtype conversions, tanh-GELU and
// cp.async copies. Included inside each source's anonymous namespace use.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace cnb {

using namespace nvcuda;

// wmma shapes per compute dtype: bf16 x bf16 -> fp32 (k = 16), and fp32
// inputs as TF32 (k = 8). PAD is the row padding (elements) of shared-memory
// operand tiles.
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  static constexpr int PAD = 8;
  using In = __nv_bfloat16;
  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <typename F> __device__ static void fix(F&) {}
};

template <> struct Mma<float> {
  static constexpr int K = 8;
  static constexpr int PAD = 4;
  using In = wmma::precision::tf32;
  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <typename F> __device__ static void fix(F& f) {
#pragma unroll
    for (int i = 0; i < f.num_elements; ++i) f.x[i] = wmma::__float_to_tf32(f.x[i]);
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// tanh-form GELU, x * 0.5 * (1 + tanh(u)), written as x * sigmoid(2u) (the
// same function) so that it costs one fast exp and one fast divide instead
// of tanhf: for x -> -inf the divisor overflows and the result is -0.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u2 = 1.5957691216057308f * (x + 0.044715f * x * x * x);  // 2u
  return __fdividef(x, 1.0f + __expf(-u2));
}

// 16-byte global -> shared copy (cp.async, bypassing L1) that writes zeros
// instead when `valid` is false (src-size 0: nothing is read from `gmem`)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

}  // namespace cnb
