// Kernel K7: eval-mode BatchNorm + activation + cast in one pass, for Hopper
// (sm_90a), CUDA C++ with a plain C interface (built with nvcc into a shared
// library, loaded with ctypes; wrapper ops/kernels/bn_act.py).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the BN, the activation and
// the cast after each convolution into the convolution's epilogue. Eagerly,
// PyTorch runs the same chain (models/common.py: x.float(), BN on the
// running statistics in fp32, SiLU or ELU, .to(dtype)) as four launches that
// move ~28 bytes per element of a bf16 map; this pass moves 4 (bf16 in, bf16
// out), once, and computes the chain in its order (BN in fp32 on the conv's
// rounded output, then the activation, then the cast):
//
//   s = weight * rsqrt(var + eps),  t = bias - mean * s  (per channel)
//   out = cast(act(x * s + t))
//
// with s and t folded as cuDNN's inference BN folds them (each an fma): its
// fp32 output, which the eager chain feeds to the activation, agrees bit for
// bit on ~86 % of the elements of a P3 neck map, against ~47 % for
// (x - mean) * s + bias (H100, cuDNN of torch 2.11). act is identity, SiLU
// (x / (1 + exp(-x)), as PyTorch's) or ELU with alpha 1 (expm1 below 0); the
// cast rounds to nearest even, as torch's .to(bfloat16).
//
// What bounds it: bytes. Per element it reads 2 (bf16) or 4 (fp32) bytes and
// writes as many, against ~20 fp32 instructions (one fma, the activation's
// exp and divide, the conversions), which the SM issues ~1.5x faster than HBM
// delivers the bytes. The design does what a byte-bound pass
// needs:
//   * 16-byte vectors: 8 bf16 (4 fp32) channels per load and store;
//   * each thread keeps one channel group's scale and shift in registers
//     while its block walks the tiles (a tile row is a pixel's `groups`
//     vectors, so a warp reads neighbouring vectors: a pixel's channels,
//     then the next pixel's);
//   * UNROLL independent 16-byte loads in flight per thread before any math
//     (64 bytes: a few resident blocks per SM hold more in flight than HBM's
//     latency at its rate asks for, ~20 KB per SM);
//   * pixels `stride` elements apart on input: a channels-last map or a
//     channel slice of one (the heads' fused first conv) is read in place,
//     no copy; the output is a new contiguous channels-last map.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // at most, per block: rows x groups
constexpr int UNROLL = 4;     // pixels per thread, loaded before any math

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_ELU = 2 };

struct Params {
  const void* x;
  void* out;
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
  long long pixels;  // N * H * W
  long long stride;  // elements between neighbouring pixels of x (>= c)
  int c;             // channels
  int groups;        // c / vector width: 16-byte vectors per pixel
};

template <int ACT> __device__ __forceinline__ float act(float v) {
  if (ACT == ACT_SILU) return v / (1.0f + expf(-v));
  if (ACT == ACT_ELU) return v > 0.0f ? v : expm1f(v);
  return v;
}

// 16 bytes of T <-> fp32 values
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(uint4 u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// A tile: UNROLL x rows pixels (rows = blockDim.x / groups) of every
// channel; thread t takes channel group t % groups of the tile's pixels
// tile * UNROLL * rows + u * rows + t / groups, u < UNROLL. The grid is at
// most the blocks resident on the card at once, and each block walks the
// tiles, so that a thread folds its channels' statistics once per launch.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS) bn_act_kernel(Params p) {
  constexpr int N = Vec<T>::N;
  const int g = threadIdx.x % p.groups;
  const int rows = blockDim.x / p.groups;
  const int row = threadIdx.x / p.groups;
  const long long tile_px = static_cast<long long>(UNROLL) * rows;
  const long long tiles = (p.pixels + tile_px - 1) / tile_px;
  const int c0 = g * N;

  float scale[N], shift[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    scale[i] = p.weight[c0 + i] * rsqrtf(p.var[c0 + i] + p.eps);
    shift[i] = fmaf(-p.mean[c0 + i], scale[i], p.bias[c0 + i]);
  }

  const T* x = static_cast<const T*>(p.x) + c0;
  T* out = static_cast<T*>(p.out) + c0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long first = t * tile_px + row;
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long px = first + static_cast<long long>(u) * rows;
      v[u] = px < p.pixels ? __ldg(reinterpret_cast<const uint4*>(x + px * p.stride))
                           : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long px = first + static_cast<long long>(u) * rows;
      if (px >= p.pixels) break;
      float f[N];
      Vec<T>::load(v[u], f);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = act<ACT>(fmaf(f[i], scale[i], shift[i]));
      *reinterpret_cast<uint4*>(out + px * p.c) = Vec<T>::store(f);
    }
  }
}

// The SMs of the current device, read once per device.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev))
    return 0;
  return sms[dev];
}

template <typename T, int ACT> int launch_act(const Params& p, cudaStream_t s) {
  const int rows = THREADS / p.groups;
  const int threads = rows * p.groups;
  const long long tile_px = static_cast<long long>(rows) * UNROLL;
  const long long tiles = (p.pixels + tile_px - 1) / tile_px;
  // blocks of `threads` that fit on one SM (by registers and threads), asked
  // once per block size
  static int per_sm[THREADS + 1] = {};
  if (!per_sm[threads]) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[threads], bn_act_kernel<T, ACT>, threads, 0);
    if (e != cudaSuccess) return int(e);
  }
  const int sms = sm_count();
  if (!sms || !per_sm[threads]) return int(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(sms) * per_sm[threads];
  const dim3 grid(static_cast<unsigned>(tiles < resident ? tiles : resident)), block(threads);
  bn_act_kernel<T, ACT><<<grid, block, 0, s>>>(p);
  return int(cudaGetLastError());
}

template <typename T> int launch(const Params& p, int act_kind, cudaStream_t s) {
  switch (act_kind) {
    case ACT_NONE: return launch_act<T, ACT_NONE>(p, s);
    case ACT_SILU: return launch_act<T, ACT_SILU>(p, s);
    case ACT_ELU: return launch_act<T, ACT_ELU>(p, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x: pixels x c values, bf16 if is_bf16 else fp32, pixel i's channels at
// x + i * stride (a channels-last map: stride = c; a channel slice of one:
// the full map's channel count), 16-byte aligned, c and stride multiples of
// the 16-byte vector (8 bf16, 4 fp32); out: pixels x c of the same dtype,
// contiguous, 16-byte aligned; mean, var, weight, bias: [c] fp32; act 0
// identity, 1 SiLU, 2 ELU. Launches on `stream` without synchronising;
// returns the CUDA error of the launch, or 0.
int bn_act_forward(const void* x, void* out, const float* mean, const float* var,
                   const float* weight, const float* bias, float eps, long long pixels, int c,
                   long long stride, int is_bf16, int act, void* stream) {
  const int n = is_bf16 ? 8 : 4;
  if (pixels <= 0 || c <= 0 || c % n || stride < c || stride % n || c / n > THREADS)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return int(cudaErrorMisalignedAddress);
  const Params p{x, out, mean, var, weight, bias, eps, pixels, stride, c, c / n};
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, act, s) : launch<float>(p, act, s);
}

}  // extern "C"
