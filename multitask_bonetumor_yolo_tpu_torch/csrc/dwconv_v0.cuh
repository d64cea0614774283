// The first design of K3, the depthwise 7x7 convolution (stride 1, SAME,
// fp32 taps and accumulation, fp32 output), kept as the "before" of the
// Hopper redesign in csrc/dwconv.cuh: csrc/dwconv.cu exposes it as
// dwconv7_forward_v0, which only chip_smoke.py and the cuda tests call. Its
// results equal the redesign's bit for bit (one fmaf chain per output in
// the same order).
//
// What bounds it on an H100: x is read once and the fp32 output written
// once (2 + 4 bytes per value in bf16, 4 + 4 in fp32), against 98 flop per
// value on the fp32 units (67 TFLOP/s): 16 (bf16) or 12 (fp32) flop per
// byte, below the 20 flop per byte at which 67 TFLOP/s and 3.35 TB/s meet,
// so it is bound by bytes (in bf16, near the ridge).
//
// Its design: one CTA owns a TH x TW spatial tile of one
// CC-channel chunk (grid: tiles x chunks, no loop carried across CTAs). It
// copies its (TH+6) x (TW+6) halo tile of x into shared memory with 16-byte
// cp.async copies (channels contiguous), zero-filled outside the image and
// past C (it computes its own row and column offsets, so no padded copy of x
// is ever made), and the chunk's 49 taps beside it. Thread (row r, run k,
// channel quad q) computes PX consecutive pixels of one tile row for 4
// channels: per tap row it loads PX+6 halo pixels into registers once and
// reuses them across the 7 column taps (49 fp32 FMAs per output value), and
// writes each pixel's 4 channels as one 16-byte store. The halo row stride
// is padded to an odd number of pixels so that the two rows of a half-warp
// read disjoint shared-memory banks. Each CTA copies its whole halo and
// taps, waits, then computes and stores: nothing overlaps inside a CTA.

#pragma once

#include "cuda_common.cuh"

namespace cnb {
namespace dwc0 {

constexpr int NT = 256;                    // threads per CTA
constexpr int TH = 8, TW = 32, PX = 8;     // tile rows, tile columns, pixels per thread
constexpr int CC = 32;                     // channels per CTA (8 quads of 4)
constexpr int HH = TH + 6, HWU = TW + 6;   // halo rows, halo columns used
constexpr int HWL = HWU + 1;               // halo row stride (pixels): odd, see above
static_assert(TH * (TW / PX) * (CC / 4) == NT, "one output run per thread");

template <typename T> __host__ __device__ constexpr size_t smem_bytes() {
  return align128(size_t(HH) * HWL * CC * sizeof(T)) + size_t(49) * CC * sizeof(float);
}

// 4 consecutive channels of the halo tile as fp32 (one 8- or 16-byte load)
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

// x [B][H][W][C] (T = bf16 or fp32), taps [49][C] fp32, bias [C] fp32 or
// nullptr, out [B][H][W][C] fp32; C a multiple of 16. Grid (B * ceil(H/TH) *
// ceil(W/TW), ceil(C/CC)), NT threads, smem_bytes<T>() of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(NT)
cnb_dwconv7_v0_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                   const float* __restrict__ bias, float* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);  // [HH][HWL][CC]
  float* tw = reinterpret_cast<float*>(smem + align128(size_t(HH) * HWL * CC * sizeof(T)));  // [49][CC]
  const int tid = threadIdx.x;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int w0 = (t % tiles_w) * TW;
  t /= tiles_w;
  const int h0 = (t % tiles_h) * TH;
  const int b = t / tiles_h;
  const int c0 = blockIdx.y * CC;
  const size_t img = size_t(b) * H * W;

  constexpr int V = 16 / sizeof(T);  // channels per 16-byte copy
  constexpr int SEGS = CC / V;
  for (int i = tid; i < HH * HWU * SEGS; i += NT) {
    const int cc = (i % SEGS) * V, pix = i / SEGS;
    const int hr = pix / HWU, hc = pix % HWU;
    const int gh = h0 - 3 + hr, gw = w0 - 3 + hc;
    const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + cc < C;
    cp_async16_zfill(halo + (hr * HWL + hc) * CC + cc,
                     in ? x + (img + size_t(gh) * W + gw) * C + c0 + cc : x, in);
  }
  for (int i = tid; i < 49 * (CC / 4); i += NT) {
    const int cc = (i % (CC / 4)) * 4, tap = i / (CC / 4);
    const bool in = c0 + cc < C;
    cp_async16_zfill(tw + tap * CC + cc, in ? taps + size_t(tap) * C + c0 + cc : taps, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // thread -> (quad q, row r, run k): a half-warp is 8 quads x 2 rows
  const int q = tid % (CC / 4);
  const int r = (tid / (CC / 4)) % TH;
  const int k = tid / ((CC / 4) * TH);
  const int c = c0 + 4 * q;
  float acc[PX][4];
#pragma unroll
  for (int o = 0; o < PX; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
  auto tap_row = [&](int i) {  // the 7 taps of row i, from PX+6 halo pixels in registers
    float in[PX + 6][4];
    const T* row = halo + ((r + i) * HWL + k * PX) * CC + 4 * q;
#pragma unroll
    for (int j = 0; j < PX + 6; ++j) load4(row + j * CC, in[j]);
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(tw + (i * 7 + j) * CC + 4 * q);
#pragma unroll
      for (int o = 0; o < PX; ++o) {
        acc[o][0] = fmaf(in[o + j][0], wv.x, acc[o][0]);
        acc[o][1] = fmaf(in[o + j][1], wv.y, acc[o][1]);
        acc[o][2] = fmaf(in[o + j][2], wv.z, acc[o][2]);
        acc[o][3] = fmaf(in[o + j][3], wv.w, acc[o][3]);
      }
    }
  };
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 7; ++i) tap_row(i);
  } else {  // unrolled, the fp32 form hoists every row's loads: 255 registers and spills
#pragma unroll 1
    for (int i = 0; i < 7; ++i) tap_row(i);
  }
  const int gh = h0 + r;
  if (gh >= H || c >= C) return;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias) bv = *reinterpret_cast<const float4*>(bias + c);
#pragma unroll
  for (int o = 0; o < PX; ++o) {
    const int gw = w0 + k * PX + o;
    if (gw < W)
      *reinterpret_cast<float4*>(out + (img + size_t(gh) * W + gw) * C + c) =
          make_float4(acc[o][0] + bv.x, acc[o][1] + bv.y, acc[o][2] + bv.z, acc[o][3] + bv.w);
  }
}

// Launch on `s`; returns the CUDA error of the launch, or 0.
template <typename T>
int dwconv7_launch(const T* x, const float* taps, const float* bias, float* out, int B, int H,
                   int W, int C, cudaStream_t s) {
  const size_t bytes = smem_bytes<T>();
  auto kern = cnb_dwconv7_v0_kernel<T>;
  // set on every launch, as the first design did (its host cost is part of
  // the "before")
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  kern<<<dim3(unsigned(tiles), unsigned((C + CC - 1) / CC)), NT, bytes, s>>>(x, taps, bias, out, H, W, C);
  return int(cudaGetLastError());
}

}  // namespace dwc0
}  // namespace cnb
