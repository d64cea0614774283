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
// Numerics (match the plain twin convnext_block_plain): dwconv with fp32 taps
// and fp32 accumulation; LN moments in fp32 as E[y^2] - mean^2 clamped at 0;
// the normalised tensor and the post-GELU hidden layer are cast to the compute
// dtype before their matrix products; the residual is added in fp32, then cast.

#include "cuda_common.cuh"

namespace {

using namespace cnb;

constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int CC = 32;  // channels per dwconv chunk (one per lane)
constexpr int MAXC = 768;

// One kernel instantiation: compute dtype T; RT 16-pixel row tiles per CTA;
// KMAX output column tiles per warp (>= C/64); NH hidden columns per MLP
// chunk; KS = fc1 tile rows (K slice) = fc2 tile columns; NSTAGE tiles in
// the weight ring.
template <typename T_, int RT_, int KMAX_, int NH_, int KS_, int NSTAGE_>
struct Cfg {
  using T = T_;
  static constexpr int RT = RT_, KMAX = KMAX_, NH = NH_, KS = KS_, NSTAGE = NSTAGE_;
  static constexpr int TM = 16 * RT;           // pixels per CTA
  static constexpr int TH = RT == 2 ? 4 : 8;   // tile rows
  static constexpr int TW = TM / TH;           // tile cols
  static constexpr int HALO_H = TH + 6, HALO_W = TW + 6;
  static constexpr int PX = TM / NWARP;        // dwconv: pixels (one row run) per thread
  static constexpr int RW = RT / 2;            // row tiles per warp
  static constexpr int FC1_F = NH / 64;        // fc1 column tiles per warp per tile
  static constexpr int FC2_F = KS / 64;        // fc2 column tiles per warp per tile
  static constexpr int MINB = (RT == 2 && KMAX <= 4) ? 2 : 1;  // CTAs per SM
  static_assert(RT % 2 == 0 && TW % PX == 0, "tile shape");
  static_assert(NH % 64 == 0 && KS % 64 == 0, "weight tiling");
};

// Shared memory: y (fp32 dwconv output, later the output staging), z (the
// normalised tensor), phase-1 scratch (two halo tiles + taps) and phase-2
// scratch (weight ring + hidden chunk). bf16: phase-2 scratch reuses y's
// bytes (y is dead once z is written) and phase-1 scratch reuses z's (z is
// written after phase 1). fp32: z overwrites y in place, so the scratches
// sit after it.
template <typename K> struct Layout {
  int ldy, ldz, ldh, ldt, ldw1, ldw2;
  size_t tile_bytes, chunk_bytes, off_z, off_p1, off_p2, off_dw, off_hbuf, off_ht, total;
  __host__ __device__ Layout(int C) {
    using T = typename K::T;
    constexpr bool alias = sizeof(T) == 4;
    constexpr int PAD = Mma<T>::PAD;
    ldy = C + 4;
    ldz = alias ? ldy : C + PAD;
    ldh = K::NH + 4;
    ldt = K::NH + PAD;
    ldw1 = K::NH + PAD;
    const int ks = C < K::KS ? C : K::KS;  // tile rows (fc1) = tile columns (fc2)
    ldw2 = ks + PAD;
    tile_bytes = align128(max_sz(size_t(ks) * ldw1, size_t(K::NH) * ldw2) * sizeof(T));
    const size_t y_b = align128(size_t(K::TM) * ldy * sizeof(float));
    const size_t z_b = alias ? 0 : align128(size_t(K::TM) * ldz * sizeof(T));
    // phase 1: two buffers (double-buffered channel chunks), each a halo
    // tile [HALO_H][HALO_W][CC] and the chunk's taps [49][CC] fp32
    const size_t halo_b = align128(size_t(K::HALO_H) * K::HALO_W * CC * sizeof(T));
    chunk_bytes = halo_b + align128(size_t(49) * CC * sizeof(float));
    const size_t p1_b = 2 * chunk_bytes;
    const size_t hbuf_b = align128(size_t(K::TM) * ldh * sizeof(float));
    const size_t p2_b =
        K::NSTAGE * tile_bytes + hbuf_b + align128(size_t(K::TM) * ldt * sizeof(T));
    off_dw = halo_b;
    off_hbuf = K::NSTAGE * tile_bytes;
    off_ht = off_hbuf + hbuf_b;
    if (alias) {
      off_z = 0;
      off_p1 = off_p2 = y_b;
      total = y_b + max_sz(p1_b, p2_b);
    } else {
      off_p2 = 0;
      off_z = off_p1 = max_sz(y_b, p2_b);
      total = off_z + max_sz(z_b, p1_b);
    }
  }
};

// Issue the cp.async copies of weight tile t into ring slot `buf`. Tiles run
// chunk by chunk: for hidden chunk j (columns j*NH ..), nks fc1 tiles (K slice
// s: rows s*KS .. of w1, the chunk's NH columns), then nks fc2 tiles (column
// slice s: the chunk's NH rows of w2, columns s*KS ..). When 4C is not a
// multiple of NH, the last chunk's hidden columns past 4C are zero-filled.
template <typename K, typename T>
__device__ __forceinline__ void issue_tile(const T* __restrict__ w1, const T* __restrict__ w2,
                                           T* buf, int t, int nks, int C, const Layout<K>& L) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  const int chunk = t / (2 * nks);
  const int r = t % (2 * nks);
  const int j0 = chunk * K::NH;
  const int tid = threadIdx.x;
  if (r < nks) {
    const int k0 = r * K::KS;
    const int rows = min(K::KS, C - k0);
    constexpr int segs = K::NH / V;
    for (int i = tid; i < rows * segs; i += NTHREAD) {
      const int row = i / segs, col = j0 + (i % segs) * V;
      const bool in = col < 4 * C;
      cp_async16_zfill(buf + row * L.ldw1 + (col - j0),
                       in ? w1 + size_t(k0 + row) * (4 * C) + col : w1, in);
    }
  } else {
    const int c0 = (r - nks) * K::KS;
    const int segs = min(K::KS, C - c0) / V;
    for (int i = tid; i < K::NH * segs; i += NTHREAD) {
      const int row = i / segs, seg = i % segs;
      const bool in = j0 + row < 4 * C;
      cp_async16_zfill(buf + row * L.ldw2 + seg * V,
                       in ? w2 + size_t(j0 + row) * C + c0 + seg * V : w2, in);
    }
  }
}

// SAVE: also write y (the dwconv output plus bias, pre-LN, compute dtype,
// NHWC) for the backward (csrc/convnext_block_bwd.cu). The SAVE = false
// instantiation is the inference kernel, unchanged.
template <typename K, bool SAVE>
__global__ void __launch_bounds__(NTHREAD, K::MINB)
cnb_forward_kernel(const typename K::T* __restrict__ x, typename K::T* __restrict__ out,
                   typename K::T* __restrict__ yout,  // [B][H][W][C] when SAVE
                   const float* __restrict__ dw,   // [49][C] fp32 taps
                   const float* __restrict__ dwb,  // [C]
                   const typename K::T* __restrict__ w1,  // [C][4C] folded fc1
                   const float* __restrict__ b1,          // [4C]
                   const typename K::T* __restrict__ w2,  // [4C][C] folded fc2
                   const float* __restrict__ b2,          // [C]
                   int H, int W, int C, float eps) {
  using T = typename K::T;
  using M = Mma<T>;
  constexpr int TM = K::TM, TH = K::TH, TW = K::TW, HALO_W = K::HALO_W;
  constexpr int NH = K::NH, KS = K::KS, NSTAGE = K::NSTAGE, RW = K::RW, KMAX = K::KMAX;
  constexpr int FC1_F = K::FC1_F, FC2_F = K::FC2_F, PX = K::PX;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<K> L(C);
  float* ys = reinterpret_cast<float*>(smem);                            // [TM][ldy]
  T* zs = reinterpret_cast<T*>(smem + L.off_z);                          // [TM][ldz]
  unsigned char* p1 = smem + L.off_p1;  // 2 x (halo [HALO_H][HALO_W][CC], taps [49][CC])
  unsigned char* ring = smem + L.off_p2;                                 // NSTAGE weight tiles
  float* hbuf = reinterpret_cast<float*>(smem + L.off_p2 + L.off_hbuf);  // [TM][ldh]
  T* hts = reinterpret_cast<T*>(smem + L.off_p2 + L.off_ht);             // [TM][ldt]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int w0 = (t % tiles_w) * TW;
  t /= tiles_w;
  const int h0 = (t % tiles_h) * TH;
  const int b = t / tiles_h;
  const size_t img = size_t(b) * H * W * C;
  const T* xb = x + img;
  T* ob = out + img;
  T* yb = SAVE ? yout + img : nullptr;

  // ---- phase 1: depthwise 7x7 (SAME, zero taps outside the image) ----
  // Channel chunk by channel chunk; chunk k+1's halo tile and taps are
  // copied in (cp.async, zero-filled outside the image and past C) while
  // chunk k is computed. Thread (group g, lane c) computes channel c of the
  // PX pixels g*PX .. (one run within a tile row).
  {
    const int c = tid % CC;
    const int g = tid / CC;
    const int r = (g * PX) / TW;
    const int cb = (g * PX) % TW;
    const int nchunk = (C + CC - 1) / CC;
    auto load_chunk = [&](int k) {
      unsigned char* buf = p1 + (k & 1) * L.chunk_bytes;
      T* halo = reinterpret_cast<T*>(buf);
      float* dws = reinterpret_cast<float*>(buf + L.off_dw);
      const int c0 = k * CC;
      constexpr int V = 16 / sizeof(T);  // channels per 16-byte copy
      constexpr int SEGS = CC / V;
      for (int i = tid; i < K::HALO_H * HALO_W * SEGS; i += NTHREAD) {
        const int cc = (i % SEGS) * V;
        const int pix = i / SEGS;
        const int gh = h0 - 3 + pix / HALO_W;
        const int gw = w0 - 3 + pix % HALO_W;
        const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + cc < C;
        cp_async16_zfill(halo + pix * CC + cc,
                         in ? xb + (size_t(gh) * W + gw) * C + c0 + cc : xb, in);
      }
      constexpr int TSEGS = CC / 4;  // 16-byte copies per tap row
      for (int i = tid; i < 49 * TSEGS; i += NTHREAD) {
        const int cc = (i % TSEGS) * 4;
        const int tap = i / TSEGS;
        const bool in = c0 + cc < C;
        cp_async16_zfill(dws + tap * CC + cc, in ? dw + size_t(tap) * C + c0 + cc : dw, in);
      }
    };
    load_chunk(0);
    cp_async_commit();
    for (int k = 0; k < nchunk; ++k) {
      if (k + 1 < nchunk) load_chunk(k + 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk k landed (k + 1 may be in flight)
      __syncthreads();
      const unsigned char* buf = p1 + (k & 1) * L.chunk_bytes;
      const T* halo = reinterpret_cast<const T*>(buf);
      const float* dws = reinterpret_cast<const float*>(buf + L.off_dw);
      const int c0 = k * CC;
      float acc[PX];
#pragma unroll
      for (int o = 0; o < PX; ++o) acc[o] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        float in[PX + 6];
#pragma unroll
        for (int j = 0; j < PX + 6; ++j) in[j] = to_f(halo[((r + dy) * HALO_W + cb + j) * CC + c]);
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const float wv = dws[(dy * 7 + dx) * CC + c];
#pragma unroll
          for (int o = 0; o < PX; ++o) acc[o] = fmaf(in[o + dx], wv, acc[o]);
        }
      }
      if (c0 + c < C) {
        const float bias = dwb[c0 + c];
#pragma unroll
        for (int o = 0; o < PX; ++o) ys[(r * TW + cb + o) * L.ldy + c0 + c] = acc[o] + bias;
      }
      __syncthreads();
    }
  }

  // ---- LayerNorm over the real C channels (fp32 moments) ----
  const float inv_c = 1.0f / float(C);
  for (int pi = 0; pi < TM / NWARP; ++pi) {
    const int p = warp * (TM / NWARP) + pi;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = ys[p * L.ldy + c];
      s += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s * inv_c;
    const float var = fmaxf(s2 * inv_c - mean * mean, 0.f);
    const float rs = rsqrtf(var + eps);
    const float mr = mean * rs;
    // y is written from the same read: in fp32, z overwrites y in place
    const bool save = SAVE && h0 + p / TW < H && w0 + p % TW < W;
    T* yp = save ? yb + (size_t(h0 + p / TW) * W + w0 + p % TW) * C : nullptr;
    for (int c = lane; c < C; c += 32) {
      const float v = ys[p * L.ldy + c];
      zs[p * L.ldz + c] = from_f<T>(v * rs - mr);
      if (save) yp[c] = from_f<T>(v);
    }
  }
  __syncthreads();  // z complete; y (and for bf16 its bytes) free for phase 2

  // ---- phase 2: MLP over hidden chunks, weights through the tile ring ----
  // The 8 warps form 2 rows x 4 columns: warp (wr, wc) owns row tiles
  // wr*RW .. wr*RW + RW-1 and the 16-column tiles wc, wc+4, wc+8, ... of
  // every product. Output column tile ct = wc + 4k sits in oacc[.][k]; fc2
  // tile s (columns s*KS..) holds k = FC2_F*s .. FC2_F*s + FC2_F-1.
  const int nct = C / 16;  // 16-column tiles of the output
  const int wr = warp & 1;
  const int wc = warp >> 1;
  const int nks = (C + KS - 1) / KS;  // fc1 K slices = fc2 column slices per chunk
  const int ntiles = ((4 * C + NH - 1) / NH) * 2 * nks;  // last chunk may be partial
  typename M::CFrag oacc[RW][KMAX];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int k = 0; k < KMAX; ++k) wmma::fill_fragment(oacc[i][k], 0.f);
  typename M::CFrag hacc[RW][FC1_F];

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < ntiles) issue_tile<K>(w1, w2, reinterpret_cast<T*>(ring + s * L.tile_bytes), s, nks, C, L);
    cp_async_commit();
  }
  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile tt visible to all; slot (tt-1) % NSTAGE free
    {
      const int nt = tt + NSTAGE - 1;
      if (nt < ntiles)
        issue_tile<K>(w1, w2, reinterpret_cast<T*>(ring + (nt % NSTAGE) * L.tile_bytes), nt, nks,
                      C, L);
      cp_async_commit();
    }
    const T* tile = reinterpret_cast<const T*>(ring + (tt % NSTAGE) * L.tile_bytes);
    const int r = tt % (2 * nks);
    const int j0 = (tt / (2 * nks)) * NH;
    if (r < nks) {
      // fc1: hidden chunk (TM x NH) += z[:, K slice] @ tile
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int h = 0; h < FC1_F; ++h) wmma::fill_fragment(hacc[i][h], 0.f);
      }
      const int k0 = r * KS;
      const int rows = min(KS, C - k0);
      for (int kk = 0; kk < rows; kk += M::K) {
        typename M::AFrag a[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          wmma::load_matrix_sync(a[i], zs + (wr * RW + i) * 16 * L.ldz + k0 + kk, L.ldz);
          M::fix(a[i]);
        }
#pragma unroll
        for (int h = 0; h < FC1_F; ++h) {
          typename M::BFrag bf;
          wmma::load_matrix_sync(bf, tile + kk * L.ldw1 + (wc + 4 * h) * 16, L.ldw1);
          M::fix(bf);
#pragma unroll
          for (int i = 0; i < RW; ++i) wmma::mma_sync(hacc[i][h], a[i], bf, hacc[i][h]);
        }
      }
      if (r == nks - 1) {
        // bias + GELU, each warp on its own 16x16 blocks (staged through
        // hbuf: the fragment layout is opaque); the next iteration's barrier
        // publishes hts to fc2
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int h = 0; h < FC1_F; ++h) {
            const int m0 = (wr * RW + i) * 16, n0 = (wc + 4 * h) * 16;
            wmma::store_matrix_sync(hbuf + m0 * L.ldh + n0, hacc[i][h], L.ldh,
                                    wmma::mem_row_major);
            __syncwarp();
            const int n = n0 + (lane & 15);
            const bool in = j0 + n < 4 * C;
            const float bias = in ? b1[j0 + n] : 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int m = m0 + 2 * e + (lane >> 4);
              hts[m * L.ldt + n] = from_f<T>(in ? gelu_tanh(hbuf[m * L.ldh + n] + bias) : 0.f);
            }
          }
      }
    } else {
      // fc2: out[:, column slice s] += hidden chunk @ tile
      const int s = r - nks;
#pragma unroll
      for (int ss = 0; ss < (KMAX + FC2_F - 1) / FC2_F; ++ss) {
        if (ss == s) {
          for (int kk = 0; kk < NH; kk += M::K) {
            typename M::AFrag a[RW];
#pragma unroll
            for (int i = 0; i < RW; ++i) {
              wmma::load_matrix_sync(a[i], hts + (wr * RW + i) * 16 * L.ldt + kk, L.ldt);
              M::fix(a[i]);
            }
#pragma unroll
            for (int h = 0; h < FC2_F; ++h) {
              const int k = FC2_F * ss + h;
              if (k < KMAX && wc + 4 * k < nct) {
                typename M::BFrag bf;
                wmma::load_matrix_sync(bf, tile + kk * L.ldw2 + (wc + 4 * h) * 16, L.ldw2);
                M::fix(bf);
#pragma unroll
                for (int i = 0; i < RW; ++i) wmma::mma_sync(oacc[i][k], a[i], bf, oacc[i][k]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with z / the ring: stage the output in ys

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (wc + 4 * k < nct)
        wmma::store_matrix_sync(ys + (wr * RW + i) * 16 * L.ldy + (wc + 4 * k) * 16, oacc[i][k],
                                L.ldy, wmma::mem_row_major);
  __syncthreads();

  // ---- epilogue: residual in fp32, one write of the output ----
  constexpr int V = 16 / sizeof(T);
  const int cv = C / V;
  for (int i = tid; i < TM * cv; i += NTHREAD) {
    const int p = i / cv, c = (i % cv) * V;
    const int gh = h0 + p / TW, gw = w0 + p % TW;
    if (gh < H && gw < W) {
      const size_t off = (size_t(gh) * W + gw) * C + c;
      const uint4 xin = *reinterpret_cast<const uint4*>(xb + off);
      const T* xe = reinterpret_cast<const T*>(&xin);
      uint4 res;
      T* re = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < V; ++e)
        re[e] = from_f<T>(to_f(xe[e]) + (ys[p * L.ldy + c + e] + b2[c + e]));
      *reinterpret_cast<uint4*>(ob + off) = res;
    }
  }
}

template <typename K, bool SAVE>
int launch_k(const void* x, void* out, void* y, const float* dw, const float* dwb, const void* w1,
             const float* b1, const void* w2, const float* b2, int B, int H, int W, int C,
             float eps, cudaStream_t stream) {
  using T = typename K::T;
  const Layout<K> L(C);
  auto kern = cnb_forward_kernel<K, SAVE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L.total));
  if (e != cudaSuccess) return int(e);
  const long long tiles = (long long)B * ((H + K::TH - 1) / K::TH) * ((W + K::TW - 1) / K::TW);
  kern<<<unsigned(tiles), NTHREAD, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(y), dw, dwb,
      static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, H, W, C, eps);
  return int(cudaGetLastError());
}

// One instantiation per channel range: the most pixels per CTA whose output
// tile (TM x C fp32 in registers, KMAX >= C/64 column tiles per warp) and
// shared memory (< 227 KB) fit. On an H100 at the batch-16 640^2 bf16 stage
// shapes, TM = 128 / 64 / 64 / 32 cut the time per block by 15 / 26 / 28 / 0 %
// against TM = 32 everywhere; TM = 64 at C = 96 was 8 % slower than TM = 32.
template <typename T, bool SAVE>
int launch(const void* x, void* out, void* y, const float* dw, const float* dwb, const void* w1,
           const float* b1, const void* w2, const float* b2, int B, int H, int W, int C,
           float eps, cudaStream_t stream) {
#define CNB_LAUNCH(...) \
  launch_k<Cfg<T, __VA_ARGS__>, SAVE>(x, out, y, dw, dwb, w1, b1, w2, b2, B, H, W, C, eps, stream)
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

}  // extern "C"
