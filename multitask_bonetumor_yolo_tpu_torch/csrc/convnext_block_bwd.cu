// ConvNeXt block backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built with nvcc into a shared library, loaded with ctypes).
//
// Replaces the TPU kernel multitask_bonetumor_yolo_tpu/ops/pallas/
// convnext_block_bwd.py::_kernel_v2 (driven by fused_block_bwd_v2): from the
// block input x, the dwconv output y saved by the residual-saving forward
// (csrc/convnext_block.cu, SAVE) and the cotangent g, it computes dx and the
// fp32 gradients of the nine raw parameters. Math (per pixel, C channels,
// hidden width 4C; dt = compute dtype):
//
//   z   = (y - mean) * r,  r = rsqrt(max(E[y^2] - mean^2, 0) + eps)
//   h1  = dt(z) @ w1' + b1'                    w1' = ln_scale * w1 (folded)
//   d_a = dt(g) @ w2'^T                        w2' = w2 * gamma (folded)
//   d_h = d_a * gelu_tanh'(h1),  a = gelu_tanh(h1)
//   d_z2 = dt(d_h) @ dt(w1)^T,  d_z = ln_scale * d_z2
//   d_y = r * (d_z - mean(d_z) - z * mean(d_z * z))
//   dx  = corr7x7(d_y, flipped taps) + g
//   grads: W = dt(g)^T dt(a) [C, 4C];  dw2 = gamma * W;
//          dgamma = sum_j dt(w2) * W + b2 * sum g;  db2 = sum dt(g*gamma);
//          db1 = sum d_h; dw1 = dt(z*ln_scale + ln_bias)^T dt(d_h);
//          dln_scale = sum d_z2*z; dln_bias = sum d_z2; db_dw = sum d_y;
//          dtaps[i][j] = sum x[p + (i-3, j-3)] * d_y[p]
// (sums over all B*H*W pixels). The TPU kernel runs seven products: d_z
// through the folded w1', o = dt(a) @ dt(w2) + b2 for dgamma = sum g * o, and
// dw2 from dt(g * gamma). The derived forms above are the same function up
// to rounding (fp32 rounding in fp32; in bf16 the roundings of w1' and
// g * gamma move) and need five.
//
// What bounds it on an H100 (SXM datasheet: 989 TFLOP/s bf16 dense, 67
// TFLOP/s fp32 outside the tensor cores, 3.35 TB/s): five products of 8*C^2
// flop per pixel (h1, d_a, d_z2, dw1, W), 40*C^2 flop per pixel on the tensor
// cores; at batch 8 and 640^2 that is 8*H*W*C^2 = 1.89e9 times 40, ~75.5
// GFLOP per block at every stage (H*W*C^2 is the same at all four), ~0.076
// ms at peak. The two 7x7 passes (2 x 98*C flop per pixel on the fp32 cores,
// ~0.058 ms at stage 0) run on other units and can overlap them; the bytes
// it must move are x, y, g in and dx out (4 x 2*C per pixel in bf16, ~0.047
// ms at stage 0): bound by the products.
//
// What the design does about it, in bf16 up to C = 512 (namespace k2h, the
// Hopper pipeline; four launches, no atomics, the same bits every run):
//   1. row pass, one CTA (two warpgroups) per 64 pixels: y and g into
//      shared memory by cp.async, LN moments (four threads per pixel), dt(z)
//      and dt(g) as wgmma A tiles, and for each chunk of
//      NC hidden columns (w1'^T, w2' and w1^T chunks by cp.async, each load
//      overlapping the product that does not read it): h1 and d_a on wgmma
//      (each warpgroup half the chunk's columns), the GELU and its
//      derivative on the accumulator registers, dt(d_h) into shared memory
//      and, with dt(a), out to device memory once, transposed ([4C, P]);
//      d_z2 += dt(d_h) w1 on wgmma into a [64, C] fp32 accumulator split
//      over the two warpgroups by columns. Then d_z = ln_scale * d_z2 and
//      d_y (fp32 to device memory for the spatial pass), and the per-CTA
//      partials of dln_scale, dln_bias, db1, db2 and sum g. dt(z * ln_scale
//      + ln_bias) and dt(g) go out transposed ([C, P]) for the weight pass.
//      Shared memory: dt(z), dt(g) and three weight chunks, 211 KB at
//      C = 384 (NC = 32, one CTA per SM), 147 KB at C = 192 (NC = 64, one),
//      103 KB at C = 96 (NC = 64, two: 128 registers). At C = 512 the A
//      tiles alone take 128 KB and three 32-column weight chunks another
//      160 with their 128-byte rows: the split form (RowSmem::SPLIT) takes
//      16 hidden columns a chunk, warpgroup 0 computing h1 and warpgroup 1
//      d_a over all 16 (the 64 x 16 products each warpgroup runs at C = 384)
//      and trading them through shared memory for the GELU; w1^T's chunk in
//      the 32-byte swizzle (16 KB, where 128-byte rows would take 64); the
//      prologue's transposes in two slabs of 256 channels; 198 KiB, one CTA
//      per SM, 255 registers and no spills (ptxas, CUDA 12.8).
//   2. weight pass: dw1^T = z2d^T dt(d_h) and W = dt(g)^T dt(a), [C, 4C] over
//      K = the pixels, split-K into fp32 partials; one CTA (two warpgroups)
//      per 128 x 128 tile and slice, K-major tiles (the row pass wrote them
//      transposed, so no operand needs wgmma's transpose) through a 3-deep
//      cp.async ring, m64n64k16 products; W's CTAs also form dgamma's
//      partials, sum_j dt(w2) W over their columns.
//   3. spatial pass (cnb_bwd_spatial_kernel, the first design's): dx, and
//      the partials of the taps' and the dw bias' gradients from d_y.
//   4. one reduction launch over a table of segments, every sum in a fixed
//      order; it also forms dw2 = gamma * W, writes dw1 in the port's
//      [4C, C] and adds b2 * sum g to dgamma.
// d_h and a ([P, 4C] bf16, 157 MB each at stage 0) are written once and read
// once: keeping them on chip needs a per-CTA fp32 partial of a [4C, C]
// weight gradient (147 KB at C = 96, 2.4 MB at C = 384), more than an SM
// holds. Every operand tile is K-major in the 128-byte swizzle (wgmma.cuh).
//
// fp32, and bf16 wider than 512 (whose dt(z) and dt(g) tiles, 96 KB each at
// C = 768, do not fit beside the weight chunks), run the first design: wmma
// tensor-core products on 64 x 64 tiles, no TMA or wgmma, sixteen launches:
//   * prep (LN moments, the dt operands, db2), hidden (h1 and d_a for a
//     64-pixel x 64-hidden tile, GELU and its derivative in the epilogue,
//     db1), channel (d_z, d_z2 and o for a 64-pixel x 64-channel tile,
//     dgamma / dln_scale / dln_bias in the epilogue: the TPU kernel's seven
//     products), row (d_y from d_z), spatial, the two weight-gradient
//     products split-K over the pixels, and nine reductions, one per
//     gradient, each in a fixed order;
//   * its device-memory traffic is ~8 KB per pixel in bf16 (the [P, 4C]
//     dt(d_h) and dt(a) written once and read twice, d_z in fp32).

// Kernel K4, the recompute-form backward (cnb_backward_v1), is the same
// code under the template flag V1. It replaces the TPU kernel
// multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block_bwd.py::_kernel
// (driven by fused_block_bwd), which takes no saved y and whose math differs:
//
//   y   = dwconv7x7(x) + b_dw in fp32, recomputed, never rounded to dt
//   z2d = dt(z * ln_scale + ln_bias),  h1 = z2d @ dt(w1) + b1  (raw w1, no fold)
//   do  = g * gamma (fp32),  d_a = dt(do) @ dt(w2)^T
//   d_z2 = dt(d_h) @ dt(w1)^T,  d_z = d_z2 * ln_scale,  o = dt(a) @ dt(w2) + b2
//   db2 = sum do (fp32), the other grads, d_y, dx and the taps' gradient as above.
//
// The TPU kernel recomputes y per row chunk from a +-6-row x halo (and
// carries a +-3-row g halo) because its sequential grid sums the gradients
// chunk by chunk; on Hopper the CTAs run in parallel, so K4 recomputes y for
// the whole tensor first, into an fp32 workspace ([P, C], 78.6 MB at batch
// 8 and 160^2 x 96), with the depthwise kernel of csrc/dwconv.cuh (K3's
// device code, plus the bias). Its bound is K2's products plus a third 7x7
// pass (the recompute of y): at batch 8 the products still bound it.
//
// K4 in bf16 up to C = 384 (cnb_backward_v1_route: K2's rule stopped at
// Tiny's widths; the split row pass has no V1 form) is K2's Hopper
// pipeline under V1, five launches: the recompute, then K2's row pass with
// v1's operands (k2_row_kernel<CP, NC, true>: LN moments and z from the
// fp32 y, read from device memory by four threads per pixel and again for
// z, since an fp32 tile would double the 48 KB dt(z) tile at C = 384; the A
// tiles hold z2d and dt(g * gamma), the B slots the raw dt(w1), dt(w2)^T and
// b1; d_y and sum d_z2 z from the fp32 z, y read a third time), K2's weight
// pass, spatial pass and reduction unchanged. The row pass keeps K2's shared
// memory layout and CTAs per SM (cnb_backward_row_config on the H100: 2 /
// 2 / 1 / 1 CTAs per SM at CP = 48 / 96 / 192 / 384, a launch asking 67.5
// / 105.5 / 149.5 / 212 KiB). ptxas (sm_90a, CUDA 12.8): k2_row_kernel<CP,
// NC, true> takes 126 / 128 / 189 / 255 registers, no spills but 52 bytes
// at CP = 384 (the epilogue's fp32 y loads beside 96 d_z2 accumulators a
// thread; that pass is no slower than K2's, 0.474 against 0.476 ms at batch
// 8); K2's own row pass 123 / 128 / 205 / 254, no spills; no wgmma
// serialised (C7514). The reduction takes K2's derived forms, dw2 = gamma *
// (dt(g)^T dt(a)) and dgamma = sum_j dt(w2) W + b2 sum g, in place of v1's
// dt(do)^T dt(a) and sum g * o: the same function up to rounding. dw2
// scales the fp32 sum of dt(g) dt(a) by gamma where v1 rounds g * gamma to
// bf16 before the product; dgamma sums the same fp32 products dt(g) dt(a)
// dt(w2) in another order (over the pixels first). No atomics: the same
// bits every run.
// fp32, C = 768 and the "before" (cnb_backward_v1_v0) run the first design:
// prep reads the fp32 y; the hidden product takes z2d and dt(do) with the
// raw weights (the host passes them in the folded weights' slots); the
// channel product computes two products (d_z2, o) and d_z in its epilogue;
// d_y reads the fp32 y; sixteen launches and the recompute.

#include <type_traits>

#include "cuda_common.cuh"
#include "dwconv.cuh"
#include "wgmma.cuh"

namespace {

using namespace cnb;

constexpr int NT = 256;     // threads per CTA, every kernel here
constexpr int NWARP = NT / 32;
constexpr int MAXC = 768;
constexpr int MAXJ = MAXC / 32;  // channels per lane in the per-pixel passes
constexpr int BM = 64, BN = 64, BK = 32;  // product tiles
constexpr int PREP_PX = 64;  // pixels per prep CTA
constexpr int TH = 8, TW = 16, CC = 32;  // spatial pass: tile rows/cols, channel chunk
constexpr int HH = TH + 6, HW = TW + 6;  // spatial halo tile

__host__ __device__ constexpr int cdiv(long long a, long long b) { return int((a + b - 1) / b); }

// ---- prep: per pixel LN moments from y, the compute-dtype operands -------
// One warp per pixel, lanes over channels. Writes z (dt), z2 = dt(z * lns +
// lnb), do = dt(g * gamma), mean and r per pixel, and the CTA's partial of
// db2 = sum over its pixels of do. V1: y is the fp32 recompute (TY = float),
// z is not written (the hidden product takes z2) and db2 sums g * gamma
// before its rounding to dt.
template <typename T, typename TY, bool V1>
__global__ void __launch_bounds__(NT)
cnb_bwd_prep_kernel(const TY* __restrict__ y, const T* __restrict__ g, const float* __restrict__ lns,
                    const float* __restrict__ lnb, const float* __restrict__ gamma, T* __restrict__ zd,
                    T* __restrict__ z2d, T* __restrict__ dod, float* __restrict__ mean_o,
                    float* __restrict__ rstd_o, float* __restrict__ db2_part, int P, int C, float eps) {
  __shared__ float red[NWARP][MAXC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nj = (C + 31) / 32;
  const float inv_c = 1.0f / float(C);
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;
  for (int i = warp; i < PREP_PX; i += NWARP) {
    const int p = blockIdx.x * PREP_PX + i;
    if (p >= P) break;
    const size_t row = size_t(p) * C;
    float yv[MAXJ];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      yv[j] = (j < nj && c < C) ? to_f(y[row + c]) : 0.f;
      s += yv[j];
      s2 = fmaf(yv[j], yv[j], s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s * inv_c;
    const float r = rsqrtf(fmaxf(s2 * inv_c - mean * mean, 0.f) + eps);
    if (lane == 0) {
      mean_o[p] = mean;
      rstd_o[p] = r;
    }
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (j < nj && c < C) {
        const float z = (yv[j] - mean) * r;
        if (!V1) zd[row + c] = from_f<T>(z);
        z2d[row + c] = from_f<T>(z * lns[c] + lnb[c]);
        const float df = to_f(g[row + c]) * gamma[c];
        const T d = from_f<T>(df);
        dod[row + c] = d;
        acc[j] += V1 ? df : to_f(d);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int c = lane + 32 * j;
    if (j < nj && c < C) red[warp][c] = acc[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float t = 0.f;
    for (int w = 0; w < NWARP; ++w) t += red[w][c];  // fixed order
    db2_part[size_t(blockIdx.x) * C + c] = t;
  }
}

// ---- tiled products: acc_i[m][n] = sum_k A_i[m][k] * B_i[k][n] ----------
// NG products share the tile (m0, n0) and K. A_i is [M][K] row-major
// (A_T = false) or stored transposed as [K][M] (A_T = true, the weight
// gradients: A = a per-pixel tensor, K = pixels); B_i is [K][N] row-major.
// All of M (when A_T), N and K (when !A_T) are multiples of 16, and every
// row stride a multiple of 16 bytes; ragged edges are zero-filled.
// 8 warps as 2 (m) x 4 (n), a warp owns 32 x 16 of the 64 x 64 tile.
// The epilogue (EPI) reads the fp32 tiles from shared memory.
enum Epi { EPI_PARTIAL = 0, EPI_HIDDEN = 1, EPI_CHANNEL = 2, EPI_CHANNEL_V1 = 3 };

template <typename T, int NG>
struct GemmArgs {
  const T* a[NG];
  const T* b[NG];
  int lda, ldb;  // row strides of A (as stored) and B
  int M, N, K;
  int kslice;  // K per blockIdx.z slice (split-K), a multiple of BK
  // EPI_PARTIAL: out partial [gridDim.z][M][N]
  float* part;
  // EPI_HIDDEN (M = pixels, N = 4C): dhd, act [M][N] dt; b1 [N]; db1 partial [gridDim.x][N]
  T* dhd;
  T* act;
  const float* b1;
  float* db1_part;
  // EPI_CHANNEL (M = pixels, N = C): dz [M][N] fp32; y, g [M][N] dt; mean, rstd [M];
  // b2 [N]; partials [gridDim.x][N] of dgamma, dln_scale, dln_bias.
  // EPI_CHANNEL_V1: the same with yf [M][N] fp32 in place of y, and lns [N].
  float* dz;
  const T* y;
  const float* yf;
  const float* lns;
  const T* g;
  const float* mean;
  const float* rstd;
  const float* b2;
  float* dgam_part;
  float* dlns_part;
  float* dlnb_part;
};

template <typename T, bool A_T>
struct GemmLayout {
  static constexpr int PAD = Mma<T>::PAD;
  static constexpr int A_ROWS = A_T ? BK : BM, A_LD = (A_T ? BM : BK) + PAD;
  static constexpr int B_LD = BN + PAD;
  static constexpr size_t A_BYTES = align128(size_t(A_ROWS) * A_LD * sizeof(T));
  static constexpr size_t B_BYTES = align128(size_t(BK) * B_LD * sizeof(T));
  static constexpr int C_LD = BN + 4;
  static constexpr size_t C_BYTES = align128(size_t(BM) * C_LD * sizeof(float));
  template <int NG> __host__ __device__ static constexpr size_t stage_bytes() {
    return NG * (A_BYTES + B_BYTES);
  }
  // NC fp32 epilogue tiles (the channel epilogues sum three columns)
  template <int NG, int NC = NG> __host__ __device__ static constexpr size_t total() {
    return max_sz(2 * stage_bytes<NG>(), NC * C_BYTES);
  }
};

template <typename T, bool A_T, int NG>
__device__ __forceinline__ void gemm_load(const GemmArgs<T, NG>& g, unsigned char* stage, int m0,
                                          int n0, int k0, int kend) {
  using L = GemmLayout<T, A_T>;
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    T* as = reinterpret_cast<T*>(stage + q * (L::A_BYTES + L::B_BYTES));
    T* bs = reinterpret_cast<T*>(stage + q * (L::A_BYTES + L::B_BYTES) + L::A_BYTES);
    if constexpr (A_T) {  // tile [BK][BM] from A stored [K][M]
      constexpr int SEG = BM / V;
      for (int i = tid; i < BK * SEG; i += NT) {
        const int kk = i / SEG, mm = (i % SEG) * V;
        const bool in = k0 + kk < kend && m0 + mm < g.M;
        cp_async16_zfill(as + kk * L::A_LD + mm,
                         in ? g.a[q] + size_t(k0 + kk) * g.lda + m0 + mm : g.a[q], in);
      }
    } else {  // tile [BM][BK] from A [M][K]
      constexpr int SEG = BK / V;
      for (int i = tid; i < BM * SEG; i += NT) {
        const int mm = i / SEG, kk = (i % SEG) * V;
        const bool in = m0 + mm < g.M && k0 + kk < kend;
        cp_async16_zfill(as + mm * L::A_LD + kk,
                         in ? g.a[q] + size_t(m0 + mm) * g.lda + k0 + kk : g.a[q], in);
      }
    }
    constexpr int SEGB = BN / V;  // tile [BK][BN] from B [K][N]
    for (int i = tid; i < BK * SEGB; i += NT) {
      const int kk = i / SEGB, nn = (i % SEGB) * V;
      const bool in = k0 + kk < kend && n0 + nn < g.N;
      cp_async16_zfill(bs + kk * L::B_LD + nn,
                       in ? g.b[q] + size_t(k0 + kk) * g.ldb + n0 + nn : g.b[q], in);
    }
  }
}

template <typename T, bool A_T, int NG, int EPI>
__global__ void __launch_bounds__(NT) cnb_bwd_gemm_kernel(const GemmArgs<T, NG> g) {
  using L = GemmLayout<T, A_T>;
  using M = Mma<T>;
  using ALayout = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, M::K, typename M::In, ALayout>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile rows wm*32.., cols wn*16..
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * g.kslice;
  const int kend = min(g.K, kbeg + g.kslice);
  const int nk = kend > kbeg ? cdiv(kend - kbeg, BK) : 0;

  typename M::CFrag acc[NG][2];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[q][i], 0.f);

  constexpr size_t SB = L::template stage_bytes<NG>();
  if (nk > 0) gemm_load<T, A_T, NG>(g, smem, m0, n0, kbeg, kend);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) gemm_load<T, A_T, NG>(g, smem + ((t + 1) & 1) * SB, m0, n0, kbeg + (t + 1) * BK, kend);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* stage = smem + (t & 1) * SB;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const T* as = reinterpret_cast<const T*>(stage + q * (L::A_BYTES + L::B_BYTES));
      const T* bs = reinterpret_cast<const T*>(stage + q * (L::A_BYTES + L::B_BYTES) + L::A_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK; kk += M::K) {
        typename M::BFrag bf;
        wmma::load_matrix_sync(bf, bs + kk * L::B_LD + wn * 16, L::B_LD);
        M::fix(bf);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          AFrag af;
          const int mr = wm * 32 + i * 16;
          if constexpr (A_T)
            wmma::load_matrix_sync(af, as + kk * L::A_LD + mr, L::A_LD);
          else
            wmma::load_matrix_sync(af, as + mr * L::A_LD + kk, L::A_LD);
          M::fix(af);
          wmma::mma_sync(acc[q][i], af, bf, acc[q][i]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if constexpr (EPI == EPI_PARTIAL) {
    // M and N are multiples of 16: a fragment is wholly inside or outside
    float* out = g.part + size_t(blockIdx.z) * g.M * g.N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mr = m0 + wm * 32 + i * 16, nc = n0 + wn * 16;
      if (mr < g.M && nc < g.N)
        wmma::store_matrix_sync(out + size_t(mr) * g.N + nc, acc[0][i], g.N, wmma::mem_row_major);
    }
    return;
  } else {
    __syncthreads();  // every warp is done with the operand stages
    float* cs = reinterpret_cast<float*>(smem);  // NG tiles [BM][C_LD]
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(cs + q * (L::C_BYTES / 4) + (wm * 32 + i * 16) * L::C_LD + wn * 16,
                                acc[q][i], L::C_LD, wmma::mem_row_major);
    __syncthreads();
    float* c0s = cs;
    float* c1s = cs + L::C_BYTES / 4;
    float* c2s = cs + 2 * (L::C_BYTES / 4);
    for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
      const int mm = idx / BN, nn = idx % BN;
      const int m = m0 + mm, n = n0 + nn;
      const int o = mm * L::C_LD + nn;
      const bool in = m < g.M && n < g.N;
      if constexpr (EPI == EPI_HIDDEN) {
        // c0 = z @ w1' (h1 - b1'), c1 = d_a
        float dh = 0.f;
        if (in) {
          const float h = c0s[o] + g.b1[n];
          const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
          const float th = tanhf(u);
          const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * h * h);
          const float dgelu = 0.5f * (1.0f + th) + h * 0.5f * (1.0f - th * th) * du;
          dh = c1s[o] * dgelu;
          const size_t off = size_t(m) * g.N + n;
          g.dhd[off] = from_f<T>(dh);
          g.act[off] = from_f<T>(h * 0.5f * (1.0f + th));
        }
        c1s[o] = dh;
      } else {
        // EPI_CHANNEL: c0 = d_z, c1 = d_z2, c2 = a @ w2 (o - b2);
        // EPI_CHANNEL_V1: c0 = d_z2, c1 = a @ w2, and d_z = d_z2 * ln_scale
        constexpr bool V1 = EPI == EPI_CHANNEL_V1;
        float dgam = 0.f, dlns = 0.f, dlnb = 0.f;
        if (in) {
          const size_t off = size_t(m) * g.N + n;
          const float dz2 = V1 ? c0s[o] : c1s[o];
          const float ov = V1 ? c1s[o] : c2s[o];
          float yv;
          if constexpr (V1) {
            g.dz[off] = dz2 * g.lns[n];
            yv = g.yf[off];
          } else {
            g.dz[off] = c0s[o];
            yv = to_f(g.y[off]);
          }
          const float z = (yv - g.mean[m]) * g.rstd[m];
          dgam = to_f(g.g[off]) * (ov + g.b2[n]);
          dlns = dz2 * z;
          dlnb = dz2;
        }
        c0s[o] = dgam;
        c1s[o] = dlns;
        c2s[o] = dlnb;
      }
    }
    __syncthreads();
    // column sums over the tile's rows, in row order
    constexpr int NQ = EPI == EPI_HIDDEN ? 1 : 3;
    for (int i = threadIdx.x; i < NQ * BN; i += NT) {
      const int q = i / BN, nn = i % BN;
      const int n = n0 + nn;
      if (n >= g.N) continue;
      const float* src = EPI == EPI_HIDDEN ? c1s : cs + q * (L::C_BYTES / 4);
      float t = 0.f;
      for (int mm = 0; mm < BM; ++mm) t += src[mm * L::C_LD + nn];
      float* dst = EPI == EPI_HIDDEN ? g.db1_part : (q == 0 ? g.dgam_part : q == 1 ? g.dlns_part : g.dlnb_part);
      dst[size_t(blockIdx.x) * g.N + n] = t;
    }
  }
}

// ---- row pass: d_y = r * (d_z - mean(d_z) - z * mean(d_z * z)), in place --
// (y in the compute dtype for K2, the fp32 recompute for V1)
template <typename TY>
__global__ void __launch_bounds__(NT)
cnb_bwd_dy_kernel(float* __restrict__ dz, const TY* __restrict__ y, const float* __restrict__ mean,
                  const float* __restrict__ rstd, int P, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * NWARP + warp;
  if (p >= P) return;
  const size_t row = size_t(p) * C;
  const float mu = mean[p], r = rstd[p];
  const int nj = (C + 31) / 32;
  float dv[MAXJ], zv[MAXJ];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int c = lane + 32 * j;
    const bool in = j < nj && c < C;
    dv[j] = in ? dz[row + c] : 0.f;
    zv[j] = in ? (to_f(y[row + c]) - mu) * r : 0.f;
    s1 += dv[j];
    s2 = fmaf(dv[j], zv[j], s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float m1 = s1 / float(C), m2 = s2 / float(C);
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int c = lane + 32 * j;
    if (j < nj && c < C) dz[row + c] = r * (dv[j] - m1 - zv[j] * m2);
  }
}

// ---- spatial pass: dx, and partials of the tap and dw-bias gradients ------
// CTA (chunk k = blockIdx.y, slice s = blockIdx.x) walks the TH x TW tiles
// t = s, s + gridDim.x, ... for channels k*CC .. k*CC + CC-1, keeping its
// 49 tap sums per thread in registers; thread (row r = tid / 32, channel
// lane) owns one tile row of TW pixels. Halo tiles of d_y (fp32) and x
// (zero outside the image: SAME padding) in shared memory.
struct SpatialSmem {
  float dy[HH * HW * CC];
  float x[HH * HW * CC];
  float taps[49 * CC];
};

template <typename T>
__global__ void __launch_bounds__(NT)
cnb_bwd_spatial_kernel(const float* __restrict__ dyg, const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ taps, T* __restrict__ dx, float* __restrict__ ddw_part,
                       float* __restrict__ ddwb_part, int B, int H, int W, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SpatialSmem& S = *reinterpret_cast<SpatialSmem*>(smem_raw);
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * CC;
  const int c = c0 + lane;
  const int tiles_w = cdiv(W, TW), tiles_h = cdiv(H, TH);
  const int ntiles = B * tiles_h * tiles_w;
  for (int i = threadIdx.x; i < 49 * CC; i += NT) {
    const int cc = c0 + i % CC;
    S.taps[i] = cc < C ? taps[(i / CC) * C + cc] : 0.f;
  }
  float accw[49];
#pragma unroll
  for (int i = 0; i < 49; ++i) accw[i] = 0.f;
  float accb = 0.f;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int w0 = (t % tiles_w) * TW;
    const int h0 = ((t / tiles_w) % tiles_h) * TH;
    const int b = t / (tiles_w * tiles_h);
    const size_t img = size_t(b) * H * W;
    __syncthreads();  // the previous tile's halo is consumed (and taps written)
    for (int i = threadIdx.x; i < HH * HW * CC; i += NT) {
      const int cc = i % CC, pix = i / CC;
      const int gh = h0 - 3 + pix / HW, gw = w0 - 3 + pix % HW;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + cc < C;
      const size_t off = (img + size_t(gh) * W + gw) * C + c0 + cc;
      S.dy[i] = in ? dyg[off] : 0.f;
      S.x[i] = in ? to_f(x[off]) : 0.f;
    }
    __syncthreads();
    float dyc[TW];
#pragma unroll
    for (int o = 0; o < TW; ++o) dyc[o] = S.dy[((r + 3) * HW + o + 3) * CC + lane];
    float dxa[TW];
#pragma unroll
    for (int o = 0; o < TW; ++o) dxa[o] = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float dyr[HW], xr[HW];
#pragma unroll
      for (int j = 0; j < HW; ++j) {
        dyr[j] = S.dy[((r + i) * HW + j) * CC + lane];
        xr[j] = S.x[((r + i) * HW + j) * CC + lane];
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        // dx: d_y at offset (i-3, j-3) times the flipped tap (6-i, 6-j)
        const float wf = S.taps[((6 - i) * 7 + 6 - j) * CC + lane];
        float sw = 0.f;
#pragma unroll
        for (int o = 0; o < TW; ++o) {
          dxa[o] = fmaf(dyr[o + j], wf, dxa[o]);
          sw = fmaf(xr[o + j], dyc[o], sw);
        }
        accw[i * 7 + j] += sw;
      }
    }
#pragma unroll
    for (int o = 0; o < TW; ++o) accb += dyc[o];
    const int gh = h0 + r;
    if (c < C && gh < H) {
#pragma unroll
      for (int o = 0; o < TW; ++o) {
        const int gw = w0 + o;
        if (gw < W) {
          const size_t off = (img + size_t(gh) * W + gw) * C + c;
          dx[off] = from_f<T>(dxa[o] + to_f(g[off]));
        }
      }
    }
  }
  // reduce the 8 rows' partials in a fixed order (the halo buffers are free)
  __syncthreads();
  float* red = S.dy;  // [NWARP][50][CC]
#pragma unroll
  for (int i = 0; i < 49; ++i) red[(r * 50 + i) * CC + lane] = accw[i];
  red[(r * 50 + 49) * CC + lane] = accb;
  __syncthreads();
  for (int i = threadIdx.x; i < 50 * CC; i += NT) {
    const int cc = c0 + i % CC, tap = i / CC;
    if (cc >= C) continue;
    float t = 0.f;
    for (int w = 0; w < NWARP; ++w) t += red[(w * 50 + tap) * CC + i % CC];
    if (tap < 49)
      ddw_part[(size_t(blockIdx.x) * 49 + tap) * C + cc] = t;
    else
      ddwb_part[size_t(blockIdx.x) * C + cc] = t;
  }
}

// ---- fixed-order reduction: out[n] = sum_s part[s][n] ---------------------
// 32 columns per CTA; 8 thread rows take every 8th s, then row 0 adds the 8
// row sums in order: deterministic.
__global__ void __launch_bounds__(NT)
cnb_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int S, long long N) {
  __shared__ float red[NWARP][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long n = (long long)blockIdx.x * 32 + tx;
  float t = 0.f;
  if (n < N)
    for (int s = ty; s < S; s += NWARP) t += part[s * N + n];
  red[ty][tx] = t;
  __syncthreads();
  if (ty == 0 && n < N) {
    float u = 0.f;
    for (int w = 0; w < NWARP; ++w) u += red[w][tx];
    out[n] = u;
  }
}

// ---- workspace and launch sequence ---------------------------------------
struct Plan {
  int P, C, nprep, nmt, S1, S2, k1, k2, nsl, nch;
  size_t off[17];
  size_t total;
};

// Split-K slices for a [M][N] weight gradient over P pixels: about four
// waves of the 132 SMs, at least 256 pixels per slice.
inline void split_k(int P, int M, int N, int* S, int* kslice) {
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  int s = cdiv(4 * 132, tiles);
  s = max(1, min(s, cdiv(P, 256)));
  *kslice = cdiv(cdiv(P, s), BK) * BK;
  *S = cdiv(P, *kslice);
}

template <typename T>
Plan make_plan(int B, int H, int W, int C, bool v1) {
  Plan pl{};
  pl.P = B * H * W;
  pl.C = C;
  pl.nprep = cdiv(pl.P, PREP_PX);
  pl.nmt = cdiv(pl.P, BM);
  split_k(pl.P, 4 * C, C, &pl.S1, &pl.k1);
  split_k(pl.P, C, 4 * C, &pl.S2, &pl.k2);
  pl.nch = cdiv(C, CC);
  const int ntiles = B * cdiv(H, TH) * cdiv(W, TW);
  pl.nsl = max(1, min(ntiles, cdiv(4 * 132, pl.nch)));
  const size_t P = pl.P, c = C, f = sizeof(float), t = sizeof(T);
  const size_t sizes[17] = {
      v1 ? 0 : P * c * t,  // 0 z (dt; K2 only)
      P * c * t,          // 1 z2 = z * lns + lnb (dt)
      P * c * t,          // 2 do = g * gamma (dt)
      P * 4 * c * t,      // 3 d_h (dt)
      P * 4 * c * t,      // 4 a = gelu(h1) (dt)
      P * f,              // 5 mean
      P * f,              // 6 rstd
      P * c * f,          // 7 d_z, then d_y (fp32)
      size_t(pl.nprep) * c * f,     // 8 db2 partials
      size_t(pl.nmt) * 4 * c * f,   // 9 db1 partials
      size_t(pl.nmt) * c * f,       // 10 dgamma partials
      size_t(pl.nmt) * c * f,       // 11 dln_scale partials
      size_t(pl.nmt) * c * f,       // 12 dln_bias partials
      size_t(pl.nsl) * 49 * c * f,  // 13 tap partials
      size_t(pl.nsl) * c * f,       // 14 dw-bias partials
      size_t(max(pl.S1, pl.S2)) * 4 * c * c * f,  // 15 weight-gradient partials (reused)
      v1 ? P * c * f : 0,  // 16 y recomputed (fp32; V1 only)
  };
  size_t o = 0;
  for (int i = 0; i < 17; ++i) {
    pl.off[i] = o;
    o += align128(sizes[i]);
  }
  pl.total = o;
  return pl;
}

inline int reduce(const float* part, float* out, int S, long long N, cudaStream_t s) {
  cnb_bwd_reduce_kernel<<<unsigned(cdiv(N, 32)), NT, 0, s>>>(part, out, S, N);
          return int(cudaGetLastError());
}

template <typename T, bool A_T, int NG, int EPI>
int launch_gemm(const GemmArgs<T, NG>& ga, dim3 grid, cudaStream_t s) {
  constexpr int NC = EPI == EPI_CHANNEL_V1 ? 3 : NG;
  const size_t bytes = GemmLayout<T, A_T>::template total<NG, NC>();
  auto kern = cnb_bwd_gemm_kernel<T, A_T, NG, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  kern<<<grid, NT, bytes, s>>>(ga);
  return int(cudaGetLastError());
}

// p: x, y, g, taps [49][C], w1f [C][4C], w2fT [C][4C], w1fT [4C][C],
//    w1 [4C][C], w2t [4C][C], b1f [4C], b2 [C], gamma [C], lns [C], lnb [C],
//    then the outputs dx, ddw [49][C], ddwb, dlns, dlnb, dw1 [4C][C], db1,
//    dw2 [C][4C], db2, dgam.
// V1 (K4) reads the same slots with y unused, dt(w1)^T [C][4C] in w1f's,
// dt(w2) [C][4C] in w2fT's, w1fT's unused and the raw b1 in b1f's, and a
// 25th pointer, the dw bias [C].
template <typename T, bool V1>
int backward(const void* const* p, void* ws, int B, int H, int W, int C, float eps,
             cudaStream_t s) {
  const Plan pl = make_plan<T>(B, H, W, C, V1);
  const int P = pl.P;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto inf = [&](int i) { return static_cast<const float*>(p[i]); };
  auto outf = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto wt = [&](int i) { return reinterpret_cast<T*>(w + pl.off[i]); };
  auto wf = [&](int i) { return reinterpret_cast<float*>(w + pl.off[i]); };
  const T *x = in(0), *y = in(1), *g = in(2);
  T* dx = static_cast<T*>(const_cast<void*>(p[14]));
  int rc;

  if constexpr (V1) {  // y = dwconv7x7(x) + b_dw in fp32
    if ((rc = dwc::dwconv7_launch<T>(x, inf(3), inf(24), wf(16), B, H, W, C, s))) return rc;
    cnb_bwd_prep_kernel<T, float, true><<<pl.nprep, NT, 0, s>>>(
        wf(16), g, inf(12), inf(13), inf(11), wt(0), wt(1), wt(2), wf(5), wf(6), wf(8), P, C, eps);
  } else {
    cnb_bwd_prep_kernel<T, T, false><<<pl.nprep, NT, 0, s>>>(
        y, g, inf(12), inf(13), inf(11), wt(0), wt(1), wt(2), wf(5), wf(6), wf(8), P, C, eps);
  }
  if ((rc = int(cudaGetLastError()))) return rc;

  GemmArgs<T, 2> hid{};  // h1 and d_a for (pixels x hidden) tiles
  hid.a[0] = V1 ? wt(1) : wt(0); hid.b[0] = in(4);
  hid.a[1] = V1 ? wt(2) : g;     hid.b[1] = in(5);
  hid.lda = C; hid.ldb = 4 * C; hid.M = P; hid.N = 4 * C; hid.K = C; hid.kslice = C;
  hid.dhd = wt(3); hid.act = wt(4); hid.b1 = inf(9); hid.db1_part = wf(9);
  if ((rc = launch_gemm<T, false, 2, EPI_HIDDEN>(hid, dim3(pl.nmt, cdiv(4 * C, BN), 1), s))) return rc;

  if constexpr (V1) {
    GemmArgs<T, 2> chn{};  // d_z2 and o for (pixels x channel) tiles; d_z = d_z2 * lns
    chn.a[0] = wt(3); chn.b[0] = in(7);
    chn.a[1] = wt(4); chn.b[1] = in(8);
    chn.lda = 4 * C; chn.ldb = C; chn.M = P; chn.N = C; chn.K = 4 * C; chn.kslice = 4 * C;
    chn.dz = wf(7); chn.yf = wf(16); chn.lns = inf(12); chn.g = g; chn.mean = wf(5);
    chn.rstd = wf(6); chn.b2 = inf(10);
    chn.dgam_part = wf(10); chn.dlns_part = wf(11); chn.dlnb_part = wf(12);
    if ((rc = launch_gemm<T, false, 2, EPI_CHANNEL_V1>(chn, dim3(pl.nmt, cdiv(C, BN), 1), s))) return rc;
    cnb_bwd_dy_kernel<float><<<cdiv(P, NWARP), NT, 0, s>>>(wf(7), wf(16), wf(5), wf(6), P, C);
  } else {
    GemmArgs<T, 3> chn{};  // d_z, d_z2 and o for (pixels x channel) tiles
    chn.a[0] = wt(3); chn.b[0] = in(6);
    chn.a[1] = wt(3); chn.b[1] = in(7);
    chn.a[2] = wt(4); chn.b[2] = in(8);
    chn.lda = 4 * C; chn.ldb = C; chn.M = P; chn.N = C; chn.K = 4 * C; chn.kslice = 4 * C;
    chn.dz = wf(7); chn.y = y; chn.g = g; chn.mean = wf(5); chn.rstd = wf(6); chn.b2 = inf(10);
    chn.dgam_part = wf(10); chn.dlns_part = wf(11); chn.dlnb_part = wf(12);
    if ((rc = launch_gemm<T, false, 3, EPI_CHANNEL>(chn, dim3(pl.nmt, cdiv(C, BN), 1), s))) return rc;
    cnb_bwd_dy_kernel<T><<<cdiv(P, NWARP), NT, 0, s>>>(wf(7), y, wf(5), wf(6), P, C);
  }
  if ((rc = int(cudaGetLastError()))) return rc;

  {
    auto kern = cnb_bwd_spatial_kernel<T>;
    const int bytes = int(sizeof(SpatialSmem));
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return int(e);
    kern<<<dim3(pl.nsl, pl.nch), NT, bytes, s>>>(wf(7), x, g, inf(3), dx, wf(13), wf(14), B, H, W, C);
    if ((rc = int(cudaGetLastError()))) return rc;
  }

  // weight gradients, split-K over the pixels: dw1 [4C][C] = d_h^T z2,
  // dw2 [C][4C] = do^T a
  GemmArgs<T, 1> wg{};
  wg.a[0] = wt(3); wg.b[0] = wt(1);
  wg.lda = 4 * C; wg.ldb = C; wg.M = 4 * C; wg.N = C; wg.K = P; wg.kslice = pl.k1; wg.part = wf(15);
  if ((rc = launch_gemm<T, true, 1, EPI_PARTIAL>(wg, dim3(cdiv(4 * C, BM), cdiv(C, BN), pl.S1), s))) return rc;
  if ((rc = reduce(wf(15), outf(19), pl.S1, 4LL * C * C, s))) return rc;
  wg.a[0] = wt(2); wg.b[0] = wt(4);
  wg.lda = C; wg.ldb = 4 * C; wg.M = C; wg.N = 4 * C; wg.kslice = pl.k2;
  if ((rc = launch_gemm<T, true, 1, EPI_PARTIAL>(wg, dim3(cdiv(C, BM), cdiv(4 * C, BN), pl.S2), s))) return rc;
  if ((rc = reduce(wf(15), outf(21), pl.S2, 4LL * C * C, s))) return rc;

  if ((rc = reduce(wf(13), outf(15), pl.nsl, 49LL * C, s))) return rc;   // taps
  if ((rc = reduce(wf(14), outf(16), pl.nsl, C, s))) return rc;          // dw bias
  if ((rc = reduce(wf(11), outf(17), pl.nmt, C, s))) return rc;          // ln scale
  if ((rc = reduce(wf(12), outf(18), pl.nmt, C, s))) return rc;          // ln bias
  if ((rc = reduce(wf(9), outf(20), pl.nmt, 4LL * C, s))) return rc;     // b1
  if ((rc = reduce(wf(8), outf(22), pl.nprep, C, s))) return rc;         // b2
  return reduce(wf(10), outf(23), pl.nmt, C, s);                        // gamma
}

// ===========================================================================
// K2 in bf16 on Hopper (C <= 512): four launches, the products on wgmma.
// ===========================================================================
namespace k2h {

using bf16 = __nv_bfloat16;
constexpr int TM = 64;       // pixels per row-pass CTA: wgmma's M
constexpr int RT = 256;      // row-pass threads: two warpgroups
constexpr int WT = 256;      // weight-pass threads: two warpgroups
constexpr int WM = 128;      // weight-pass tile: 128 x 128, 64 rows per warpgroup
constexpr int WK = 64;       // weight-pass K (pixels) per stage
constexpr int WST = 3;       // weight-pass stages in the ring
constexpr int HMAXC = 512;   // widest C the row pass holds on chip
constexpr int V1_HMAXC = 384;  // K4's (V1) widest: its row pass stops at Tiny's widths
constexpr size_t WTILE = size_t(WM) * 128;  // one 128-row x 64-column bf16 tile
constexpr int SST = TM + 8;  // row stride of the transposed d_h / a staging: no bank conflicts

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// ---- row pass -------------------------------------------------------------
struct RowArgs {
  const bf16 *y, *g, *w1ft, *w2f, *w1t;  // [P,C], [P,C], [4C,C], [4C,C], [C,4C]
  const float* yf;                       // V1: the recomputed y [P,C] fp32 (y unused)
  const float *b1f, *gamma, *lns, *lnb;
  bf16 *dhT, *aT, *z2T, *gT;  // [4C,Pp], [4C,Pp], [C,Pp], [C,Pp]
  float* dy;                  // [P,C]
  float *db1p, *db2p, *sgp, *dlnsp, *dlnbp;  // [tiles,4C], [tiles,C] x 4
  int P, Pp, C;
  float eps;
};

// Shared memory of the row pass for channel capacity CP and hidden chunk NC.
// SPLIT (CP = 512, where this layout at NC = 32 would take 275 KB, and 227
// fit): NC = 16; warpgroup 0 computes h1 and warpgroup 1 d_a, each over the
// chunk's 16 columns (the 64 x 16 products that NC = 32 gives each
// warpgroup by columns), and they trade the products through XCH; the w1^T
// chunk [CP, 16] in the 32-byte swizzle (16 KB, where 128-byte rows take 64);
// the prologue stages its transposes in two slabs of channels. 198 KiB.
template <int CP, int NC>
struct RowSmem {
  static constexpr bool SPLIT = CP > 384;
  static constexpr int KB = (CP + 63) / 64;  // 64-column blocks of C
  static constexpr int SLAB = SPLIT ? CP / 2 : CP;  // channels per prologue staging
  static constexpr size_t Z = 0;                            // dt(z)  [64 px, CP] A operand
  static constexpr size_t G = Z + size_t(KB) * TM * 128;   // dt(g)  [64 px, CP] A operand
  static constexpr size_t W1 = G + size_t(KB) * TM * 128;  // w1'^T chunk [NC, CP] B operand
  static constexpr size_t W2 = W1 + size_t(KB) * NC * 128; // w2' chunk   [NC, CP] B operand
  static constexpr size_t W1T = W2 + size_t(KB) * NC * 128; // w1^T chunk [CP, NC] B operand
  static constexpr size_t DH = W1T + size_t(CP) * (SPLIT ? 32 : 128);  // dt(d_h) [64 px, NC] A
  static constexpr size_t ST = DH + size_t(TM) * 128;      // dt(d_h)^T, dt(a)^T [2][NC][SST]
  static constexpr size_t XCH = ST + size_t(2) * NC * SST * 2;  // SPLIT: h1, d_a [2][128][8]
  static constexpr size_t MEAN = XCH + (SPLIT ? 2 * 128 * 8 * 4 : 0);  // mean, rstd [64] each
  static constexpr size_t DB1 = MEAN + 2 * TM * 4;         // db1 per warp [4][NC]
  static constexpr size_t ROWS = DB1 + 4 * NC * 4;         // row sums [2 wg][64][2]
  static constexpr size_t BYTES = ROWS + 2 * TM * 2 * 4;
  // the prologue stages dt(z * lns + lnb)^T and dt(g)^T [SLAB][64] from W1
  // (before the moments), the epilogue the column partials [2 wg][4 warps][CP/2][2]
  static_assert(W1 + 2 * size_t(SLAB) * TM * 2 <= (SPLIT ? MEAN : DH),
                "prologue staging overflows");
  static_assert(W1 + size_t(2) * 4 * (CP / 2) * 2 * 4 <= DH, "epilogue staging overflows");
  static_assert(!SPLIT || NC == 16, "the split form's chunk is one k16 step of w1^T");
};

// y at pixel p0 + m, channels c0 .. c0 + 7 (C > c0), as fp32: K2 from the
// bf16 tile `ys` (zero past P), V1 from the fp32 y in device memory
template <bool V1>
__device__ __forceinline__ void y_chunk(const RowArgs& a, const unsigned char* ys, int p0, int m,
                                        int c0, float (&e)[8]) {
  if constexpr (V1) {
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (p0 + m < a.P) {
      const float4* src = reinterpret_cast<const float4*>(a.yf + size_t(p0 + m) * a.C + c0);
      v0 = __ldg(src);
      v1 = __ldg(src + 1);
    }
    e[0] = v0.x; e[1] = v0.y; e[2] = v0.z; e[3] = v0.w;
    e[4] = v1.x; e[5] = v1.y; e[6] = v1.z; e[7] = v1.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(ys + sm90::swz(TM, m, c0));
    const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = bf(b[i]);
  }
}

template <int CP, int NC>
__device__ __forceinline__ void row_load_hidden(const RowArgs& a, unsigned char* S, int j0) {
  using L = RowSmem<CP, NC>;
  constexpr int CH = CP / 8;  // 16-byte chunks of a row of C
  for (int i = threadIdx.x; i < 2 * NC * CH; i += RT) {
    const int which = i / (NC * CH), n = (i / CH) % NC, ch = i % CH;
    const bool in = ch * 8 < a.C;
    const bf16* src = (which ? a.w2f : a.w1ft) + size_t(j0 + n) * a.C + ch * 8;
    cp_async16_zfill(S + (which ? L::W2 : L::W1) + sm90::swz(NC, n, ch * 8), in ? src : a.w1ft, in);
  }
}

template <int CP, int NC>
__device__ __forceinline__ void row_load_dz2(const RowArgs& a, unsigned char* S, int j0) {
  using L = RowSmem<CP, NC>;
  constexpr int CH = NC / 8;
  for (int i = threadIdx.x; i < CP * CH; i += RT) {
    const int c = i / CH, ch = i % CH;
    const bool in = c < a.C;
    const bf16* src = a.w1t + size_t(c) * 4 * a.C + j0 + ch * 8;
    const int off = L::SPLIT ? sm90::swz32(c, ch * 8) : sm90::swz(CP, c, ch * 8);
    cp_async16_zfill(S + L::W1T + off, in ? src : a.w1t, in);
  }
}

// One CTA per 64 pixels: LN moments; dt(z), dt(g) into shared memory; then
// for each chunk of NC hidden columns h1 = dt(z) w1' + b1' and d_a = dt(g)
// w2'^T (warpgroup wg takes columns wg*NC/2..), GELU and its derivative on
// the accumulators, dt(d_h) and dt(a) written transposed once, the db1
// partial, and d_z2 += dt(d_h) w1 into a [64, CP] fp32 accumulator split
// over the two warpgroups by columns; last d_z = lns * d_z2, d_y and the
// column partials of the LN gradients. CP >= C is the instantiation's
// width (channels past C are zero). The parameter vectors are read through
// __ldg: read-only, so the compiler may keep those loads in flight across
// the shared-memory stores.
// V1 (K4) differs only where v1's math does: the moments and z come from the
// fp32 y in device memory (read three times: the moments, z, the epilogue;
// the second and third reads find it in L2), the A tiles hold z2d = dt(z *
// lns + lnb) and dt(g * gamma) (the host passes dt(w1), dt(w2)^T and b1 in
// the slots of w1'^T, w2' and b1'), g stays dt(g) for the weight pass, and
// db2 sums g * gamma before its rounding.
template <int CP, int NC, bool V1>
__global__ void __launch_bounds__(RT, CP <= 96 ? 2 : 1) k2_row_kernel(const RowArgs a) {
  using L = RowSmem<CP, NC>;
  constexpr int NH = NC / 2, ND = CP / 2, KS = CP / 16, KD = NC / 16, CH = CP / 8;
  extern __shared__ unsigned char k2h_smem[];
  unsigned char* S = sm90::smem_base(k2h_smem);
  float* s_mean = reinterpret_cast<float*>(S + L::MEAN);
  float* s_rstd = s_mean + TM;
  float* s_db1 = reinterpret_cast<float*>(S + L::DB1);
  float* s_rows = reinterpret_cast<float*>(S + L::ROWS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wi = warp & 3;  // warpgroup, warp in it
  const int C = a.C, P = a.P, tile = blockIdx.x, p0 = tile * TM;
  const int C4 = 4 * C;

  // y and g of the tile into the two A tiles by cp.async (zero past P and
  // past C); g stays there, y becomes dt(z) in place. V1: g only.
  for (int i = tid; i < (V1 ? 1 : 2) * TM * CH; i += RT) {
    const int which = V1 ? 1 : i / (TM * CH), m = (i / CH) % TM, c0 = (i % CH) * 8, p = p0 + m;
    const bool in = p < P && c0 < C;
    const bf16* src = (which ? a.g : a.y) + size_t(p) * C + c0;
    cp_async16_zfill(S + (which ? L::G : L::Z) + sm90::swz(TM, m, c0), in ? src : a.g, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // LN moments: four threads per pixel, each over every fourth 8-channel chunk
  {
    static_assert(RT == 4 * TM, "four threads per pixel");
    const int m = tid >> 2, part = tid & 3;
    float s = 0.f, s2 = 0.f;
    for (int ch = part; ch < C / 8; ch += 4) {
      float e[8];
      y_chunk<V1>(a, S + L::Z, p0, m, ch * 8, e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += e[i];
        s2 = fmaf(e[i], e[i], s2);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (part == 0) {
      const bool in = p0 + m < P;
      const float mean = s / float(C);
      s_mean[m] = in ? mean : 0.f;
      s_rstd[m] = in ? rsqrtf(fmaxf(s2 / float(C) - mean * mean, 0.f) + a.eps) : 0.f;
    }
  }
  __syncthreads();

  // dt(z) in place; the weight pass's dt(z * lns + lnb)^T and dt(g)^T
  // staged [SLAB][64], slab by slab of channels (one slab but at CP = 512)
  bf16* st_z2 = reinterpret_cast<bf16*>(S + L::W1);
  bf16* st_g = st_z2 + size_t(L::SLAB) * TM;
  for (int cs = 0; cs < CP; cs += L::SLAB) {
    const int ns = max(0, min(C - cs, L::SLAB));  // channels of this slab below C
    for (int i = tid; i < TM * (L::SLAB / 8); i += RT) {  // lanes along the pixels: no bank conflicts
      const int m = i % TM, c0 = cs + (i / TM) * 8;
      uint4* zp = reinterpret_cast<uint4*>(S + L::Z + sm90::swz(TM, m, c0));
      if (c0 >= C) {  // zero already (V1 loaded no y into the tile)
        if constexpr (V1) *zp = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      uint4* gp = reinterpret_cast<uint4*>(S + L::G + sm90::swz(TM, m, c0));
      const uint4 gv = *gp;
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      float yv[8];
      y_chunk<V1>(a, S + L::Z, p0, m, c0, yv);
      uint4 zv, dv;
      bf16* ze = reinterpret_cast<bf16*>(&zv);
      bf16* de = reinterpret_cast<bf16*>(&dv);
      const bool in = p0 + m < P;
      const float mu = s_mean[m], r = s_rstd[m];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + e;
        const float z = in ? (yv[e] - mu) * r : 0.f;
        const bf16 z2 = __float2bfloat16(in ? z * __ldg(a.lns + c) + __ldg(a.lnb + c) : 0.f);
        ze[e] = V1 ? z2 : __float2bfloat16(z);
        st_z2[(c - cs) * TM + m] = z2;
        st_g[(c - cs) * TM + m] = ge[e];
        if constexpr (V1) de[e] = __float2bfloat16(bf(ge[e]) * __ldg(a.gamma + c));
      }
      *zp = zv;
      if constexpr (V1) *gp = dv;  // d_a's operand dt(g * gamma); st_g keeps dt(g)
    }
    __syncthreads();
    for (int i = tid; i < 2 * ns * 8; i += RT) {
      const int which = i / (ns * 8), c = (i / 8) % ns, q = i % 8;
      const uint4 v = *reinterpret_cast<const uint4*>((which ? st_g : st_z2) + c * TM + q * 8);
      *reinterpret_cast<uint4*>((which ? a.gT : a.z2T) + size_t(cs + c) * a.Pp + p0 + q * 8) = v;
    }
    for (int cl = warp; cl < ns; cl += RT / 32) {  // db2 = sum dt(g * gamma) (V1: sum g * gamma), and sum g
      const int c = cs + cl;
      const float gm = __ldg(a.gamma + c);
      const float g0 = bf(st_g[cl * TM + lane]), g1 = bf(st_g[cl * TM + lane + 32]);
      float s_g = g0 + g1;
      float s_do = V1 ? g0 * gm + g1 * gm
                      : bf(__float2bfloat16(g0 * gm)) + bf(__float2bfloat16(g1 * gm));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s_g += __shfl_xor_sync(0xffffffffu, s_g, o);
        s_do += __shfl_xor_sync(0xffffffffu, s_do, o);
      }
      if (lane == 0) {
        a.db2p[size_t(tile) * C + c] = s_do;
        a.sgp[size_t(tile) * C + c] = s_g;
      }
    }
    if (cs + L::SLAB < CP) __syncthreads();  // the staging is free for the next slab
  }
  sm90::fence_proxy();  // the A tiles, written by st.shared, are read by wgmma
  __syncthreads();      // the staging is consumed: the weight tiles may land

  const int nchunk = C4 / NC;
  row_load_hidden<CP, NC>(a, S, 0);
  cp_async_commit();
  row_load_dz2<CP, NC>(a, S, 0);
  cp_async_commit();

  float acc[ND / 2];
#pragma unroll
  for (int i = 0; i < ND / 2; ++i) acc[i] = 0.f;
  const int row0 = 16 * wi + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);         // and columns 8 i + col0 (+1)

  for (int k = 0; k < nchunk; ++k) {
    const int j0 = k * NC;
    cp_async_wait<1>();  // this chunk's w1'^T and w2' (its w1^T may be in flight)
    sm90::fence_proxy();
    __syncthreads();
    float hacc[NH / 2], dacc[NH / 2];
    if constexpr (L::SPLIT) {
      // warpgroup 0: h1 = dt(z) w1', warpgroup 1: d_a = dt(g) w2'^T, over all
      // NC columns; then each takes both at columns wg * NH .. from XCH
      float pacc[NC / 2];
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) pacc[i] = 0.f;
      const unsigned char* pa = S + (wg ? L::G : L::Z);
      const unsigned char* pb = S + (wg ? L::W2 : L::W1);
      sm90::fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const size_t ka = size_t(s >> 2) * TM * 128 + (s & 3) * 32;
        const size_t kb = size_t(s >> 2) * NC * 128 + (s & 3) * 32;
        sm90::Mma<NC>::run(pacc, sm90::desc(pa + ka), sm90::desc(pb + kb));
      }
      sm90::commit();
      sm90::wait<0>();
      float4* xch = reinterpret_cast<float4*>(S + L::XCH);  // [2 wg][128 threads][NC / 8]
      const int t = tid & 127;
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
        xch[(wg * 128 + t) * (NC / 8) + i] =
            make_float4(pacc[4 * i], pacc[4 * i + 1], pacc[4 * i + 2], pacc[4 * i + 3]);
      __syncthreads();
      const float4 hv = xch[t * (NC / 8) + wg], dv = xch[(128 + t) * (NC / 8) + wg];
      hacc[0] = hv.x; hacc[1] = hv.y; hacc[2] = hv.z; hacc[3] = hv.w;
      dacc[0] = dv.x; dacc[1] = dv.y; dacc[2] = dv.z; dacc[3] = dv.w;
    } else {
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) hacc[i] = dacc[i] = 0.f;
    sm90::fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const size_t ka = size_t(s >> 2) * TM * 128 + (s & 3) * 32;
      const size_t kb = size_t(s >> 2) * NC * 128 + size_t(wg * NH) * 128 + (s & 3) * 32;
      sm90::Mma<NH>::run(hacc, sm90::desc(S + L::Z + ka), sm90::desc(S + L::W1 + kb));
      sm90::Mma<NH>::run(dacc, sm90::desc(S + L::G + ka), sm90::desc(S + L::W2 + kb));
    }
    sm90::commit();
    sm90::wait<0>();
    }

    // GELU and its derivative on the accumulators
    bf16* st_dh = reinterpret_cast<bf16*>(S + L::ST);
    bf16* st_a = st_dh + NC * SST;
#pragma unroll
    for (int i = 0; i < NH / 8; ++i) {
      const int n = wg * NH + 8 * i + col0;  // column in the chunk
      float cs0 = 0.f, cs1 = 0.f;             // column sums of d_h over this thread's rows
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int m = row0 + 8 * hv;
        const bool in = p0 + m < P;
        float dh[2], av[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // 0.5 (1 + tanh u) = sigmoid(2u): one fast exp and one fast divide
          const float hh = hacc[4 * i + 2 * hv + e] + __ldg(a.b1f + j0 + n + e);
          const float u2 = 1.5957691216057308f * (hh + 0.044715f * hh * hh * hh);
          const float sg = __fdividef(1.0f, 1.0f + __expf(-u2));
          const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * hh * hh);
          const float dg = sg + hh * 2.0f * sg * (1.0f - sg) * du;
          dh[e] = in ? dacc[4 * i + 2 * hv + e] * dg : 0.f;
          av[e] = in ? hh * sg : 0.f;
        }
        cs0 += dh[0];
        cs1 += dh[1];
        const __nv_bfloat162 dh2 = __floats2bfloat162_rn(dh[0], dh[1]);
        *reinterpret_cast<__nv_bfloat162*>(S + L::DH + sm90::swz(TM, m, n)) = dh2;
        st_dh[n * SST + m] = dh2.x;
        st_dh[(n + 1) * SST + m] = dh2.y;
        st_a[n * SST + m] = __float2bfloat16(av[0]);
        st_a[(n + 1) * SST + m] = __float2bfloat16(av[1]);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over the 8 row groups of the warp
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
      }
      if (lane < 4) {
        s_db1[wi * NC + n] = cs0;
        s_db1[wi * NC + n + 1] = cs1;
      }
    }
    sm90::fence_proxy();
    __syncthreads();  // d_h's A tile, the transposed staging and the db1 sums are complete
    if (k + 1 < nchunk) row_load_hidden<CP, NC>(a, S, j0 + NC);
    cp_async_commit();
    for (int i = tid; i < 2 * NC * 8; i += RT) {
      const int which = i / (NC * 8), n = (i / 8) % NC, q = i % 8;
      const uint4 v = *reinterpret_cast<const uint4*>((which ? st_a : st_dh) + n * SST + q * 8);
      *reinterpret_cast<uint4*>((which ? a.aT : a.dhT) + size_t(j0 + n) * a.Pp + p0 + q * 8) = v;
    }
    for (int n = tid; n < NC; n += RT)
      a.db1p[size_t(tile) * C4 + j0 + n] =
          ((s_db1[n] + s_db1[NC + n]) + s_db1[2 * NC + n]) + s_db1[3 * NC + n];
    cp_async_wait<1>();  // this chunk's w1^T (the next chunk's w1'^T, w2' may be in flight)
    sm90::fence_proxy();
    __syncthreads();
    sm90::fence();
    if constexpr (L::SPLIT) {
      sm90::Mma<ND>::run(acc, sm90::desc(S + L::DH), sm90::desc32(S + L::W1T + size_t(wg * ND) * 32));
    } else {
#pragma unroll
    for (int s = 0; s < KD; ++s)
      sm90::Mma<ND>::run(acc, sm90::desc(S + L::DH + s * 32),
                         sm90::desc(S + L::W1T + size_t(wg * ND) * 128 + s * 32));
    }
    sm90::commit();
    sm90::wait<0>();
    __syncthreads();  // d_h's tile, the staging and w1^T's tile are free
    if (k + 1 < nchunk) row_load_dz2<CP, NC>(a, S, j0 + NC);
    cp_async_commit();
  }
  // y again, into the free dt(z) tile, for the fp32 z of the epilogue (V1
  // reads its fp32 y from device memory)
  if constexpr (!V1) {
    for (int i = tid; i < TM * CH; i += RT) {
      const int m = i / CH, c0 = (i % CH) * 8, p = p0 + m;
      const bool in = p < P && c0 < C;
      cp_async16_zfill(S + L::Z + sm90::swz(TM, m, c0), in ? a.y + size_t(p) * C + c0 : a.y, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // d_z = lns * d_z2; d_y = r (d_z - mean(d_z) - z mean(d_z z)); column
  // partials of dln_scale = sum d_z2 z and dln_bias = sum d_z2
  // this thread's two rows (row0, row0 + 8): their moments, held in
  // registers across the loops below (the loops' shared stores would make
  // the compiler reload them)
  float mu[2], rsd[2];
  bool rin[2];
#pragma unroll
  for (int hv = 0; hv < 2; ++hv) {
    mu[hv] = s_mean[row0 + 8 * hv];
    rsd[hv] = s_rstd[row0 + 8 * hv];
    rin[hv] = p0 + row0 + 8 * hv < P;
  }
  // z of this thread's elements at row row0 + 8 hv and columns c, c + 1
  auto z_at = [&](int hv, int c, float* z) {
    const bool in = rin[hv] && c < C;
    float2 yy = make_float2(0.f, 0.f);
    if constexpr (V1) {
      if (in) yy = __ldg(reinterpret_cast<const float2*>(a.yf + size_t(p0 + row0 + 8 * hv) * C + c));
    } else {
      yy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          S + L::Z + sm90::swz(TM, row0 + 8 * hv, c)));
    }
    z[0] = in ? (yy.x - mu[hv]) * rsd[hv] : 0.f;
    z[1] = in ? (yy.y - mu[hv]) * rsd[hv] : 0.f;
  };
  float rs1[2] = {0.f, 0.f}, rs2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < ND / 8; ++i) {
    const int c = wg * ND + 8 * i + col0;
    const float l0 = c < C ? __ldg(a.lns + c) : 0.f, l1 = c < C ? __ldg(a.lns + c + 1) : 0.f;
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      float z[2];
      z_at(hv, c, z);
      const float dz0 = rin[hv] ? acc[4 * i + 2 * hv] * l0 : 0.f;
      const float dz1 = rin[hv] ? acc[4 * i + 2 * hv + 1] * l1 : 0.f;
      rs1[hv] += dz0 + dz1;
      rs2[hv] += dz0 * z[0] + dz1 * z[1];
    }
  }
#pragma unroll
  for (int hv = 0; hv < 2; ++hv)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs1[hv] += __shfl_xor_sync(0xffffffffu, rs1[hv], o);
      rs2[hv] += __shfl_xor_sync(0xffffffffu, rs2[hv], o);
    }
  if ((lane & 3) == 0)
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      s_rows[(wg * TM + row0 + 8 * hv) * 2] = rs1[hv];
      s_rows[(wg * TM + row0 + 8 * hv) * 2 + 1] = rs2[hv];
    }
  __syncthreads();
  float m1[2], m2[2];  // mean(d_z) and mean(d_z z) of the two rows
#pragma unroll
  for (int hv = 0; hv < 2; ++hv) {
    const int m = row0 + 8 * hv;
    m1[hv] = (s_rows[m * 2] + s_rows[(TM + m) * 2]) / float(C);
    m2[hv] = (s_rows[m * 2 + 1] + s_rows[(TM + m) * 2 + 1]) / float(C);
  }
  float* s_col = reinterpret_cast<float*>(S + L::W1);  // [2 wg][4 warps][ND][2]
#pragma unroll
  for (int i = 0; i < ND / 8; ++i) {
    const int cl = 8 * i + col0, c = wg * ND + cl;
    const float l0 = c < C ? __ldg(a.lns + c) : 0.f, l1 = c < C ? __ldg(a.lns + c + 1) : 0.f;
    float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [column e][lns, lnb]
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const bool in = rin[hv] && c < C;
      float zz[2];
      z_at(hv, c, zz);
      const float dz2a = in ? acc[4 * i + 2 * hv] : 0.f, dz2b = in ? acc[4 * i + 2 * hv + 1] : 0.f;
      cs[0][0] += dz2a * zz[0];
      cs[0][1] += dz2a;
      cs[1][0] += dz2b * zz[1];
      cs[1][1] += dz2b;
      if (in)
        *reinterpret_cast<float2*>(a.dy + size_t(p0 + row0 + 8 * hv) * C + c) =
            make_float2(rsd[hv] * (dz2a * l0 - m1[hv] - zz[0] * m2[hv]),
                        rsd[hv] * (dz2b * l1 - m1[hv] - zz[1] * m2[hv]));
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) cs[e][q] += __shfl_xor_sync(0xffffffffu, cs[e][q], o);
    if (lane < 4)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) s_col[((wg * 4 + wi) * ND + cl + e) * 2 + q] = cs[e][q];
  }
  __syncthreads();
  for (int c = tid; c < C; c += RT) {
    const int w = c / ND, cl = c % ND;
    float t[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      t[q] = ((s_col[((w * 4 + 0) * ND + cl) * 2 + q] + s_col[((w * 4 + 1) * ND + cl) * 2 + q]) +
              s_col[((w * 4 + 2) * ND + cl) * 2 + q]) + s_col[((w * 4 + 3) * ND + cl) * 2 + q];
    a.dlnsp[size_t(tile) * C + c] = t[0];
    a.dlnbp[size_t(tile) * C + c] = t[1];
  }
}

// ---- weight pass: dw1^T = z2d^T dt(d_h) and W = dt(g)^T dt(a), [C, 4C] ------
// over K = the pixels, split into slices; one CTA of two warpgroups per
// 128 x 128 output tile and slice (warpgroup wg: rows wg*64.., two
// m64n64k16 products per 16 pixels sharing the A tile), operands K-major
// (the row pass wrote them transposed) through a WST-deep cp.async ring.
// W's CTAs also sum dt(w2) W over their 128 columns per row: dgamma's
// partials.
struct WArgs {
  const bf16* a[2];  // z2T, gT [C, Pp]
  const bf16* b[2];  // dhT, aT [4C, Pp]
  float* part;       // [2][S][C][4C]
  const float* w2;   // raw w2 [C, 4C] (fp32)
  float* dgp;        // dgamma's partials [S][4C / 128][C]
  int C, Pp, kslice, S;
};

__device__ __forceinline__ void w_load(const WArgs& w, int q, unsigned char* st, int m0, int n0,
                                       int k0) {
  for (int i = threadIdx.x; i < 2 * WM * 8; i += WT) {
    const int isb = i / (WM * 8), r = (i / 8) % WM, ch = i % 8;
    const int row = (isb ? n0 : m0) + r;
    const bool in = row < (isb ? 4 * w.C : w.C);
    const bf16* src = (isb ? w.b[q] : w.a[q]) + size_t(row) * w.Pp + k0 + ch * 8;
    cp_async16_zfill(st + isb * WTILE + sm90::swz(WM, r, ch * 8), in ? src : w.b[q], in);
  }
}

__global__ void __launch_bounds__(WT) k2_weight_kernel(const WArgs w) {
  extern __shared__ unsigned char k2h_smem[];
  unsigned char* S = sm90::smem_base(k2h_smem);
  const int q = blockIdx.z / w.S, sl = blockIdx.z % w.S;
  const int n0 = blockIdx.x * WM, m0 = blockIdx.y * WM;
  const int kbeg = sl * w.kslice, kend = min(w.Pp, kbeg + w.kslice);
  const int nk = (kend - kbeg) / WK;
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
#pragma unroll
  for (int t = 0; t < WST - 1; ++t) {
    if (t < nk) w_load(w, q, S + t * 2 * WTILE, m0, n0, kbeg + t * WK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<WST - 2>();
    sm90::fence_proxy();
    __syncthreads();  // stage t landed for all; stage t - 1 is no longer read
    if (t + WST - 1 < nk)
      w_load(w, q, S + ((t + WST - 1) % WST) * 2 * WTILE, m0, n0, kbeg + (t + WST - 1) * WK);
    cp_async_commit();
    const unsigned char* st = S + (t % WST) * 2 * WTILE;
    sm90::fence();
#pragma unroll
    for (int s = 0; s < WK / 16; ++s) {
      const uint64_t da = sm90::desc(st + wg * 64 * 128 + s * 32);
      sm90::Mma<64>::run(acc[0], da, sm90::desc(st + WTILE + s * 32));
      sm90::Mma<64>::run(acc[1], da, sm90::desc(st + WTILE + 64 * 128 + s * 32));
    }
    sm90::commit();
    sm90::wait<0>();
  }
  cp_async_wait<0>();
  const int C4 = 4 * w.C;
  float* out = w.part + (size_t(q) * w.S + sl) * w.C * C4;
  float dg[2] = {0.f, 0.f};  // W's product: this tile's share of sum_j dt(w2) W per row
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int m = m0 + wg * 64 + 16 * wi + (lane >> 2) + 8 * hv;
        const int n = n0 + h * 64 + 8 * i + 2 * (lane & 3);
        if (m < w.C && n < C4) {
          const float v0 = acc[h][4 * i + 2 * hv], v1 = acc[h][4 * i + 2 * hv + 1];
          *reinterpret_cast<float2*>(out + size_t(m) * C4 + n) = make_float2(v0, v1);
          if (q == 1) {
            const float2 wv = *reinterpret_cast<const float2*>(w.w2 + size_t(m) * C4 + n);
            dg[hv] += bf(__float2bfloat16(wv.x)) * v0 + bf(__float2bfloat16(wv.y)) * v1;
          }
        }
      }
  if (q == 1) {
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      dg[hv] += __shfl_xor_sync(0xffffffffu, dg[hv], 1);
      dg[hv] += __shfl_xor_sync(0xffffffffu, dg[hv], 2);
      const int m = m0 + wg * 64 + 16 * wi + (lane >> 2) + 8 * hv;
      if ((lane & 3) == 0 && m < w.C)
        w.dgp[(size_t(sl) * gridDim.x + blockIdx.x) * w.C + m] = dg[hv];
    }
  }
}

// ---- one reduction launch over a table of segments ------------------------
enum SegKind { SEG_SUM = 0, SEG_DW1 = 1, SEG_DW2 = 2, SEG_DGAMMA = 3 };
struct Seg {
  const float* part;  // [S][n]
  float* out;
  long long n;
  int S, kind;
  int rows, first;  // thread rows per column (a power of two <= 32), first block
};
constexpr int MAXSEG = 10;
constexpr int RT_RED = 1024;  // reduction threads: 32 warps
struct RedArgs {
  Seg seg[MAXSEG];
  int nseg, C;
  const float *gamma, *b2, *sgp;  // sgp: the sum-g partials [tiles, C]
  int tiles;
};

// thread rows per column for S slices: enough for about 16 slices a row
inline int seg_rows(int S) {
  int r = 1;
  while (r < 32 && r * 16 < S) r *= 2;
  return r;
}

// A block's 32 warps cover 32 / R groups of 32 columns with R warps (rows)
// each. Sum over s of part[s * n + col] in a fixed order: row r takes s = r,
// r + R, ... into four running sums (four loads in flight), added in
// order; then row 0 adds the R row sums in order.
__device__ __forceinline__ float column_sum(const float* part, int S, long long n, long long col,
                                            int R, float (&red)[32][32]) {
  const int tx = threadIdx.x & 31, warp = threadIdx.x >> 5, row = warp % R;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
  if (col < n) {
    int s = row;
    for (; s + 3 * R < S; s += 4 * R) {
      t0 += part[s * n + col];
      t1 += part[(s + R) * n + col];
      t2 += part[(s + 2 * R) * n + col];
      t3 += part[(s + 3 * R) * n + col];
    }
    for (; s < S; s += R) t0 += part[s * n + col];
  }
  __syncthreads();  // red is free
  red[warp][tx] = (t0 + t1) + (t2 + t3);
  __syncthreads();
  float u = 0.f;
  if (row == 0)
    for (int w = 0; w < R; ++w) u += red[warp + w][tx];
  return u;
}

// every block sums columns of one segment (no atomics): the parameter
// vectors over the row pass's tiles, the taps over the spatial slices, the
// weight gradients over the weight pass's K slices (dw1 written transposed
// to the port's [4C, C], dw2 = gamma * W), and dgamma = its weight-pass
// partials + b2 * sum g
__global__ void __launch_bounds__(RT_RED) k2_reduce_kernel(const RedArgs r) {
  __shared__ float red[32][32];
  int si = 0;
  while (si + 1 < r.nseg && int(blockIdx.x) >= r.seg[si + 1].first) ++si;
  const Seg& sg = r.seg[si];
  const int R = sg.rows, warp = threadIdx.x >> 5;
  const long long col =
      ((long long)(blockIdx.x - sg.first) * (32 / R) + warp / R) * 32 + (threadIdx.x & 31);
  float u = column_sum(sg.part, sg.S, sg.n, col, R, red);
  if (sg.kind == SEG_DGAMMA) {  // rows = 32 for both sums
    const float sgc = column_sum(r.sgp, r.tiles, sg.n, col, R, red);
    u += r.b2[col < sg.n ? col : 0] * sgc;
  }
  if (warp % R != 0 || col >= sg.n) return;
  if (sg.kind == SEG_DW1) {
    const int C4 = 4 * r.C, c = int(col / C4), j = int(col % C4);
    sg.out[size_t(j) * r.C + c] = u;  // the port's [4C, C]
  } else if (sg.kind == SEG_DW2) {
    sg.out[col] = r.gamma[col / (4 * r.C)] * u;  // dw2 = gamma * W, [C, 4C]
  } else {
    sg.out[col] = u;
  }
}

// ---- plan and launches -----------------------------------------------------
struct Plan {
  int P, C, tiles, Pp, S, kslice, nsl, nch;
  size_t off[15];
  size_t total;
};

inline Plan make_plan(int B, int H, int W, int C, bool v1) {
  Plan pl{};
  pl.P = B * H * W;
  pl.C = C;
  pl.tiles = cdiv(pl.P, TM);
  pl.Pp = pl.tiles * TM;
  // split-K: about one wave of two 96 KB CTAs per SM, >= 16 stages a slice
  const int wtiles = cdiv(4 * C, WM) * cdiv(C, WM) * 2;
  int s = max(1, min(cdiv(2 * 132, wtiles), pl.Pp / (16 * WK)));
  pl.kslice = cdiv(cdiv(pl.Pp, s), WK) * WK;
  pl.S = cdiv(pl.Pp, pl.kslice);
  pl.nch = cdiv(C, CC);
  const int ntiles = B * cdiv(H, TH) * cdiv(W, TW);
  pl.nsl = max(1, min(ntiles, cdiv(4 * 132, pl.nch)));
  const size_t P = pl.P, Pp = pl.Pp, c = C, f = 4, t = 2, T = pl.tiles;
  const size_t sizes[15] = {
      4 * c * Pp * t,  // 0 dt(d_h)^T
      4 * c * Pp * t,  // 1 dt(a)^T
      c * Pp * t,      // 2 dt(z * lns + lnb)^T
      c * Pp * t,      // 3 dt(g)^T
      P * c * f,       // 4 d_y
      T * 4 * c * f,   // 5 db1 partials
      T * c * f,       // 6 db2 partials
      T * c * f,       // 7 sum-g partials
      T * c * f,       // 8 dln_scale partials
      T * c * f,       // 9 dln_bias partials
      size_t(pl.nsl) * 49 * c * f,          // 10 tap partials
      size_t(pl.nsl) * c * f,               // 11 dw-bias partials
      2 * size_t(pl.S) * c * 4 * c * f,     // 12 weight-gradient partials [2][S][C][4C]
      size_t(pl.S) * cdiv(4 * C, WM) * c * f,  // 13 dgamma partials [S][4C / 128][C]
      v1 ? P * c * f : 0};                      // 14 y recomputed (fp32; V1 only)
  size_t o = 0;
  for (int i = 0; i < 15; ++i) {
    pl.off[i] = o;
    o += align128(sizes[i]);
  }
  pl.total = o;
  return pl;
}

// the row pass's shared memory per CTA and its CTAs per SM at width C
template <int CP, int NC, bool V1>
int row_occupancy(int* smem, int* ctas) {
  const int bytes = int(RowSmem<CP, NC>::BYTES) + 1024;
  auto kern = k2_row_kernel<CP, NC, V1>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  *smem = bytes;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, RT, bytes));
}

template <bool V1>
int row_config(int C, int* smem, int* ctas, int* nc) {
  *nc = C <= 192 ? 64 : C <= 384 ? 32 : 16;
  if (C <= 48) return row_occupancy<48, 64, V1>(smem, ctas);
  if (C <= 96) return row_occupancy<96, 64, V1>(smem, ctas);
  if (C <= 192) return row_occupancy<192, 64, V1>(smem, ctas);
  if (V1 || C <= 384) return row_occupancy<384, 32, V1>(smem, ctas);
  if constexpr (!V1) return row_occupancy<512, 16, false>(smem, ctas);
  return int(cudaErrorInvalidValue);
}

template <int CP, int NC, bool V1>
int launch_row(const RowArgs& ra, int tiles, cudaStream_t s) {
  const int bytes = int(RowSmem<CP, NC>::BYTES) + 1024;
  auto kern = k2_row_kernel<CP, NC, V1>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  kern<<<tiles, RT, bytes, s>>>(ra);
  return int(cudaGetLastError());
}

// p (bf16 pipeline): x, y, g, taps [49][C], w1ft = dt(w1')^T [4C][C], w2f =
// dt(w2') [4C][C], w1t = dt(w1)^T [C][4C], w2 (fp32, raw) [C][4C], b1f [4C],
// b2, gamma, lns, lnb [C]; then the outputs dx, ddw [49][C], ddwb, dlns,
// dlnb, dw1 [4C][C], db1, dw2 [C][4C], db2, dgam.
// V1 (K4) reads the same slots with y unused, the raw dt(w1) [4C][C] in
// w1ft's, dt(w2)^T [4C][C] in w2f's and the raw b1 in b1f's, and a 24th
// pointer, the dw bias [C]; its first launch recomputes y in fp32.
template <bool V1>
int backward(const void* const* p, void* ws, int B, int H, int W, int C, float eps,
             cudaStream_t s) {
  const Plan pl = make_plan(B, H, W, C, V1);
  auto in = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto inf = [&](int i) { return static_cast<const float*>(p[i]); };
  auto outf = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto wb = [&](int i) { return reinterpret_cast<bf16*>(w + pl.off[i]); };
  auto wf = [&](int i) { return reinterpret_cast<float*>(w + pl.off[i]); };
  int rc;

  if constexpr (V1) {  // y = dwconv7x7(x) + b_dw in fp32 (K3's device code)
    if ((rc = dwc::dwconv7_launch<bf16>(in(0), inf(3), inf(23), wf(14), B, H, W, C, s))) return rc;
  }
  RowArgs ra{};
  ra.y = in(1); ra.g = in(2); ra.w1ft = in(4); ra.w2f = in(5); ra.w1t = in(6);
  ra.yf = V1 ? wf(14) : nullptr;
  ra.b1f = inf(8); ra.gamma = inf(10); ra.lns = inf(11); ra.lnb = inf(12);
  ra.dhT = wb(0); ra.aT = wb(1); ra.z2T = wb(2); ra.gT = wb(3); ra.dy = wf(4);
  ra.db1p = wf(5); ra.db2p = wf(6); ra.sgp = wf(7); ra.dlnsp = wf(8); ra.dlnbp = wf(9);
  ra.P = pl.P; ra.Pp = pl.Pp; ra.C = C; ra.eps = eps;
  if (C <= 48) rc = launch_row<48, 64, V1>(ra, pl.tiles, s);
  else if (C <= 96) rc = launch_row<96, 64, V1>(ra, pl.tiles, s);
  else if (C <= 192) rc = launch_row<192, 64, V1>(ra, pl.tiles, s);
  else if (V1 || C <= 384) rc = launch_row<384, 32, V1>(ra, pl.tiles, s);
  else if constexpr (!V1) rc = launch_row<512, 16, false>(ra, pl.tiles, s);
  if (rc) return rc;

  {
    WArgs wa{};
    wa.a[0] = wb(2); wa.b[0] = wb(0);  // dw1^T = z2d^T dt(d_h)
    wa.a[1] = wb(3); wa.b[1] = wb(1);  // W = dt(g)^T dt(a)
    wa.part = wf(12); wa.w2 = inf(7); wa.dgp = wf(13);
    wa.C = C; wa.Pp = pl.Pp; wa.kslice = pl.kslice; wa.S = pl.S;
    const int bytes = int(WST * 2 * WTILE) + 1024;
    cudaError_t e =
        cudaFuncSetAttribute(k2_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return int(e);
    k2_weight_kernel<<<dim3(cdiv(4 * C, WM), cdiv(C, WM), 2 * pl.S), WT, bytes, s>>>(wa);
    if ((rc = int(cudaGetLastError()))) return rc;
  }
  {
    auto kern = cnb_bwd_spatial_kernel<bf16>;
    const int bytes = int(sizeof(SpatialSmem));
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return int(e);
    bf16* dx = static_cast<bf16*>(const_cast<void*>(p[13]));
    kern<<<dim3(pl.nsl, pl.nch), NT, bytes, s>>>(wf(4), in(0), in(2), inf(3), dx, wf(10), wf(11), B,
                                                 H, W, C);
    if ((rc = int(cudaGetLastError()))) return rc;
  }
  RedArgs rr{};
  const long long c = C, C4 = 4LL * C;
  const Seg segs[] = {
      {wf(10), outf(14), 49 * c, pl.nsl, SEG_SUM, 0, 0},     // taps
      {wf(11), outf(15), c, pl.nsl, SEG_SUM, 0, 0},          // dw bias
      {wf(8), outf(16), c, pl.tiles, SEG_SUM, 0, 0},         // ln scale
      {wf(9), outf(17), c, pl.tiles, SEG_SUM, 0, 0},         // ln bias
      {wf(12), outf(18), c * C4, pl.S, SEG_DW1, 0, 0},        // w1
      {wf(5), outf(19), C4, pl.tiles, SEG_SUM, 0, 0},        // b1
      {wf(12) + size_t(pl.S) * c * C4, outf(20), c * C4, pl.S, SEG_DW2, 0, 0},  // w2
      {wf(6), outf(21), c, pl.tiles, SEG_SUM, 0, 0},         // b2
      {wf(13), outf(22), c, pl.S * cdiv(C4, WM), SEG_DGAMMA, 0, 0},  // gamma
  };
  int blocks = 0;
  rr.nseg = int(sizeof(segs) / sizeof(segs[0]));
  for (int i = 0; i < rr.nseg; ++i) {
    Seg& sg = rr.seg[i];
    sg = segs[i];
    sg.rows = sg.kind == SEG_DGAMMA ? 32 : seg_rows(sg.S);
    sg.first = blocks;
    blocks += int((sg.n + 32 * (32 / sg.rows) - 1) / (32 * (32 / sg.rows)));
  }
  rr.C = C; rr.gamma = inf(10); rr.b2 = inf(9); rr.sgp = wf(7); rr.tiles = pl.tiles;
  k2_reduce_kernel<<<blocks, RT_RED, 0, s>>>(rr);
  return int(cudaGetLastError());
}

}  // namespace k2h

inline bool bad_shape(int B, int H, int W, int C) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || C > MAXC;
}

// K2's bf16 calls up to C = 512 and K4's up to C = 384 run the Hopper
// pipeline (namespace k2h); fp32 and the wider bf16 calls, the first design
inline bool hopper_route(int C, int is_bf16, bool v1 = false) {
  return is_bf16 && C <= (v1 ? k2h::V1_HMAXC : k2h::HMAXC);
}

// the workspace of K2 (v1 false) or K4 at this shape, on its route or
// (first_design) on the first design
inline long long workspace(int B, int H, int W, int C, int is_bf16, bool v1, bool first_design) {
  if (bad_shape(B, H, W, C)) return -1;
  if (!first_design && hopper_route(C, is_bf16, v1))
    return (long long)k2h::make_plan(B, H, W, C, v1).total;
  return (long long)(is_bf16 ? make_plan<__nv_bfloat16>(B, H, W, C, v1).total
                             : make_plan<float>(B, H, W, C, v1).total);
}

}  // namespace

extern "C" {

// Bytes of device workspace cnb_backward needs for this shape.
long long cnb_backward_workspace(int B, int H, int W, int C, int is_bf16) {
  return workspace(B, H, W, C, is_bf16, false, false);
}

// ptrs: in bf16 up to C = 512 the 23 pointers listed above k2h::backward,
// otherwise the 24 listed above the first design's `backward` (inputs
// contiguous NHWC or as listed, compute dtype bf16 if is_bf16 else fp32,
// parameter vectors and every gradient but dx fp32); ws:
// cnb_backward_workspace bytes, 128-byte aligned. Launches on `stream`;
// returns the first CUDA error, or 0.
int cnb_backward(const void* const* ptrs, void* ws, int B, int H, int W, int C, float eps,
                 int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (hopper_route(C, is_bf16)) return k2h::backward<false>(ptrs, ws, B, H, W, C, eps, s);
  if (is_bf16) return backward<__nv_bfloat16, false>(ptrs, ws, B, H, W, C, eps, s);
  return backward<float, false>(ptrs, ws, B, H, W, C, eps, s);
}

// 1 if K2's calls at width C and this dtype run the Hopper pipeline (and take
// its pointer list), 0 if they run the first design.
int cnb_backward_route(int C, int is_bf16) { return int(hopper_route(C, is_bf16)); }

// K2's (v1 = 0, C <= 512) or K4's (C <= 384) Hopper row pass at width C:
// shared memory per CTA, CTAs per SM and the hidden chunk NC; returns a CUDA
// error, or 0.
int cnb_backward_row_config(int C, int v1, int* smem_bytes, int* ctas_per_sm, int* chunk) {
  if (C <= 0 || C % 16 != 0 || C > (v1 ? k2h::V1_HMAXC : k2h::HMAXC))
    return int(cudaErrorInvalidValue);
  return v1 ? k2h::row_config<true>(C, smem_bytes, ctas_per_sm, chunk)
            : k2h::row_config<false>(C, smem_bytes, ctas_per_sm, chunk);
}

// K4: bytes of device workspace cnb_backward_v1 (first_design = 0) or
// cnb_backward_v1_v0 needs for this shape.
long long cnb_backward_v1_workspace(int B, int H, int W, int C, int is_bf16, int first_design) {
  return workspace(B, H, W, C, is_bf16, true, first_design != 0);
}

// 1 if K4's calls at width C and this dtype run the Hopper pipeline (and take
// its pointer list), 0 if they run the first design: K2's rule.
int cnb_backward_v1_route(int C, int is_bf16) { return int(hopper_route(C, is_bf16, true)); }

// K4, the recompute-form backward: in bf16 up to C = 384 the 24 pointers of
// the V1 form listed above k2h::backward, otherwise the 25 listed above the
// first design's `backward` (taps and dw bias 16-byte aligned); otherwise as
// cnb_backward.
int cnb_backward_v1(const void* const* ptrs, void* ws, int B, int H, int W, int C, float eps,
                    int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (hopper_route(C, is_bf16, true)) return k2h::backward<true>(ptrs, ws, B, H, W, C, eps, s);
  if (is_bf16) return backward<__nv_bfloat16, true>(ptrs, ws, B, H, W, C, eps, s);
  return backward<float, true>(ptrs, ws, B, H, W, C, eps, s);
}

// K4's first design whatever the route (the Hopper pipeline's "before"):
// the 25 pointers listed above `backward`, a cnb_backward_v1_v0 workspace.
int cnb_backward_v1_v0(const void* const* ptrs, void* ws, int B, int H, int W, int C, float eps,
                       int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C)) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return backward<__nv_bfloat16, true>(ptrs, ws, B, H, W, C, eps, s);
  return backward<float, true>(ptrs, ws, B, H, W, C, eps, s);
}

}  // extern "C"
