// ConvNeXt block backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built with nvcc into a shared library, loaded with ctypes).
//
// Replaces the TPU kernel multitask_bonetumor_yolo_tpu/ops/pallas/
// convnext_block_bwd.py::_kernel_v2 (driven by fused_block_bwd_v2): from the
// block input x, the dwconv output y saved by the residual-saving forward
// (csrc/convnext_block.cu, SAVE) and the cotangent g, it computes dx and the
// fp32 gradients of the nine raw parameters. Math, as the TPU kernel does it
// (per pixel, C channels, hidden width 4C; dt = compute dtype):
//
//   z   = (y - mean) * r,  r = rsqrt(max(E[y^2] - mean^2, 0) + eps)
//   h1  = dt(z) @ w1' + b1'                    w1' = ln_scale * w1 (folded)
//   d_a = dt(g) @ w2'^T                        w2' = w2 * gamma (folded)
//   d_h = d_a * gelu_tanh'(h1),  a = gelu_tanh(h1)
//   d_z = dt(d_h) @ w1'^T,  d_z2 = dt(d_h) @ w1^T,  o = dt(a) @ w2 + b2
//   d_y = r * (d_z - mean(d_z) - z * mean(d_z * z))
//   dx  = corr7x7(d_y, flipped taps) + g
//   grads: dgamma = sum g*o; db2 = sum dt(g*gamma); dw2 = dt(a)^T dt(g*gamma);
//          db1 = sum d_h; dw1 = dt(z*ln_scale + ln_bias)^T dt(d_h);
//          dln_scale = sum d_z2*z; dln_bias = sum d_z2; db_dw = sum d_y;
//          dtaps[i][j] = sum x[p + (i-3, j-3)] * d_y[p]
// (sums over all B*H*W pixels).
//
// What bounds it on an H100 (SXM datasheet: 989 TFLOP/s bf16 dense, 67
// TFLOP/s fp32 outside the tensor cores, 3.35 TB/s): the function needs five
// products of 8*C^2 flop per pixel (h1, d_a, d_z2 and the two weight
// gradients: d_z = ln_scale * d_z2, and dgamma = sum_j w2 . (g^T a) + b2 *
// sum g comes from the dw2 product), 40*C^2 flop per pixel on the tensor
// cores; at batch 8 and 640^2 that is 8*H*W*C^2 = 1.89e9 times 40, ~75.5
// GFLOP per block at every stage (H*W*C^2 is the same at all four), ~0.076
// ms at peak. The two 7x7 passes (2 x 98*C flop per pixel on the fp32 cores,
// ~0.058 ms at stage 0) run on other units and can overlap them; the bytes
// it must move are x, y, g in and dx out (4 x 2*C per pixel in bf16, ~0.047
// ms at stage 0): bound by the products. This kernel computes seven, by
// design: d_z through the folded w1' and o = a @ w2 for dgamma, as the TPU
// kernel does (each a bf16 rounding apart from the derived form).
//
// What the design does about it (a first, simple design: wmma tensor-core
// products, no TMA/wgmma yet):
//   * the TPU kernel sums the nine parameter gradients across its sequential
//     grid; on Hopper the CTAs run in parallel, so every CTA writes its own
//     fp32 partial and one reduction kernel per gradient sums the partials in
//     a fixed order: the result is the same bit for bit from run to run (no
//     atomics anywhere);
//   * per-CTA partials of the two [C, 4C] weight gradients do not fit at
//     C = 384, so the per-pixel passes write dt(d_h) and dt(a) ([P, 4C], the
//     compute dtype) and dt(z*ln_scale + ln_bias), dt(g*gamma) ([P, C]) to
//     device memory, and the weight gradients are split-K products over the
//     pixels (K = B*H*W), each CTA one 64x64 output tile over one K slice;
//   * seven launches and nine reductions: prep (LN moments, the dt operands,
//     db2), hidden (h1 and d_a for a 64-pixel x 64-hidden tile, GELU and its
//     derivative in the epilogue, db1), channel (d_z, d_z2 and o for a
//     64-pixel x 64-channel tile, dgamma / dln_scale / dln_bias in the
//     epilogue), row (d_y from d_z), spatial (dx and the tap / dw-bias
//     partials from a +-3 halo tile of d_y and x, channel chunk by chunk),
//     and the two weight-gradient products.
// The cost of this split is device-memory traffic the TPU kernel avoids
// (~8 KB per pixel in bf16: the [P, 4C] dt(d_h) and dt(a) written once and
// read twice, d_z in fp32): ~0.5 ms at batch 8, bytes-bound, not
// operations-bound. Keeping d_h and a on chip needs the weight gradients
// reduced across CTAs from registers (a later PR).

#include <type_traits>

#include "cuda_common.cuh"

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
// db2 = sum over its pixels of do.
template <typename T>
__global__ void __launch_bounds__(NT)
cnb_bwd_prep_kernel(const T* __restrict__ y, const T* __restrict__ g, const float* __restrict__ lns,
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
        zd[row + c] = from_f<T>(z);
        z2d[row + c] = from_f<T>(z * lns[c] + lnb[c]);
        const T d = from_f<T>(to_f(g[row + c]) * gamma[c]);
        dod[row + c] = d;
        acc[j] += to_f(d);
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
enum Epi { EPI_PARTIAL = 0, EPI_HIDDEN = 1, EPI_CHANNEL = 2 };

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
  // b2 [N]; partials [gridDim.x][N] of dgamma, dln_scale, dln_bias
  float* dz;
  const T* y;
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
  template <int NG> __host__ __device__ static constexpr size_t total() {
    return max_sz(2 * stage_bytes<NG>(), NG * C_BYTES);
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
        // c0 = d_z, c1 = d_z2, c2 = a @ w2 (o - b2)
        float dgam = 0.f, dlns = 0.f, dlnb = 0.f;
        if (in) {
          const size_t off = size_t(m) * g.N + n;
          g.dz[off] = c0s[o];
          const float z = (to_f(g.y[off]) - g.mean[m]) * g.rstd[m];
          dgam = to_f(g.g[off]) * (c2s[o] + g.b2[n]);
          dlns = c1s[o] * z;
          dlnb = c1s[o];
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
template <typename T>
__global__ void __launch_bounds__(NT)
cnb_bwd_dy_kernel(float* __restrict__ dz, const T* __restrict__ y, const float* __restrict__ mean,
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
  size_t off[16];
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
Plan make_plan(int B, int H, int W, int C) {
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
  const size_t sizes[16] = {
      P * c * t,          // 0 z (dt)
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
  };
  size_t o = 0;
  for (int i = 0; i < 16; ++i) {
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
  const size_t bytes = GemmLayout<T, A_T>::template total<NG>();
  auto kern = cnb_bwd_gemm_kernel<T, A_T, NG, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  kern<<<grid, NT, bytes, s>>>(ga);
  return int(cudaGetLastError());
}

// p: x, y, g, taps [49][C], w1f [C][4C], w2fT [C][4C], w1fT [4C][C],
//    w1 [4C][C], w2t [4C][C], b1f [4C], b2 [C], gamma [C], lns [C], lnb [C],
//    then the outputs dx, ddw [49][C], ddwb, dlns, dlnb, dw1 [4C][C], db1,
//    dw2 [C][4C], db2, dgam
template <typename T>
int backward(const void* const* p, void* ws, int B, int H, int W, int C, float eps,
             cudaStream_t s) {
  const Plan pl = make_plan<T>(B, H, W, C);
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

  cnb_bwd_prep_kernel<T><<<pl.nprep, NT, 0, s>>>(y, g, inf(12), inf(13), inf(11), wt(0), wt(1), wt(2),
                                                 wf(5), wf(6), wf(8), P, C, eps);
  if ((rc = int(cudaGetLastError()))) return rc;

  GemmArgs<T, 2> hid{};  // h1 and d_a for (pixels x hidden) tiles
  hid.a[0] = wt(0); hid.b[0] = in(4);
  hid.a[1] = g;     hid.b[1] = in(5);
  hid.lda = C; hid.ldb = 4 * C; hid.M = P; hid.N = 4 * C; hid.K = C; hid.kslice = C;
  hid.dhd = wt(3); hid.act = wt(4); hid.b1 = inf(9); hid.db1_part = wf(9);
  if ((rc = launch_gemm<T, false, 2, EPI_HIDDEN>(hid, dim3(pl.nmt, cdiv(4 * C, BN), 1), s))) return rc;

  GemmArgs<T, 3> chn{};  // d_z, d_z2 and o for (pixels x channel) tiles
  chn.a[0] = wt(3); chn.b[0] = in(6);
  chn.a[1] = wt(3); chn.b[1] = in(7);
  chn.a[2] = wt(4); chn.b[2] = in(8);
  chn.lda = 4 * C; chn.ldb = C; chn.M = P; chn.N = C; chn.K = 4 * C; chn.kslice = 4 * C;
  chn.dz = wf(7); chn.y = y; chn.g = g; chn.mean = wf(5); chn.rstd = wf(6); chn.b2 = inf(10);
  chn.dgam_part = wf(10); chn.dlns_part = wf(11); chn.dlnb_part = wf(12);
  if ((rc = launch_gemm<T, false, 3, EPI_CHANNEL>(chn, dim3(pl.nmt, cdiv(C, BN), 1), s))) return rc;

  cnb_bwd_dy_kernel<T><<<cdiv(P, NWARP), NT, 0, s>>>(wf(7), y, wf(5), wf(6), P, C);
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

}  // namespace

extern "C" {

// Bytes of device workspace cnb_backward needs for this shape.
long long cnb_backward_workspace(int B, int H, int W, int C, int is_bf16) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || C > MAXC) return -1;
  return (long long)(is_bf16 ? make_plan<__nv_bfloat16>(B, H, W, C).total
                             : make_plan<float>(B, H, W, C).total);
}

// ptrs: the 24 pointers listed above `backward` (inputs contiguous NHWC or
// as listed, compute dtype bf16 if is_bf16 else fp32, parameter vectors and
// every gradient but dx fp32); ws: cnb_backward_workspace bytes, 128-byte
// aligned. Launches on `stream`; returns the first CUDA error, or 0.
int cnb_backward(const void* const* ptrs, void* ws, int B, int H, int W, int C, float eps,
                 int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || C > MAXC)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return backward<__nv_bfloat16>(ptrs, ws, B, H, W, C, eps, s);
  return backward<float>(ptrs, ws, B, H, W, C, eps, s);
}

}  // extern "C"
