// The fused ConvNeXt block forward's device code (kernel K1), shared by
// csrc/convnext_block.cu (K1's instantiations, its launch table and its C
// entry) and csrc/kernel_lab.cu (the kernel lab: K1 cut down phase by phase).
// The note on what bounds K1 and how it is laid out is in convnext_block.cu.
//
// Two template parameters beside SAVE pick what a launch computes, all at
// compile time (if constexpr): PHASE = FULL is K1, the block itself; the
// other phases are the lab's (bf16 only, no biases, the weights as given):
//   COPY         out = x: the halo-tile load, and the tile's centre written back
//   DW           out = bf16(dwconv7x7(x)), fp32 taps and accumulation, under
//                the dw schedule SCHED (below)
//   DWBF16       the dwconv in bf16 arithmetic: per kernel column dx a bf16
//                running sum over dy of bf16 products (each op rounded), the
//                7 partials summed in fp32
//   DWLN         out = bf16(LN(dwconv7x7(x))), unit LN, K1's schedule and LN
//   MLP          out = bf16(x + bf16(bf16(x) @ w1) @ w2): K1 with the dwconv
//                and LN skipped (the products' input is x itself), no GELU
//   MLPGELU      the same with K1's fp32 tanh-GELU on the hidden layer
//   MLPGELUBF16  the same with the tanh-GELU evaluated in bf16 (each op
//                rounded) on the bf16-rounded hidden layer
// The dw-only phases (COPY, DW, DWBF16) write their output straight from
// registers, channel chunk by channel chunk; DWLN writes z through K1's
// epilogue; the MLP phases run K1's phase 2 and epilogue (residual, no bias).
// Every phase keeps K1's tile, threads and shared-memory size (a phase that
// skips the weight ring still reserves it), so two phases differ by their
// work and not by their occupancy.
//
// The dw schedules (how a thread gets the 49 products of its PX outputs of
// one channel; all sum fp32 products in fp32, so they agree to rounding):
//   ROWREG   K1's own: per kernel row dy the PX+6 input pixels are read from
//            the bf16 halo into registers once, the 7 dx shifts are taken
//            from registers (49 FMAs per output, loop-carried)
//   HOISTED  the halo converted to fp32 once per dx into a column-shifted
//            copy in shared memory (7 copies per chunk, made in turn), then
//            7 aligned FMAs per output from each copy, dx outer, dy inner
//   EXPR     rows into registers as ROWREG, and the 49 products combined in
//            one unrolled pairwise tree (no loop-carried chain)
//   ROW      the whole halo converted once to fp32 in shared memory; every
//            tap read from that copy (no register reuse), dx outer
//   ROW2     two output rows per thread (register blocking over rows): each
//            input row loaded once into registers serves both output rows
//   NOHOIST  every tap read from the bf16 halo tile and converted at each use
// HOISTED and ROW keep their fp32 copies in the bytes below z's offset,
// which a dw-only phase does not otherwise use.

#pragma once

#include "cuda_common.cuh"

namespace cnb {
namespace blk {

constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int CC = 32;  // channels per dwconv chunk (one per lane)
constexpr int MAXC = 768;

enum Phase : int { FULL = 0, COPY, DW, DWBF16, DWLN, MLP, MLPGELU, MLPGELUBF16 };
enum Sched : int { ROWREG = 0, HOISTED, EXPR, ROW, ROW2, NOHOIST };

__host__ __device__ constexpr bool dw_only(int phase) {
  return phase == COPY || phase == DW || phase == DWBF16;
}

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

// fp32 shared memory the dw schedule SCHED needs for a chunk (HOISTED: one
// column-shifted copy of the halo; ROW: one full copy)
template <typename K, int SCHED> __host__ __device__ constexpr size_t sched_scratch_bytes() {
  return SCHED == HOISTED ? size_t(K::HALO_H) * K::TW * CC * sizeof(float)
       : SCHED == ROW     ? size_t(K::HALO_H) * K::HALO_W * CC * sizeof(float)
                          : 0;
}

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

// K1's dw schedule (ROWREG): channel c of the PX pixels (r, cb ..) of one
// tile row, fp32 taps, fp32 accumulation; per kernel row the PX+6 inputs are
// read into registers once and the 7 shifts taken from there.
template <typename K, typename T>
__device__ __forceinline__ void dw_rowreg(const T* halo, const float* dws, int r, int cb, int c,
                                          float* acc) {
  constexpr int PX = K::PX, HALO_W = K::HALO_W;
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
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// tanh-GELU in bf16 arithmetic, op by op as the JAX expression x * 0.5 *
// (1 + tanh(0.7978845608 * (x + 0.044715 * x * x * x))) evaluates on bf16
// values: every product, sum and the tanh rounded to bf16, the constants too
__device__ __forceinline__ float gelu_tanh_bf16(float x) {
  const float k3 = round_bf16(0.044715f), k1 = round_bf16(0.7978845608028654f);
  const float half = round_bf16(__fmul_rn(x, 0.5f));
  float a = round_bf16(__fmul_rn(k3, x));
  a = round_bf16(__fmul_rn(a, x));
  a = round_bf16(__fmul_rn(a, x));
  const float u = round_bf16(__fmul_rn(k1, round_bf16(__fadd_rn(x, a))));
  const float t = round_bf16(__fadd_rn(1.0f, round_bf16(tanhf(u))));
  return round_bf16(__fmul_rn(half, t));
}

// Store channel c0 + c of n pixels of tile row r (columns cb ..) of a
// dw-only phase straight to the NHWC output.
template <typename T>
__device__ __forceinline__ void store_run(T* ob, const float* v, int n, int r, int cb, int c0,
                                          int c, int h0, int w0, int H, int W, int C) {
  const int gh = h0 + r;
  if (gh >= H || c0 + c >= C) return;
  for (int o = 0; o < n; ++o) {
    const int gw = w0 + cb + o;
    if (gw < W) ob[(size_t(gh) * W + gw) * C + c0 + c] = from_f<T>(v[o]);
  }
}

// One channel chunk of a dw-only phase, from the chunk's halo tile and taps
// in shared memory (called by every thread: HOISTED and ROW synchronise).
// Thread (group g, lane c) owns channel c of the PX pixels (r, cb ..) of
// K1's mapping; under ROW2, two rows of PX/2 pixels instead.
template <typename K, int PHASE, int SCHED, typename T>
__device__ __forceinline__ void lab_dw_chunk(const T* halo, const float* dws, float* scratch,
                                             T* ob, int c0, int h0, int w0, int H, int W,
                                             int C) {
  constexpr int PX = K::PX, TW = K::TW, HALO_H = K::HALO_H, HALO_W = K::HALO_W;
  const int tid = threadIdx.x;
  const int c = tid % CC;
  const int g = tid / CC;
  const int r = (g * PX) / TW;
  const int cb = (g * PX) % TW;
  float acc[PX];
  if constexpr (PHASE == COPY) {
#pragma unroll
    for (int o = 0; o < PX; ++o) acc[o] = to_f(halo[((r + 3) * HALO_W + cb + o + 3) * CC + c]);
  } else if constexpr (PHASE == DWBF16) {
    // part[dx] = bf16 running sum over dy of bf16(x * bf16(tap)); then the
    // 7 partials summed in fp32, dx in order
    float part[7][PX];
#pragma unroll
    for (int dx = 0; dx < 7; ++dx)
#pragma unroll
      for (int o = 0; o < PX; ++o) part[dx][o] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      float in[PX + 6];
#pragma unroll
      for (int j = 0; j < PX + 6; ++j) in[j] = to_f(halo[((r + dy) * HALO_W + cb + j) * CC + c]);
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        const float wb = round_bf16(dws[(dy * 7 + dx) * CC + c]);
#pragma unroll
        for (int o = 0; o < PX; ++o)
          part[dx][o] = round_bf16(__fadd_rn(part[dx][o], round_bf16(__fmul_rn(in[o + dx], wb))));
      }
    }
#pragma unroll
    for (int o = 0; o < PX; ++o) {
      acc[o] = 0.f;
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) acc[o] = __fadd_rn(acc[o], part[dx][o]);
    }
  } else if constexpr (SCHED == ROWREG) {
    dw_rowreg<K>(halo, dws, r, cb, c, acc);
  } else if constexpr (SCHED == NOHOIST) {
    // a volatile shared-memory read per tap: the compiler may not reuse it
    const volatile unsigned short* hv = reinterpret_cast<const volatile unsigned short*>(halo);
#pragma unroll
    for (int o = 0; o < PX; ++o) acc[o] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        const float wv = dws[(dy * 7 + dx) * CC + c];
#pragma unroll
        for (int o = 0; o < PX; ++o) {
          const unsigned short v = hv[((r + dy) * HALO_W + cb + o + dx) * CC + c];
          acc[o] = fmaf(__bfloat162float(__ushort_as_bfloat16(v)), wv, acc[o]);
        }
      }
  } else if constexpr (SCHED == EXPR) {
    float rows[7][PX];  // per kernel row: a pairwise tree over dx
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      float in[PX + 6];
#pragma unroll
      for (int j = 0; j < PX + 6; ++j) in[j] = to_f(halo[((r + dy) * HALO_W + cb + j) * CC + c]);
      float w[7];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) w[dx] = dws[(dy * 7 + dx) * CC + c];
#pragma unroll
      for (int o = 0; o < PX; ++o)
        rows[dy][o] = ((in[o] * w[0] + in[o + 1] * w[1]) + (in[o + 2] * w[2] + in[o + 3] * w[3])) +
                      ((in[o + 4] * w[4] + in[o + 5] * w[5]) + in[o + 6] * w[6]);
    }
#pragma unroll
    for (int o = 0; o < PX; ++o)
      acc[o] = ((rows[0][o] + rows[1][o]) + (rows[2][o] + rows[3][o])) +
               ((rows[4][o] + rows[5][o]) + rows[6][o]);
  } else if constexpr (SCHED == ROW) {
    for (int i = tid; i < HALO_H * HALO_W * CC; i += NTHREAD) scratch[i] = to_f(halo[i]);
    __syncthreads();
    const volatile float* sv = scratch;  // a shared-memory read per tap, not reused
#pragma unroll
    for (int o = 0; o < PX; ++o) acc[o] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 7; ++dx)
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const float wv = dws[(dy * 7 + dx) * CC + c];
#pragma unroll
        for (int o = 0; o < PX; ++o)
          acc[o] = fmaf(sv[((r + dy) * HALO_W + cb + o + dx) * CC + c], wv, acc[o]);
      }
  } else if constexpr (SCHED == HOISTED) {
#pragma unroll
    for (int o = 0; o < PX; ++o) acc[o] = 0.f;
    for (int dx = 0; dx < 7; ++dx) {
      // the halo's columns dx .. dx+TW-1 as fp32: [HALO_H][TW][CC]
      for (int i = tid; i < HALO_H * TW * CC; i += NTHREAD) {
        const int row = i / (TW * CC), col = (i / CC) % TW, cc = i % CC;
        scratch[i] = to_f(halo[(row * HALO_W + col + dx) * CC + cc]);
      }
      __syncthreads();
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const float wv = dws[(dy * 7 + dx) * CC + c];
#pragma unroll
        for (int o = 0; o < PX; ++o)
          acc[o] = fmaf(scratch[((r + dy) * TW + cb + o) * CC + c], wv, acc[o]);
      }
      __syncthreads();  // every thread is done with this copy
    }
  } else {
    static_assert(SCHED == ROW2, "dw schedule");
    // rows r2, r2+1 and columns cb2 .. cb2 + PX/2 - 1
    constexpr int HP = PX / 2, SEGS = 2 * TW / PX;
    const int r2 = 2 * (g / SEGS), cb2 = (g % SEGS) * HP;
    float a2[2][HP];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 0; o < HP; ++o) a2[j][o] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // input row r2 + i: kernel row i of output row 0, i-1 of row 1
      float in[HP + 6];
#pragma unroll
      for (int j = 0; j < HP + 6; ++j) in[j] = to_f(halo[((r2 + i) * HALO_W + cb2 + j) * CC + c]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int dy = i - j;
        if (dy < 0 || dy > 6) continue;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const float wv = dws[(dy * 7 + dx) * CC + c];
#pragma unroll
          for (int o = 0; o < HP; ++o) a2[j][o] = fmaf(in[o + dx], wv, a2[j][o]);
        }
      }
    }
    store_run(ob, a2[0], HP, r2, cb2, c0, c, h0, w0, H, W, C);
    store_run(ob, a2[1], HP, r2 + 1, cb2, c0, c, h0, w0, H, W, C);
    return;
  }
  store_run(ob, acc, PX, r, cb, c0, c, h0, w0, H, W, C);
}

// SAVE: also write y (the dwconv output plus bias, pre-LN, compute dtype,
// NHWC) for the backward (csrc/convnext_block_bwd.cu). The SAVE = false,
// PHASE = FULL instantiation is the inference kernel.
template <typename K, bool SAVE, int PHASE = FULL, int SCHED = ROWREG>
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
  static_assert(PHASE == FULL || sizeof(T) == 2, "the lab's phases are bf16 only");
  static_assert(PHASE == DW || SCHED == ROWREG, "a dw schedule belongs to the DW phase");
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
      if constexpr (dw_only(PHASE)) {
        lab_dw_chunk<K, PHASE, SCHED>(halo, dws, reinterpret_cast<float*>(smem), ob, c0, h0, w0,
                                      H, W, C);
      } else if constexpr (PHASE >= MLP) {
        // the products' input is x itself: the tile's centre, staged in y
        if (c0 + c < C) {
#pragma unroll
          for (int o = 0; o < PX; ++o)
            ys[(r * TW + cb + o) * L.ldy + c0 + c] =
                to_f(halo[((r + 3) * HALO_W + cb + o + 3) * CC + c]);
        }
      } else {
        float acc[PX];
        dw_rowreg<K>(halo, dws, r, cb, c, acc);
        if (c0 + c < C) {
          const float bias = PHASE == FULL ? dwb[c0 + c] : 0.f;
#pragma unroll
          for (int o = 0; o < PX; ++o) ys[(r * TW + cb + o) * L.ldy + c0 + c] = acc[o] + bias;
        }
      }
      __syncthreads();
    }
  }
  if constexpr (dw_only(PHASE)) return;

  // ---- LayerNorm over the real C channels (fp32 moments) ----
  if constexpr (PHASE >= MLP) {
    for (int i = tid; i < TM * C; i += NTHREAD) {  // no LN: z = x
      const int p = i / C, c = i % C;
      zs[p * L.ldz + c] = from_f<T>(ys[p * L.ldy + c]);
    }
  } else {
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
  }
  __syncthreads();  // z complete; y (and for bf16 its bytes) free for phase 2

  if constexpr (PHASE == DWLN) {  // out = z, one 16-byte write per V channels
    constexpr int V = 16 / sizeof(T);
    const int cv = C / V;
    for (int i = tid; i < TM * cv; i += NTHREAD) {
      const int p = i / cv, c = (i % cv) * V;
      const int gh = h0 + p / TW, gw = w0 + p % TW;
      if (gh < H && gw < W)
        *reinterpret_cast<uint4*>(ob + (size_t(gh) * W + gw) * C + c) =
            *reinterpret_cast<const uint4*>(zs + p * L.ldz + c);
    }
    return;
  }

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
            if constexpr (PHASE == FULL) {
              const float bias = in ? b1[j0 + n] : 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int m = m0 + 2 * e + (lane >> 4);
                hts[m * L.ldt + n] = from_f<T>(in ? gelu_tanh(hbuf[m * L.ldh + n] + bias) : 0.f);
              }
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int m = m0 + 2 * e + (lane >> 4);
                const float v = hbuf[m * L.ldh + n];
                const float a = PHASE == MLP       ? v
                              : PHASE == MLPGELU   ? gelu_tanh(v)
                                                   : gelu_tanh_bf16(round_bf16(v));
                hts[m * L.ldt + n] = from_f<T>(in ? a : 0.f);
              }
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
      for (int e = 0; e < V; ++e) {
        if constexpr (PHASE == FULL)
          re[e] = from_f<T>(to_f(xe[e]) + (ys[p * L.ldy + c + e] + b2[c + e]));
        else
          re[e] = from_f<T>(to_f(xe[e]) + ys[p * L.ldy + c + e]);
      }
      *reinterpret_cast<uint4*>(ob + off) = res;
    }
  }
}

// Launch one instantiation over the B x tiles grid on `stream`; returns
// cudaGetLastError(). With `info`, launch nothing and report the tile
// instead: info = {TM, TH, TW, CTAs per SM} (the occupancy at this
// instantiation's registers and shared memory).
template <typename K, bool SAVE, int PHASE = FULL, int SCHED = ROWREG>
int launch_k(const void* x, void* out, void* y, const float* dw, const float* dwb, const void* w1,
             const float* b1, const void* w2, const float* b2, int B, int H, int W, int C,
             float eps, cudaStream_t stream, int* info = nullptr) {
  using T = typename K::T;
  const Layout<K> L(C);
  if (sched_scratch_bytes<K, SCHED>() > L.off_z) return int(cudaErrorInvalidValue);
  auto kern = cnb_forward_kernel<K, SAVE, PHASE, SCHED>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L.total));
  if (e != cudaSuccess) return int(e);
  if (info) {
    info[0] = K::TM;
    info[1] = K::TH;
    info[2] = K::TW;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kern, NTHREAD, L.total));
  }
  const long long tiles = (long long)B * ((H + K::TH - 1) / K::TH) * ((W + K::TW - 1) / K::TW);
  kern<<<unsigned(tiles), NTHREAD, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(y), dw, dwb,
      static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, H, W, C, eps);
  return int(cudaGetLastError());
}

}  // namespace blk
}  // namespace cnb
