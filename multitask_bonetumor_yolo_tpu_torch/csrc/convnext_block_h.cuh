// K1's Hopper design (namespace k1h: bf16, C <= 512, both products on
// wgmma), its device code and launch table, shared by csrc/convnext_block.cu
// (K1's instantiations and its C entry) and csrc/kernel_lab.cu (the kernel
// lab: this design cut down phase by phase). The note on the design and on
// what bounds it is in convnext_block.cu.
//
// Two template parameters beside SAVE pick what a launch computes, all at
// compile time (if constexpr), with the Phase and Sched enums of the first
// design (convnext_block.cuh, which describes the six dw schedules): PHASE =
// FULL is K1 itself; the other phases are the lab's (no SAVE; the caller
// passes zeros for every bias, unit LN, the weights as given):
//   COPY         out = x: phase 1's halo copies (cp.async, CC = 32 channels
//                per chunk, no taps), the tile's centre written back
//   DW           out = bf16(dwconv7x7(x)) under the dw schedule SCHED; ROWREG
//                is K1's own, the five others map onto the tile as K1 maps
//                it (warp = tile row, lane = channel)
//   DWBF16       the dwconv in bf16 arithmetic (convnext_block.cuh)
//   DWLN         phase 1 and LN as K1 runs them, then z written out from
//                its swizzled A tile, one 16-byte store per 8 channels
//   MLP          no phase 1 and no LN: dt(x) of the tile copied (cp.async)
//                straight into the swizzled A tile, then K1's chunk loop
//                unchanged (fc1 and fc2 on wgmma, the same rings and
//                pipelining) and K1's epilogue (the residual x in fp32);
//                no activation on the accumulators
//   MLPGELU      the same with K1's tanh-GELU on the accumulators
//   MLPGELUBF16  the same with the tanh-GELU in bf16 arithmetic, op by op,
//                on the bf16-rounded accumulators
// The dw-only phases (COPY, DW, DWBF16) hold no phase-2 code at all; the
// phases with products keep the chunk loop whole (no `if` around an
// in-flight wgmma). Every phase keeps K1's tile, threads and shared-memory
// size (a phase that skips the weight rings still reserves them), so two
// phases differ by their work and not by their occupancy.

#pragma once

#include "convnext_block.cuh"
#include "wgmma.cuh"

namespace cnb {
namespace k1h {

using namespace blk;  // NTHREAD, CC, the Phase / Sched enums, phase 1's dw code
using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // two warpgroups
constexpr int HMAXC = 512;       // widest C this design holds on chip
constexpr size_t SMEM_MAX = 227 * 1024;  // shared memory an H100 SM gives one CTA
static_assert(NT == NTHREAD, "phase 1 maps NTHREAD threads");

// The CTA's tile: TM = 64 or 128 pixels, 8 rows of TW. At TM = 64 both
// warpgroups share wgmma's 64 rows and split each product's columns; at TM
// = 128 warpgroup wg owns rows 64 wg .. and all the columns (MW = 2 row
// halves). Phase 1 (dw_rowreg) maps warp g to tile row g: PX = TW pixels,
// one channel per lane.
template <int TM_>
struct Tile {
  static constexpr int TM = TM_, TH = 8, TW = TM / TH, MW = TM / 64;
  static constexpr int PX = TW, HALO_H = TH + 6, HALO_W = TW + 6;
  static_assert((TM == 64 || TM == 128) && TM / NWARP == PX, "a warp owns one tile row");
};

__host__ __device__ constexpr size_t align1024(size_t n) { return (n + 1023) & ~size_t(1023); }
// pin accumulator registers in place around an asynchronous wgmma: the
// compiler may neither read them before the wait nor move them meanwhile
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared memory for channel capacity CP, hidden chunk NC and tile G. Region
// A holds the fp32 dwconv output y [TM][LDY] in phase 1 and LN, then the
// weight rings (two w1'^T chunk tiles, two w2'^T chunk tiles) and two dt(a)
// tiles, then the fp32 output staging [TM][LDY]; region B the phase-1
// scratch (two halo tiles and their taps), then dt(z). A chunk's NC <= 64
// columns are one 128-byte-swizzled block (half of it at NC = 32). Where
// two w2'^T tiles do not fit beside the rest (CP = 512: 272 KB), the ring
// is packed (PACK): both chunks share one tile, chunk j in its columns
// NC (j % 2) .., the half that NC = 32 leaves unused (208 KB).
template <int CP_, int NC_, typename G>
struct Smem {
  static constexpr int CP = CP_, NC = NC_, TM = G::TM;
  static constexpr int KB = (CP + 63) / 64;              // 64-column blocks of C
  static constexpr int LDY = CP + 8;                     // no bank conflicts in the staging
  static constexpr size_t W1B = size_t(KB) * NC * 128;   // w1'^T chunk [NC, CP] (B of fc1)
  static constexpr size_t W2B = size_t(CP) * 128;        // w2'^T chunk [CP, NC] (B of fc2)
  static constexpr size_t ACTB = size_t(TM) * 128;       // dt(a) [TM px, NC] (A of fc2)
  static constexpr size_t HALO = align128(size_t(G::HALO_H) * G::HALO_W * CC * 2);
  static constexpr size_t CHUNK = HALO + align128(size_t(49) * CC * 4);
  static constexpr size_t YB = size_t(TM) * LDY * 4;           // y, then the output staging
  static constexpr size_t B_BYTES = max_sz(size_t(KB) * TM * 128, 2 * CHUNK);
  static constexpr bool PACK =
      2 * NC <= 64 && align1024(max_sz(YB, 2 * W1B + 2 * W2B + 2 * ACTB)) + B_BYTES + 1024 >
                          SMEM_MAX;
  static constexpr size_t W1 = 0, W2 = 2 * W1B, ACT = W2 + (PACK ? 1 : 2) * W2B;
  static constexpr size_t A_BYTES = max_sz(YB, ACT + 2 * ACTB);
  static constexpr size_t Z = align1024(A_BYTES);                 // dt(z) [TM px, CP] (A of fc1)
  static constexpr size_t BYTES = Z + B_BYTES;
  static_assert(NC <= 64 && NC % 16 == 0, "a chunk is one 64-column block");
  static_assert(W1B % 1024 == 0 && W2B % 1024 == 0, "swizzled tiles 1024-byte aligned");
  static_assert(BYTES + 1024 <= SMEM_MAX, "the layout fits an SM");
};

// Issue the cp.async copies of hidden chunk j0 .. j0 + NC - 1 of w1'^T [4C, C]
// (its rows) into w1 tile `slot` of layout L, zero past C.
template <typename L>
__device__ __forceinline__ void load_w1(unsigned char* S, const bf16* w1t, int C, int j0,
                                        int slot) {
  constexpr int NC = L::NC;
  unsigned char* dst = S + L::W1 + slot * L::W1B;
  constexpr int CH = L::CP / 8;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < NC * CH; i += NT) {
    const int n = i / CH, ch = i % CH;
    const bool in = ch * 8 < C;
    cp_async16_zfill(dst + sm90::swz(NC, n, ch * 8), in ? w1t + size_t(j0 + n) * C + ch * 8 : w1t,
                     in);
  }
}

// The same chunk of w2'^T [C, 4C] (its columns) into w2 tile `slot` (PACK:
// into columns NC slot .. of the one tile), zero past C.
template <typename L>
__device__ __forceinline__ void load_w2(unsigned char* S, const bf16* w2t, int C, int j0,
                                        int slot) {
  constexpr int NC = L::NC;
  unsigned char* dst = S + L::W2 + (L::PACK ? 0 : slot * L::W2B);
  const int k0 = L::PACK ? slot * NC : 0;  // the chunk's first column in the tile
  constexpr int CH = NC / 8;  // 16-byte pieces of a chunk row
  for (int i = threadIdx.x; i < L::CP * CH; i += NT) {
    const int c = i / CH, ch = i % CH;
    const bool in = c < C;
    cp_async16_zfill(dst + sm90::swz(L::CP, c, k0 + ch * 8),
                     in ? w2t + size_t(c) * 4 * C + j0 + ch * 8 : w2t, in);
  }
}

// The activation on fc1's accumulators (bias added): K1's tanh-GELU, or the
// lab's identity or bf16 tanh-GELU. The identity is a round trip through
// bf16, the bits that the pack into dt(a) rounds to anyway: with the bare
// identity ptxas crashes (signal 11) on MLP at CP = 384.
template <int PHASE> __device__ __forceinline__ float k1_act(float v) {
  if constexpr (PHASE == MLP) return round_bf16(v);
  else if constexpr (PHASE == MLPGELUBF16) return gelu_tanh_bf16(round_bf16(v));
  else return gelu_tanh(v);
}

// One CTA per 8 x TW pixels. CP >= C is the instantiation's width (channels
// past C are zero in dt(z) and in the weight tiles). SAVE: also write y.
template <int CP, int NC, int TM, bool SAVE, int PHASE = FULL, int SCHED = ROWREG>
__global__ void __launch_bounds__(NT, CP <= 96 && TM == 64 ? 2 : 1)
k1_forward_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                  bf16* __restrict__ yout,             // [B][H][W][C] when SAVE
                  const float* __restrict__ dw,        // [49][C] fp32 taps
                  const float* __restrict__ dwb,       // [C]
                  const bf16* __restrict__ w1t,        // [4C][C] dt(w1')^T
                  const float* __restrict__ b1,        // [4C]
                  const bf16* __restrict__ w2t,        // [C][4C] dt(w2')^T
                  const float* __restrict__ b2,        // [C]
                  int H, int W, int C, float eps) {
  using G = Tile<TM>;
  using L = Smem<CP, NC, G>;
  static_assert(PHASE == FULL || !SAVE, "the lab's phases have no saving form");
  static_assert(PHASE == DW || SCHED == ROWREG, "a dw schedule belongs to the DW phase");
  static_assert(sched_scratch_bytes<G, SCHED>() <= L::Z, "a dw schedule's fp32 copy fits in A");
  constexpr int TH = G::TH, TW = G::TW, MW = G::MW;
  // columns per warpgroup of fc1 (of the chunk) and of fc2 (of the output):
  // half of them at TM = 64, all at TM = 128
  constexpr int NH = NC * MW / 2, ND = CP * MW / 2, KS = CP / 16, KD = NC / 16;
  constexpr int PX = G::PX, HALO_W = G::HALO_W;
  extern __shared__ unsigned char k1h_smem[];
  unsigned char* S = sm90::smem_base(k1h_smem);
  float* ys = reinterpret_cast<float*>(S);  // [TM][LDY]
  unsigned char* zt = S + L::Z;             // dt(z), swizzled
  unsigned char* p1 = zt;                   // phase-1 scratch, before z is written

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int w0 = (t % tiles_w) * TW;
  t /= tiles_w;
  const int h0 = (t % tiles_h) * TH;
  const int b = t / tiles_h;
  const size_t img = size_t(b) * H * W * C;
  const bf16* xb = x + img;
  bf16* ob = out + img;
  bf16* yb = SAVE ? yout + img : nullptr;

  // ---- phase 1: depthwise 7x7 (SAME), the first design's code ----
  if constexpr (PHASE < MLP) {
    const int c = tid % CC;
    const int r = tid / CC;  // tile row; its PX = TW pixels
    const int nchunk = (C + CC - 1) / CC;
    auto load_halo = [&](int k) {
      unsigned char* buf = p1 + (k & 1) * L::CHUNK;
      bf16* halo = reinterpret_cast<bf16*>(buf);
      float* dws = reinterpret_cast<float*>(buf + L::HALO);
      const int c0 = k * CC;
      constexpr int SEGS = CC / 8;
      for (int i = tid; i < G::HALO_H * HALO_W * SEGS; i += NT) {
        const int cc = (i % SEGS) * 8;
        const int pix = i / SEGS;
        const int gh = h0 - 3 + pix / HALO_W;
        const int gw = w0 - 3 + pix % HALO_W;
        const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + cc < C;
        cp_async16_zfill(halo + pix * CC + cc, in ? xb + (size_t(gh) * W + gw) * C + c0 + cc : xb,
                         in);
      }
      if constexpr (PHASE != COPY) {
        constexpr int TSEGS = CC / 4;
        for (int i = tid; i < 49 * TSEGS; i += NT) {
          const int cc = (i % TSEGS) * 4;
          const int tap = i / TSEGS;
          const bool in = c0 + cc < C;
          cp_async16_zfill(dws + tap * CC + cc, in ? dw + size_t(tap) * C + c0 + cc : dw, in);
        }
      }
    };
    load_halo(0);
    cp_async_commit();
    for (int k = 0; k < nchunk; ++k) {
      if (k + 1 < nchunk) load_halo(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const unsigned char* buf = p1 + (k & 1) * L::CHUNK;
      const bf16* halo = reinterpret_cast<const bf16*>(buf);
      const float* dws = reinterpret_cast<const float*>(buf + L::HALO);
      const int c0 = k * CC;
      if constexpr (dw_only(PHASE)) {  // straight to the output (the fp32 copies in A)
        lab_dw_chunk<G, PHASE, SCHED>(halo, dws, ys, ob, c0, h0, w0, H, W, C);
      } else {
        float acc[PX];
        dw_rowreg<G>(halo, dws, r, 0, c, acc);
        if (c0 + c < C) {
          const float bias = dwb[c0 + c];
#pragma unroll
          for (int o = 0; o < PX; ++o) ys[(r * TW + o) * L::LDY + c0 + c] = acc[o] + bias;
        }
      }
      __syncthreads();
    }
  }

  // The dw-only phases end here; the blocks below keep K1's indentation.
  if constexpr (!dw_only(PHASE)) {
  if constexpr (PHASE >= MLP) {
    // ---- the lab's MLP phases: dt(x) of the tile into the swizzled A tile
    // (zero outside the image and past C), landed with chunk 0's weights ----
    constexpr int CH = CP / 8;  // 16-byte pieces of a pixel's channels
    for (int i = tid; i < TM * CH; i += NT) {
      const int p = i / CH, ch = i % CH;
      const int gh = h0 + p / TW, gw = w0 + p % TW;
      const bool in = gh < H && gw < W && ch * 8 < C;
      cp_async16_zfill(zt + sm90::swz(TM, p, ch * 8),
                       in ? xb + (size_t(gh) * W + gw) * C + ch * 8 : xb, in);
    }
  } else {
  // ---- LayerNorm (fp32 moments), dt(z) into the swizzled A tile ----
  {
    const float inv_c = 1.0f / float(C);
    for (int pi = 0; pi < TM / NWARP; ++pi) {
      const int p = warp * (TM / NWARP) + pi;
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = ys[p * L::LDY + c];
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
      const bool save = SAVE && h0 + p / TW < H && w0 + p % TW < W;
      bf16* yp = save ? yb + (size_t(h0 + p / TW) * W + w0 + p % TW) * C : nullptr;
      for (int c = lane; c < CP; c += 32) {
        bf16* zp = reinterpret_cast<bf16*>(zt + sm90::swz(TM, p, c));
        if (c < C) {
          const float v = ys[p * L::LDY + c];
          *zp = __float2bfloat16(v * rs - mr);
          if (save) yp[c] = __float2bfloat16(v);
        } else {
          *zp = __float2bfloat16(0.f);
        }
      }
    }
  }
  }
  sm90::fence_proxy();  // dt(z), written by st.shared, is read by wgmma
  __syncthreads();      // z complete; y is dead: region A takes the weights

  if constexpr (PHASE == DWLN) {
    // ---- the lab's DWLN: z out of its A tile, 16 bytes per 8 channels ----
    const int cv = C / 8;
    for (int i = tid; i < TM * cv; i += NT) {
      const int p = i / cv, c = (i % cv) * 8;
      const int gh = h0 + p / TW, gw = w0 + p % TW;
      if (gh < H && gw < W)
        *reinterpret_cast<uint4*>(ob + (size_t(gh) * W + gw) * C + c) =
            *reinterpret_cast<const uint4*>(zt + sm90::swz(TM, p, c));
    }
  } else {
  // ---- phase 2: hidden chunks, both products on wgmma ----
  // Chunk k's fc2 and chunk k+1's fc1 run together, and GELU(k+1) under
  // fc2(k); chunk j's weights sit in tile j % 2 of their ring, w1'^T loaded
  // two chunks ahead of its product and w2'^T one; one barrier per chunk.
  const int wg = tid >> 7, wi = warp & 3;  // warpgroup, warp in it
  // this warpgroup's rows (m0 ..) and its first columns of fc1 (n1) and fc2 (n2)
  const int m0 = MW == 2 ? 64 * wg : 0, n1 = MW == 2 ? 0 : wg * NH, n2 = MW == 2 ? 0 : wg * ND;
  const int row0 = m0 + 16 * wi + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);              // and columns 8 i + col0 (+1)
  const int nchunk = 4 * C / NC;
  float oacc[ND / 2], hacc[NH / 2];
#pragma unroll
  for (int i = 0; i < ND / 2; ++i) oacc[i] = 0.f;

  // h1 = dt(z) w1'^T-chunk j: the warpgroup's rows, the chunk's columns n1 ..
  auto fc1 = [&](int j) {
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) hacc[i] = 0.f;
    const unsigned char* w1s = S + L::W1 + (j & 1) * L::W1B;
    sm90::fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const size_t ka = size_t(s >> 2) * TM * 128 + size_t(m0) * 128 + (s & 3) * 32;
      const size_t kb = size_t(s >> 2) * NC * 128 + size_t(n1) * 128 + (s & 3) * 32;
      sm90::Mma<NH>::run(hacc, sm90::desc(zt + ka), sm90::desc(w1s + kb));
    }
    sm90::commit();
  };
  // bias and GELU on the accumulators of chunk j, dt(a) into its A tile
  auto gelu = [&](int j) {
    fence_regs(hacc);
    unsigned char* act = S + L::ACT + (j & 1) * L::ACTB;
    const int j0 = j * NC;
#pragma unroll
    for (int i = 0; i < NH / 8; ++i) {
      const int n = n1 + 8 * i + col0;  // column in the chunk
      const float bb0 = __ldg(b1 + j0 + n), bb1 = __ldg(b1 + j0 + n + 1);
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const __nv_bfloat162 a2 =
            __floats2bfloat162_rn(k1_act<PHASE>(hacc[4 * i + 2 * hv] + bb0),
                                  k1_act<PHASE>(hacc[4 * i + 2 * hv + 1] + bb1));
        *reinterpret_cast<__nv_bfloat162*>(act + sm90::swz(TM, row0 + 8 * hv, n)) = a2;
      }
    }
    sm90::fence_proxy();  // dt(a), written by st.shared, is read by wgmma
  };
  // out += dt(a) w2'^T-chunk j: the warpgroup's rows, output columns n2 ..
  auto fc2 = [&](int j) {
    const unsigned char* act = S + L::ACT + (j & 1) * L::ACTB + size_t(m0) * 128;
    const unsigned char* w2s =
        S + L::W2 + (L::PACK ? 0 : (j & 1) * L::W2B) + size_t(n2) * 128;
    const int kb = L::PACK ? (j & 1) * NC * 2 : 0;  // the chunk's byte offset in a row
    sm90::fence();
#pragma unroll
    for (int s = 0; s < KD; ++s)
      sm90::Mma<ND>::run(oacc, sm90::desc(act + s * 32), sm90::desc(w2s + kb + s * 32));
    sm90::commit();
  };
  // the top of chunk k: its w2'^T and chunk k+1's w1'^T landed and visible,
  // dt(a) of chunk k complete, fc1(k) and fc2(k-1) done in every thread
  auto chunk_barrier = [&]() {
    cp_async_wait<0>();
    sm90::fence_proxy();
    __syncthreads();
  };

  load_w1<L>(S, w1t, C, 0, 0);
  load_w2<L>(S, w2t, C, 0, 0);
  cp_async_commit();
  if (nchunk > 1) load_w1<L>(S, w1t, C, NC, 1);
  cp_async_commit();
  cp_async_wait<1>();  // chunk 0
  sm90::fence_proxy();
  __syncthreads();
  fc1(0);
  sm90::wait<0>();
  gelu(0);
  // every chunk but the last: no wgmma under a condition, so that the
  // compiler can pair each wait with its products and keep them in flight
  for (int k = 0; k + 1 < nchunk; ++k) {
    chunk_barrier();  // the tiles of w1'^T(k) and w2'^T(k-1) are free
    load_w2<L>(S, w2t, C, (k + 1) * NC, (k + 1) & 1);
    if (k + 2 < nchunk) load_w1<L>(S, w1t, C, (k + 2) * NC, k & 1);
    cp_async_commit();
    fc1(k + 1);
    fc2(k);
    sm90::wait<1>();  // fc1(k+1) done; fc2(k) may run on
    gelu(k + 1);
    sm90::wait<0>();
  }
  chunk_barrier();
  fc2(nchunk - 1);
  sm90::wait<0>();
  fence_regs(oacc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the weight and dt(a) tiles

  // ---- epilogue: b2' from the accumulators into an fp32 staging tile, then
  // the residual in fp32, one cast and one 16-byte store per 8 channels ----
  float* so = reinterpret_cast<float*>(S);  // [TM][LDY], over the dead ring
#pragma unroll
  for (int i = 0; i < ND / 8; ++i) {
    const int c = n2 + 8 * i + col0;
    if (c < C) {
      const float bb0 = __ldg(b2 + c), bb1 = __ldg(b2 + c + 1);
#pragma unroll
      for (int hv = 0; hv < 2; ++hv)
        *reinterpret_cast<float2*>(so + (row0 + 8 * hv) * L::LDY + c) =
            make_float2(oacc[4 * i + 2 * hv] + bb0, oacc[4 * i + 2 * hv + 1] + bb1);
    }
  }
  __syncthreads();
  const int cv = C / 8;
  for (int i = tid; i < TM * cv; i += NT) {
    const int p = i / cv, c = (i % cv) * 8;
    const int gh = h0 + p / TW, gw = w0 + p % TW;
    if (gh < H && gw < W) {
      const size_t off = (size_t(gh) * W + gw) * C + c;
      const uint4 xin = *reinterpret_cast<const uint4*>(xb + off);
      const bf16* xe = reinterpret_cast<const bf16*>(&xin);
      const float4 o0 = *reinterpret_cast<const float4*>(so + p * L::LDY + c);
      const float4 o1 = *reinterpret_cast<const float4*>(so + p * L::LDY + c + 4);
      const float ov[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      uint4 res;
      bf16* re = reinterpret_cast<bf16*>(&res);
#pragma unroll
      for (int e = 0; e < 8; ++e) re[e] = __float2bfloat16(__bfloat162float(xe[e]) + ov[e]);
      *reinterpret_cast<uint4*>(ob + off) = res;
    }
  }
  }  // phase 2 and the epilogue
  }  // every phase but the dw-only ones
}

// One instantiation per channel range: CP, the hidden chunk NC and the tile
// TM (and for the lab a PHASE and a dw schedule). With `info`, launch
// nothing and report {TM, TH, TW, CTAs per SM, shared-memory bytes per CTA,
// NC} instead.
template <int CP, int NC, int TM, bool SAVE, int PHASE = FULL, int SCHED = ROWREG>
int launch_h(const void* x, void* out, void* y, const float* dw, const float* dwb,
             const void* w1t, const float* b1, const void* w2t, const float* b2, int B, int H,
             int W, int C, float eps, cudaStream_t stream, int* info) {
  using G = Tile<TM>;
  const int bytes = int(Smem<CP, NC, G>::BYTES) + 1024;
  auto kern = k1_forward_kernel<CP, NC, TM, SAVE, PHASE, SCHED>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  if (info) {
    info[0] = TM;
    info[1] = G::TH;
    info[2] = G::TW;
    info[4] = bytes;
    info[5] = NC;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kern, NT, bytes));
  }
  const long long tiles =
      (long long)B * ((H + G::TH - 1) / G::TH) * ((W + G::TW - 1) / G::TW);
  kern<<<unsigned(tiles), NT, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<bf16*>(y), dw, dwb,
      static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t), b2, H, W, C, eps);
  return int(cudaGetLastError());
}

// K1's launch table: the instantiation (CP, NC, TM) of each channel range.
// The kernel lab (csrc/kernel_lab.cu) runs its phases at these tiles.
template <bool SAVE>
int forward(const void* x, void* out, void* y, const float* dw, const float* dwb, const void* w1t,
            const float* b1, const void* w2t, const float* b2, int B, int H, int W, int C,
            float eps, cudaStream_t stream, int* info = nullptr) {
#define K1H_LAUNCH(CP, NC, TM) \
  launch_h<CP, NC, TM, SAVE>(x, out, y, dw, dwb, w1t, b1, w2t, b2, B, H, W, C, eps, stream, info)
  if (C <= 48) return K1H_LAUNCH(48, 64, 64);
  if (C <= 96) return K1H_LAUNCH(96, 64, 64);
  if (C <= 192) return K1H_LAUNCH(192, 64, 128);
  if (C <= 384) return K1H_LAUNCH(384, 32, 64);
  return K1H_LAUNCH(512, 32, 64);
#undef K1H_LAUNCH
}

}  // namespace k1h
}  // namespace cnb
