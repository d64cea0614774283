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
//   * Hopper design (namespace k1h; bf16, C <= 384; the route below): TM =
//     64 pixels per CTA (an 8 x 8 tile; wgmma's M), 128 (8 x 16) at C = 192,
//     in two warpgroups. LN writes dt(z) straight into a K-major
//     128-byte-swizzled A tile (csrc/wgmma.cuh). For each chunk of NC hidden
//     columns: h1 = dt(z) w1'^T-chunk on wgmma, bias and tanh-GELU on the
//     accumulator registers, dt(a) written straight into a swizzled A tile,
//     then out[TM, C] += dt(a) w2'^T-chunk on wgmma into fp32 accumulators.
//     At TM = 64 both warpgroups share the 64 rows and split each product's
//     columns (C/2 accumulators each: 96 registers a thread at C = 384); at
//     TM = 128 each warpgroup owns 64 rows and all the columns. The products
//     are pipelined: chunk k's fc2 and chunk k+1's fc1 are in flight
//     together, GELU(k+1) runs under fc2(k), one barrier per chunk. The
//     weights, w1'^T [4C, C] and w2'^T [C, 4C] (both K-major: the torch
//     layouts of w1 and w2, folded without a transpose), come by cp.async
//     through two tiles each, w1'^T two chunks ahead of its product and
//     w2'^T one. The epilogue adds b2' and x in fp32 and writes 16 bytes per
//     store. NC = 64 (32 at C = 384, where the tiles, dt(z) and the
//     accumulators fill the SM); two CTAs per SM at C <= 96. What holds it
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
//     which the kernel lab csrc/kernel_lab.cu shares): TM = 128 / 64 / 64 /
//     32 pixels per CTA at C <= 128 / 384 / 384 / 768; nvcuda::wmma on 16 x 16
//     fragments (bf16 x bf16 -> fp32, TF32 for fp32 inputs) by 8 warps as 2
//     rows x 4 columns; fc1 fragments staged through an fp32 tile for bias +
//     GELU; weights through a 2-deep ring of KS x NH tiles, one barrier per
//     tile. It runs fp32, bf16 at C > 384 (where the output accumulators
//     alone would take 192 registers a thread at 64 pixels), and, through its
//     own entry cnb_forward_v0, the "before" of the Hopper design and the
//     kernel lab's `full`.
//
// The route (cnb_forward_route, which the wrapper asks to pick the operands'
// layouts): bf16 up to C = 384 runs the Hopper design, the rest the first.
//
// Numerics (both designs; match the plain twin convnext_block_plain): dwconv
// with fp32 taps and fp32 accumulation; LN moments in fp32 as E[y^2] - mean^2
// clamped at 0; the normalised tensor and the post-GELU hidden layer are cast
// to the compute dtype before their matrix products; GELU in the sigmoid form
// of the tanh form (cuda_common.cuh); the residual is added in fp32, then
// cast. Phase 1 is the same code in both, so the saving form's y is the same
// bits; the products sum in other orders.

#include "convnext_block.cuh"
#include "wgmma.cuh"

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

// ===========================================================================
// K1 in bf16 on Hopper (C <= 384): the two products on wgmma.
// ===========================================================================
namespace k1h {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // two warpgroups
constexpr int HMAXC = 384;       // widest C this design holds on chip
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
// columns are one 128-byte-swizzled block (half of it at NC = 32).
template <int CP_, int NC_, typename G>
struct Smem {
  static constexpr int CP = CP_, NC = NC_, TM = G::TM;
  static constexpr int KB = (CP + 63) / 64;              // 64-column blocks of C
  static constexpr int LDY = CP + 8;                     // no bank conflicts in the staging
  static constexpr size_t W1B = size_t(KB) * NC * 128;   // w1'^T chunk [NC, CP] (B of fc1)
  static constexpr size_t W2B = size_t(CP) * 128;        // w2'^T chunk [CP, NC] (B of fc2)
  static constexpr size_t ACTB = size_t(TM) * 128;       // dt(a) [TM px, NC] (A of fc2)
  static constexpr size_t W1 = 0, W2 = 2 * W1B, ACT = W2 + 2 * W2B;
  static constexpr size_t A_BYTES = max_sz(size_t(TM) * LDY * 4, ACT + 2 * ACTB);
  static constexpr size_t HALO = align128(size_t(G::HALO_H) * G::HALO_W * CC * 2);
  static constexpr size_t CHUNK = HALO + align128(size_t(49) * CC * 4);
  static constexpr size_t Z = align1024(A_BYTES);                 // dt(z) [TM px, CP] (A of fc1)
  static constexpr size_t BYTES = Z + max_sz(size_t(KB) * TM * 128, 2 * CHUNK);
  static_assert(NC <= 64 && NC % 16 == 0, "a chunk is one 64-column block");
  static_assert(W1B % 1024 == 0 && W2B % 1024 == 0, "swizzled tiles 1024-byte aligned");
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

// The same chunk of w2'^T [C, 4C] (its columns) into w2 tile `slot`, zero
// past C.
template <typename L>
__device__ __forceinline__ void load_w2(unsigned char* S, const bf16* w2t, int C, int j0,
                                        int slot) {
  constexpr int NC = L::NC;
  unsigned char* dst = S + L::W2 + slot * L::W2B;
  constexpr int CH = NC / 8;  // 16-byte pieces of a chunk row
  for (int i = threadIdx.x; i < L::CP * CH; i += NT) {
    const int c = i / CH, ch = i % CH;
    const bool in = c < C;
    cp_async16_zfill(dst + sm90::swz(L::CP, c, ch * 8),
                     in ? w2t + size_t(c) * 4 * C + j0 + ch * 8 : w2t, in);
  }
}

// One CTA per 8 x TW pixels. CP >= C is the instantiation's width (channels
// past C are zero in dt(z) and in the weight tiles). SAVE: also write y.
template <int CP, int NC, int TM, bool SAVE>
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
  {
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
      constexpr int TSEGS = CC / 4;
      for (int i = tid; i < 49 * TSEGS; i += NT) {
        const int cc = (i % TSEGS) * 4;
        const int tap = i / TSEGS;
        const bool in = c0 + cc < C;
        cp_async16_zfill(dws + tap * CC + cc, in ? dw + size_t(tap) * C + c0 + cc : dw, in);
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
      float acc[PX];
      dw_rowreg<G>(halo, dws, r, 0, c, acc);
      if (c0 + c < C) {
        const float bias = dwb[c0 + c];
#pragma unroll
        for (int o = 0; o < PX; ++o) ys[(r * TW + o) * L::LDY + c0 + c] = acc[o] + bias;
      }
      __syncthreads();
    }
  }

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
  sm90::fence_proxy();  // dt(z), written by st.shared, is read by wgmma
  __syncthreads();      // z complete; y is dead: region A takes the weights

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
        const __nv_bfloat162 a2 = __floats2bfloat162_rn(gelu_tanh(hacc[4 * i + 2 * hv] + bb0),
                                                        gelu_tanh(hacc[4 * i + 2 * hv + 1] + bb1));
        *reinterpret_cast<__nv_bfloat162*>(act + sm90::swz(TM, row0 + 8 * hv, n)) = a2;
      }
    }
    sm90::fence_proxy();  // dt(a), written by st.shared, is read by wgmma
  };
  // out += dt(a) w2'^T-chunk j: the warpgroup's rows, output columns n2 ..
  auto fc2 = [&](int j) {
    const unsigned char* act = S + L::ACT + (j & 1) * L::ACTB + size_t(m0) * 128;
    const unsigned char* w2s = S + L::W2 + (j & 1) * L::W2B + size_t(n2) * 128;
    sm90::fence();
#pragma unroll
    for (int s = 0; s < KD; ++s)
      sm90::Mma<ND>::run(oacc, sm90::desc(act + s * 32), sm90::desc(w2s + s * 32));
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
}

// One instantiation per channel range: CP, the hidden chunk NC and the tile
// TM. With `info`, launch nothing and report {TM, TH, TW, CTAs per SM,
// shared-memory bytes per CTA, NC} instead.
template <int CP, int NC, int TM, bool SAVE>
int launch_h(const void* x, void* out, void* y, const float* dw, const float* dwb,
             const void* w1t, const float* b1, const void* w2t, const float* b2, int B, int H,
             int W, int C, float eps, cudaStream_t stream, int* info) {
  using G = Tile<TM>;
  const int bytes = int(Smem<CP, NC, G>::BYTES) + 1024;
  auto kern = k1_forward_kernel<CP, NC, TM, SAVE>;
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

template <bool SAVE>
int forward(const void* x, void* out, void* y, const float* dw, const float* dwb, const void* w1t,
            const float* b1, const void* w2t, const float* b2, int B, int H, int W, int C,
            float eps, cudaStream_t stream, int* info = nullptr) {
#define K1H_LAUNCH(CP, NC, TM) \
  launch_h<CP, NC, TM, SAVE>(x, out, y, dw, dwb, w1t, b1, w2t, b2, B, H, W, C, eps, stream, info)
  if (C <= 48) return K1H_LAUNCH(48, 64, 64);
  if (C <= 96) return K1H_LAUNCH(96, 64, 64);
  if (C <= 192) return K1H_LAUNCH(192, 64, 128);
  return K1H_LAUNCH(384, 32, 64);
#undef K1H_LAUNCH
}

}  // namespace k1h

inline bool bad_shape(int B, int H, int W, int C) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || C > MAXC;
}

// K1's bf16 calls up to C = 384 run the Hopper design (namespace k1h); fp32
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
// design, and the kernel lab's `full`.
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
// TH, TW, CTAs per SM}. The kernel lab matches its tiles to it. Launches
// nothing; returns the CUDA error of the query, or 0.
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

// The Hopper design's tile at width C (bf16, C <= 384), inference form (save
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
