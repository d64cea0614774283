// Depthwise 7x7 convolution (stride 1, SAME, fp32 taps and accumulation,
// fp32 output) for Hopper: the device code shared by csrc/dwconv.cu (kernel
// K3, the standalone op) and csrc/convnext_block_bwd.cu (the recompute of
// the block's dwconv output y in the recompute-form backward, with the dw
// bias added). The first design, the "before", is csrc/dwconv_v0.cuh; the
// two give the same bits.
//
// Replaces the TPU kernel multitask_bonetumor_yolo_tpu/ops/pallas/dwconv.py::
// _kernel (driven by dwconv7): out[b,h,w,c] = bias[c] + sum_{i,j < 7}
// x[b, h+i-3, w+j-3, c] * taps[i][j][c], x zero outside the image. Each
// output is one fmaf chain from 0.0f over tap rows i (outer) and columns j
// (inner), then + bias: the first design's order, so its bits.
//
// What bounds it on an H100: x is read once and the fp32 output written
// once (2 + 4 bytes per value in bf16, 4 + 4 in fp32), against 49 fp32 FMAs
// per value (67 TFLOP/s): near the ridge in bf16, so the FMAs and the few
// instructions around them have to overlap the bytes, not follow them.
//
// The design: persistent CTAs (about SMs x the CTAs that fit per SM), each
// walking work units (image, 32-channel chunk, column strip of TW = warps x
// PX columns, row segment) down the rows. Lane l owns channel c0 + l, warp w
// the PX = 5 columns w0 + 5w .. of the strip, and the thread keeps
//   * the chunk's 49 taps of its channel in registers for the whole unit
//     (loaded once per unit, not once per tile);
//   * 7 rows x PX columns of fp32 accumulators: input row k, once loaded and
//     converted (PX + 6 values, loaded a row ahead of its FMAs), feeds the 7
//     output rows k-6 .. k at tap rows 6 .. 0 (49 PX FMAs); output row k-6
//     is then complete and stored, and its registers start output row k+1.
//     So each x value in shared memory is read and converted once per
//     thread that needs it ((PX + 6) / PX per output) and the six overlap
//     rows between bands live on as partial sums, not as reloaded rows. The
//     accumulator slot of output m is m mod 7, static in the 7-row unrolled
//     band.
// PX = 5 keeps the kernel at 160 registers, three 4-warp CTAs per SM; 8
// pixels per thread (fewer loads per output) took 162-168 registers, two
// 5-warp CTAs per SM, and ran 27 % slower at 160^2 x 96 (0.083 against
// 0.065 ms on an H100, PERF.md). 5 divides the trunk's widths 160 / 80 /
// 40 / 20, so a strip of 4 warps (TW = 20) wastes no lane there.
// A completed output row goes, plus the bias, into one of the warp's two
// shared-memory staging rows (PX pixels x 32 fp32 channels) and leaves by
// one TMA store per warp and row, which clips what falls outside the image
// or past C: the stores run asynchronously beside the FMAs (scattered
// 4-byte stores cost ~7 instructions per value of address arithmetic and
// predicates).
// x reaches shared memory by TMA: a 4-D tensor map over NHWC {C, W, H, B}
// with box {32, TW + 6, 7, 1} brings one band of 7 input rows per ring stage,
// out-of-bounds elements zero-filled (SAME padding, negative coordinates
// included, and channels past C), completion on the stage's mbarrier. The
// ring holds 3 stages in bf16, 2 in fp32, so the loads of the next bands
// are in flight while the current band is computed; one thread refills a
// stage after the CTA has passed it (__syncthreads). A warp reads one
// pixel's 32 channels (64 or 128 contiguous bytes) per load: no bank
// conflicts, no padding. Bands where some of the 49 (row, tap row) pairs
// fall outside the unit (its first band, its last one or two) take a
// guarded copy of the band code that skips them (warp-uniform branches),
// so no FMA is spent on an output outside the unit; the other bands run
// unguarded. Strip, band and chunk per shape come from plan() (its Python
// mirror is ops/kernels/dwconv.py::dwconv7_plan).

#pragma once

#include <cuda.h>

#include <atomic>

#include "cuda_common.cuh"

namespace cnb {
namespace dwc {
// Internal linkage: every library that includes this header (K3's and K4's)
// keeps its own copy, above all of the function-local statics in Inst,
// sm_count and encode_tiled. With external linkage those statics are unique
// symbols that the dynamic loader merges across libraries, so the second
// library loaded would skip setting the shared-memory attribute of its own
// kernels.
namespace {

constexpr int BAND = 7;       // input rows per ring stage = the accumulator period
constexpr int PX = 5;         // pixels (columns) per thread
constexpr int CC = 32;        // channels per work unit, one per lane
constexpr int MAX_WARPS = 6;  // column groups (warps) per CTA
constexpr int BARRIER_BYTES = 64;
constexpr int ALIGN_SLACK = 128;  // the stages start 128-byte aligned (TMA)
constexpr int UNIT_ROWS = 3;  // a unit's fixed cost in output rows (plan_rows)

__host__ __device__ constexpr int ring_stages(int es) { return es == 2 ? 3 : 2; }
__host__ __device__ constexpr int box_bytes(int tw, int es) { return BAND * (tw + 6) * CC * es; }
__host__ __device__ constexpr int stage_bytes(int tw, int es) {
  return int(align128(size_t(box_bytes(tw, es))));
}
// the output staging: two buffers of a row of PX pixels x 32 fp32 channels per
// warp, 256 bytes per strip column
__host__ __device__ constexpr int staging_bytes(int tw) { return 2 * tw * CC * 4; }
__host__ __device__ constexpr int smem_bytes(int tw, int es) {
  return ring_stages(es) * stage_bytes(tw, es) + staging_bytes(tw) + BARRIER_BYTES + ALIGN_SLACK;
}

// The launch's plan; dwconv7_plan (csrc/dwconv.cu) returns it in this order
struct Plan {
  int px, warps, tw, strips, chunks, segs, seg_rows, units, unit_stages, ring, stage_bytes, smem,
      ctas_per_sm, grid, sms;
};
constexpr int PLAN_FIELDS = 15;

// Warps per CTA: the fewest columns computed (strips x TW, TW = warps x PX);
// ties to more warps
inline int plan_warps(int W) {
  long long best = -1;
  int warps = 1;
  for (int nw = MAX_WARPS; nw >= 1; --nw) {
    const long long tw = (long long)nw * PX, cols = (W + tw - 1) / tw * tw;
    if (best < 0 || cols < best) best = cols, warps = nw;
  }
  return warps;
}

// Row segments: units = B x chunks x strips x segs over grid CTAs, each
// taking `rounds` units at most; the fewest rounds x (rows + stages +
// UNIT_ROWS) per unit (a stage's loads and barrier cost about one output
// row, a unit's start, its taps and its first band's latency, about
// UNIT_ROWS), ties to fewer segments. Needs px, warps, ctas_per_sm, sms.
inline int plan_rows(Plan& p, int B, int H, int W, int C, int es) {
  p.tw = p.warps * p.px;
  p.strips = (W + p.tw - 1) / p.tw;
  p.chunks = (C + CC - 1) / CC;
  p.ring = ring_stages(es);
  p.stage_bytes = stage_bytes(p.tw, es);
  p.smem = smem_bytes(p.tw, es);
  const long long units0 = (long long)B * p.chunks * p.strips;
  const long long slots = (long long)p.sms * (p.ctas_per_sm > 0 ? p.ctas_per_sm : 1);
  long long best = -1;
  for (int segs = 1; segs <= H; ++segs) {
    const int rows = (H + segs - 1) / segs;
    if ((H + rows - 1) / rows != segs) continue;  // the same split as fewer segments
    const long long units = units0 * segs, rounds = (units + slots - 1) / slots;
    const int stages = (rows + 6 + BAND - 1) / BAND;
    const long long cost = rounds * (rows + stages + UNIT_ROWS);
    if (best < 0 || cost < best) {
      best = cost;
      p.segs = segs, p.seg_rows = rows, p.unit_stages = stages;
      if (units > 0x7fffffffLL) return int(cudaErrorInvalidValue);
      p.units = int(units);
      p.grid = int((units + rounds - 1) / rounds);
    }
  }
  return 0;
}

struct Args {
  const float* taps;
  const float* bias;
  int H, C, tw, strips, chunks, segs, seg_rows, units, unit_stages, ring, stage_bytes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// this thread's shared-memory writes made visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// one box of shared memory to the 4-D tensor map (a bulk async group)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c, int w,
                                             int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(w), "r"(h), "r"(b)
      : "memory");
}
// until at most N of this thread's bulk stores still read shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// one box of the 4-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c, int w, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// Where a warp's output row goes: its staging buffers (this lane's first
// value), the output tensor map and the row's origin
struct OutRow {
  float* staging;
  const CUtensorMap* map;
  int c0, w, h0, b, lane;
  unsigned buf;
};

// One band: input rows k0 .. k0+6 of the unit (rows: this thread's first
// value of the stage's row 0, pitch pixels per row), each fed to the 7
// output rows it touches, and output row k-6 stored after input row k:
// plus the bias, into the warp's staging buffer (the other one may still be
// in flight), then one TMA store of the P x 32 box, which clips what falls
// outside the tensor. GUARD skips the (row, tap row) pairs and stores whose
// output row m is outside [0, hs).
template <bool GUARD, typename T, int P>
__device__ __forceinline__ void band(const T* __restrict__ rows, int pitch, const float (&tap)[49],
                                     float (&acc)[BAND][P], int k0, int hs, OutRow& o, float bv) {
  T next[P + 6];  // the next input row, loaded a row ahead of its FMAs
#pragma unroll
  for (int j = 0; j < P + 6; ++j) next[j] = rows[j * CC];
#pragma unroll
  for (int r = 0; r < BAND; ++r) {
    const int k = k0 + r;
    if (GUARD && k - 6 >= hs) break;  // no output of this row or the next is in the unit
    float x[P + 6];
#pragma unroll
    for (int j = 0; j < P + 6; ++j) x[j] = to_f(next[j]);
    if (r + 1 < BAND) {
#pragma unroll
      for (int j = 0; j < P + 6; ++j) next[j] = rows[((r + 1) * pitch + j) * CC];
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      if (GUARD && unsigned(k - i) >= unsigned(hs)) continue;
      float(&a)[P] = acc[(r - i + 7) % 7];  // output row k - i
#pragma unroll
      for (int j = 0; j < 7; ++j)
#pragma unroll
        for (int p = 0; p < P; ++p)
          a[p] = fmaf(x[p + j], tap[i * 7 + j], i == 0 && j == 0 ? 0.f : a[p]);
    }
    const int m = k - 6;  // complete after this row
    if (GUARD && unsigned(m) >= unsigned(hs)) continue;
    float(&a)[P] = acc[(r + 1) % 7];
    float* sb = o.staging + o.buf * (P * CC);
    if (o.lane == 0) bulk_wait_read<1>();  // the store that last read this buffer is done
    __syncwarp();
    // bv is 0.0f without a bias: a chain from +0.0f never holds -0.0f, so
    // acc + 0.0f is acc, bit for bit (and one body serves both callers)
#pragma unroll
    for (int p = 0; p < P; ++p) sb[p * CC] = a[p] + bv;
    fence_async_shared();
    __syncwarp();
    if (o.lane == 0) tma_store_4d(o.map, sb, o.c0, o.w, o.h0 + m, o.b);
    o.buf ^= 1u;
  }
}

// x [B][H][W][C] through `xmap` (T = bf16 or fp32), taps [49][C] fp32, bias
// [C] fp32 or nullptr, out [B][H][W][C] fp32 through `omap`; C a multiple of
// 16. Grid plan.grid, plan.warps x 32 threads, plan.smem bytes of dynamic
// shared memory.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
cnb_dwconv7_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap omap, const Args a) {
  constexpr int P = PX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  float* staging = reinterpret_cast<float*>(smem + a.ring * a.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.ring * a.stage_bytes +
                                               staging_bytes(a.tw));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pitch = a.tw + 6;
  const int n_units = (a.units - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const int total = n_units * a.unit_stages;

  auto origin = [&](int n, int& b, int& c0, int& w0, int& h0) {  // the CTA's n-th unit
    int u = int(blockIdx.x) + n * int(gridDim.x);
    h0 = (u % a.segs) * a.seg_rows;
    u /= a.segs;
    w0 = (u % a.strips) * a.tw;
    u /= a.strips;
    c0 = (u % a.chunks) * CC;
    b = u / a.chunks;
  };
  auto issue = [&](int g) {  // thread 0: flat stage g into ring slot g % ring
    int b, c0, w0, h0;
    origin(g / a.unit_stages, b, c0, w0, h0);
    const int s = g % a.ring;
    mbar_expect_tx(full + s, unsigned(box_bytes(a.tw, int(sizeof(T)))));
    tma_load_4d(smem + s * a.stage_bytes, &xmap, full + s, c0, w0 - 3,
                h0 - 3 + BAND * (g % a.unit_stages), b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ring; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < a.ring && g < total; ++g) issue(g);

  float tap[49];
  float acc[BAND][P];
#pragma unroll
  for (int s = 0; s < BAND; ++s)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[s][p] = 0.f;
  OutRow o{staging + warp * 2 * P * CC + lane, &omap, 0, 0, 0, 0, lane, 0u};
  for (int n = 0; n < n_units; ++n) {
    int b, c0, w0, h0;
    origin(n, b, c0, w0, h0);
    const int c = c0 + lane;
    const bool lane_ok = c < a.C;
#pragma unroll
    for (int t = 0; t < 49; ++t) tap[t] = lane_ok ? a.taps[size_t(t) * a.C + c] : 0.f;
    const float bv = a.bias != nullptr && lane_ok ? a.bias[c] : 0.f;
    const int hs = min(a.seg_rows, a.H - h0);
    o.c0 = c0, o.w = w0 + warp * P, o.h0 = h0, o.b = b;
    for (int t = 0; t < a.unit_stages; ++t) {
      const int g = n * a.unit_stages + t, s = g % a.ring;
      mbar_wait(full + s, unsigned(g / a.ring) & 1u);
      const T* rows = reinterpret_cast<const T*>(smem + s * a.stage_bytes) + warp * P * CC + lane;
      if (t > 0 && BAND * t + BAND <= hs)
        band<false>(rows, pitch, tap, acc, BAND * t, hs, o, bv);
      else
        band<true>(rows, pitch, tap, acc, BAND * t, hs, o, bv);
      __syncthreads();  // every thread is past stage s: refill it
      if (threadIdx.x == 0 && g + a.ring < total) {
        fence_async_shared();  // the CTA's reads of stage s before the TMA's writes
        issue(g + a.ring);
      }
    }
  }
  if (lane == 0) bulk_wait_all();  // the staging buffers stay until the last store is done
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

constexpr int MAX_DEVICES = 64;  // device ordinals the per-device caches below hold

// The current device's ordinal, or -1 (none, or past MAX_DEVICES)
inline int current_device() {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < MAX_DEVICES ? dev : -1;
}

// Per dtype and per device: the shared-memory attribute, set once (at the
// widest strip) on each device, and the CTAs that fit per SM at each warp
// count, asked once on each device. A kernel's attribute belongs to the
// device that was current when it was set: a process that launches on a
// second card must set it there too. A slot at 0 is not done yet.
template <typename T>
struct Inst {
  static int prepare() {
    static std::atomic<int> done[MAX_DEVICES];
    const int dev = current_device();
    if (dev < 0) return int(cudaErrorInvalidDevice);
    if (done[dev].load(std::memory_order_acquire)) return 0;
    const int rc = int(cudaFuncSetAttribute(cnb_dwconv7_kernel<T>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            smem_bytes(MAX_WARPS * PX, int(sizeof(T)))));
    if (!rc) done[dev].store(1, std::memory_order_release);
    return rc;
  }
  static int ctas_per_sm(int warps) {
    static std::atomic<int> occ[MAX_DEVICES][MAX_WARPS + 1];
    const int dev = current_device();
    if (dev < 0) return 0;
    int n = occ[dev][warps].load(std::memory_order_relaxed);
    if (!n) {
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cnb_dwconv7_kernel<T>, warps * 32,
                                                        smem_bytes(warps * PX, int(sizeof(T)))) !=
          cudaSuccess)
        return 0;
      occ[dev][warps].store(n, std::memory_order_relaxed);
    }
    return n;
  }
};

inline int sm_count() {
  static std::atomic<int> sms[MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0) return 0;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (!n) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The plan on the current device; returns a CUDA error, or 0
template <typename T>
int plan(int B, int H, int W, int C, Plan& p) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0) return int(cudaErrorInvalidValue);
  p.px = PX;
  p.warps = plan_warps(W);
  const int rc = Inst<T>::prepare();
  if (rc) return rc;
  p.ctas_per_sm = Inst<T>::ctas_per_sm(p.warps);
  p.sms = sm_count();
  if (p.ctas_per_sm <= 0 || p.sms <= 0) return int(cudaErrorInvalidConfiguration);
  return plan_rows(p, B, H, W, C, int(sizeof(T)));
}

// Launch on `s`; returns the CUDA error of the launch, or 0 (a tensor map
// cuTensorMapEncodeTiled refuses: cudaErrorInvalidValue).
template <typename T>
int dwconv7_launch(const T* x, const float* taps, const float* bias, float* out, int B, int H,
                   int W, int C, cudaStream_t s) {
  Plan p{};
  int rc = plan<T>(B, H, W, C, p);
  if (rc) return rc;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return int(cudaErrorSymbolNotFound);
  constexpr int es = int(sizeof(T));
  // NHWC {C, W, H, B}: x in boxes of 7 rows x (TW + 6) pixels x 32 channels,
  // the output in boxes of one row of P pixels x 32 channels
  auto make_map = [&](CUtensorMap* m, const void* ptr, int bytes, CUtensorMapDataType dt,
                      cuuint32_t pixels, cuuint32_t rows) {
    const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
    const cuuint64_t strides[3] = {cuuint64_t(C) * bytes, cuuint64_t(W) * C * bytes,
                                   cuuint64_t(H) * W * C * bytes};
    const cuuint32_t box[4] = {cuuint32_t(CC), pixels, rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(m, dt, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUtensorMap xmap, omap;
  if (make_map(&xmap, x, es, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               cuuint32_t(p.tw + 6), BAND) != CUDA_SUCCESS ||
      make_map(&omap, out, 4, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cuuint32_t(p.px), 1) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  const Args args{taps, bias, H, C, p.tw, p.strips, p.chunks, p.segs, p.seg_rows,
                  p.units, p.unit_stages, p.ring, p.stage_bytes};
  cnb_dwconv7_kernel<T><<<p.grid, p.warps * 32, p.smem, s>>>(xmap, omap, args);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace dwc
}  // namespace cnb
