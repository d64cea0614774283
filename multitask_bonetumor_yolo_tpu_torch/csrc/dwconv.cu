// Kernel K3: the standalone depthwise 7x7 convolution (stride 1, SAME, fp32
// taps and accumulation, fp32 output) for Hopper (sm_90a), CUDA C++ with a
// plain C interface (built with nvcc into a shared library, loaded with
// ctypes). The device code, and the note on what bounds it and how it is
// laid out, are in csrc/dwconv.cuh (the Hopper design, which
// csrc/convnext_block_bwd.cu shares) and csrc/dwconv_v0.cuh (the first
// design, the "before"; the same bits).
//
// Replaces the TPU kernel multitask_bonetumor_yolo_tpu/ops/pallas/dwconv.py::
// _kernel (driven by dwconv7), which the block's explicit backward runs
// twice (the recompute of y, and dx as the correlation with flipped taps).

#include "dwconv.cuh"
#include "dwconv_v0.cuh"

namespace {

template <template <typename> class Launch>
int forward(const void* x, const void* taps, const void* bias, void* out, int B, int H, int W,
            int C, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0) return int(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(taps);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return Launch<__nv_bfloat16>::run(static_cast<const __nv_bfloat16*>(x), t, bs, o, B, H, W, C, s);
  return Launch<float>::run(static_cast<const float*>(x), t, bs, o, B, H, W, C, s);
}

template <typename T> struct Hopper {
  template <typename... A> static int run(A... a) { return cnb::dwc::dwconv7_launch<T>(a...); }
};
template <typename T> struct First {
  template <typename... A> static int run(A... a) { return cnb::dwc0::dwconv7_launch<T>(a...); }
};

}  // namespace

extern "C" {

// x: contiguous NHWC [B, H, W, C], bf16 if is_bf16 else fp32, 16-byte
// aligned; taps [49][C] fp32 (row-major 7x7 taps per channel); bias [C]
// fp32 or nullptr; out [B, H, W, C] fp32. C a multiple of 16. Launches the
// Hopper design on `stream`; returns the CUDA error of the launch, or 0.
int dwconv7_forward(const void* x, const void* taps, const void* bias, void* out, int B, int H,
                    int W, int C, int is_bf16, void* stream) {
  return forward<Hopper>(x, taps, bias, out, B, H, W, C, is_bf16, stream);
}

// The same function through the first design (the "before").
int dwconv7_forward_v0(const void* x, const void* taps, const void* bias, void* out, int B, int H,
                       int W, int C, int is_bf16, void* stream) {
  return forward<First>(x, taps, bias, out, B, H, W, C, is_bf16, stream);
}

// The Hopper design's plan for this shape on the current device, into
// out[dwc::PLAN_FIELDS] in the order of dwc::Plan; returns a CUDA error, or 0.
int dwconv7_plan(int B, int H, int W, int C, int is_bf16, int* out) {
  cnb::dwc::Plan p{};
  const int rc = is_bf16 ? cnb::dwc::plan<__nv_bfloat16>(B, H, W, C, p)
                         : cnb::dwc::plan<float>(B, H, W, C, p);
  if (rc) return rc;
  const int v[cnb::dwc::PLAN_FIELDS] = {p.px, p.warps, p.tw, p.strips, p.chunks,
                                        p.segs, p.seg_rows, p.units, p.unit_stages, p.ring,
                                        p.stage_bytes, p.smem, p.ctas_per_sm, p.grid, p.sms};
  for (int i = 0; i < cnb::dwc::PLAN_FIELDS; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
