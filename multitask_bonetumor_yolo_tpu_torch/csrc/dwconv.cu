// Kernel K3: the standalone depthwise 7x7 convolution (stride 1, SAME, fp32
// taps and accumulation, fp32 output) for Hopper (sm_90a), CUDA C++ with a
// plain C interface (built with nvcc into a shared library, loaded with
// ctypes). The device code, and the note on what bounds it and how it is
// laid out, are in csrc/dwconv.cuh, which csrc/convnext_block_bwd.cu shares.
//
// Replaces the TPU kernel multitask_bonetumor_yolo_tpu/ops/pallas/dwconv.py::
// _kernel (driven by dwconv7), which the block's explicit backward runs
// twice (the recompute of y, and dx as the correlation with flipped taps).

#include "dwconv.cuh"

extern "C" {

// x: contiguous NHWC [B, H, W, C], bf16 if is_bf16 else fp32, 16-byte
// aligned; taps [49][C] fp32 (row-major 7x7 taps per channel); bias [C]
// fp32 or nullptr; out [B, H, W, C] fp32. C a multiple of 16. Launches on
// `stream`; returns the CUDA error of the launch, or 0.
int dwconv7_forward(const void* x, const void* taps, const void* bias, void* out, int B, int H,
                    int W, int C, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0) return int(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(taps);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return cnb::dwc::dwconv7_launch(static_cast<const __nv_bfloat16*>(x), t, bs, o, B, H, W, C, s);
  return cnb::dwc::dwconv7_launch(static_cast<const float*>(x), t, bs, o, B, H, W, C, s);
}

}  // extern "C"
