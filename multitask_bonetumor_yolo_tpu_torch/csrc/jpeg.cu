// Baseline JPEG decode for the card (kernel K6): a host entropy decoder and
// two CUDA kernels, bit for bit with libjpeg-turbo's default decode (the one
// cv2.imread asks for) and with the port's plain version
// (ops/kernels/jpeg.py::jpeg_idct_plain, jpeg_color_plain;
// data/jpeg.py::entropy_decode_py).
//
// K6 replaces no TPU kernel: the JAX package reads its JPEGs on the host
// through cv2 (data/dataset.py::_imread_color_rgb). The card's machine has no
// cv2, so the port decodes itself, split the way nvJPEG's hybrid backend
// splits it:
//
//   jpeg_entropy_scan   host C, one scan: Huffman decode into int16
//                       coefficients [blocks, 64] in natural order, per
//                       component's block grid. Serial by nature (each code's
//                       length is known only once it is read); called through
//                       ctypes, which releases the GIL.
//   K6a jpeg_idct       one thread per 8x8 block: dequantise and jidctint.c's
//                       JDCT_ISLOW inverse DCT (CONST_BITS 13, PASS1_BITS 2,
//                       64-bit products as JLONG, the range-limit table with
//                       its +128 level shift), each component's plane as uint8.
//   K6b jpeg_color      one thread per output pixel: jdsample.c's upsampling
//                       ("fancy" h2v1 / h1v2 / h2v2 with their biases, edges
//                       repeated at the component's downsampled width and
//                       height) and jdcolor.c's fixed-point conversion
//                       (ycc_rgb_convert, rgb_gray_convert), cropped.
//
// Bound: memory. The coefficients in (2 bytes each) and the pixels out; each
// block's IDCT is ~1,000 integer operations on 128 bytes, below the card's
// ratio of operations to bytes. This first design is the simple one: a
// thread's block is loaded with 16-byte loads, its planes written 8 bytes a
// row; K6b reads up to four plane samples per component per pixel through L1.
//
// Plain C interface, loaded with ctypes (ops/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <vector>

namespace {

// ------------------------------------------------------------ parameters
struct Params {
  int mode;     // ops/kernels/jpeg.py MODE_*: 0 YCbCr->RGB, 1 RGB->RGB, 2 grey->RGB,
                // 3 one plane as grey, 4 RGB->grey
  int ncomp;    // components the read needs
  int height, width;
  int blocks;   // blocks of the needed components
  int block_off[3], bw[3], bh[3], cw[3], ch[3], up[3];
  long long plane_off[3];
  int qt[3][64];  // natural order
};
enum { UP_COPY, UP_H2V1, UP_H1V2, UP_H2V2, UP_H2V1_BOX, UP_H2V2_BOX };

// `a`: the host int array of ops/kernels/jpeg.py::_params (mode, ncomp, height,
// width, blocks, then 7 per component, plane_off in blocks); `qt` int32 [3, 64]
// or null (K6b reads no table)
Params make_params(const int* a, const int* qt) {
  Params p;
  p.mode = a[0]; p.ncomp = a[1]; p.height = a[2]; p.width = a[3]; p.blocks = a[4];
  for (int c = 0; c < 3; ++c) {
    const int* s = a + 5 + 7 * c;
    p.block_off[c] = s[0]; p.bw[c] = s[1]; p.bh[c] = s[2]; p.cw[c] = s[3]; p.ch[c] = s[4];
    p.up[c] = s[5]; p.plane_off[c] = (long long)s[6] * 64;  // planes start on whole blocks
    for (int k = 0; k < 64; ++k) p.qt[c][k] = qt ? qt[c * 64 + k] : 0;
  }
  return p;
}

// ------------------------------------------------------------------- K6a
constexpr long long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
    FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
    FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
    FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

__device__ __forceinline__ long long descale(long long x, int n) {
  return (x + (1LL << (n - 1))) >> n;
}

// one 1-D pass of jpeg_idct_islow over in[0], in[s], ..., in[7s]; `shift` is
// CONST_BITS - PASS1_BITS (pass 1) or CONST_BITS + PASS1_BITS + 3 (pass 2)
__device__ __forceinline__ void idct_1d(const long long* in, int s, int shift, long long* o) {
  long long z2 = in[2 * s], z3 = in[6 * s];
  long long z1 = (z2 + z3) * FIX_0_541196100;
  long long tmp2 = z1 + z3 * (-FIX_1_847759065);
  long long tmp3 = z1 + z2 * FIX_0_765366865;
  long long tmp0 = (in[0] + in[4 * s]) * 8192;  // << CONST_BITS
  long long tmp1 = (in[0] - in[4 * s]) * 8192;
  long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7 * s]; tmp1 = in[5 * s]; tmp2 = in[3 * s]; tmp3 = in[s];
  z1 = tmp0 + tmp3; z2 = tmp1 + tmp2; z3 = tmp0 + tmp2;
  long long z4 = tmp1 + tmp3;
  long long z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336; tmp1 *= FIX_2_053119869; tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223; z2 *= -FIX_2_562915447; z3 *= -FIX_1_961570560;
  z4 *= -FIX_0_390180644;
  z3 += z5; z4 += z5;
  tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
  o[0] = descale(tmp10 + tmp3, shift); o[7] = descale(tmp10 - tmp3, shift);
  o[1] = descale(tmp11 + tmp2, shift); o[6] = descale(tmp11 - tmp2, shift);
  o[2] = descale(tmp12 + tmp1, shift); o[5] = descale(tmp12 - tmp1, shift);
  o[3] = descale(tmp13 + tmp0, shift); o[4] = descale(tmp13 - tmp0, shift);
}

// libjpeg's IDCT range limit: x & 1023 as a signed 10-bit value, + 128, clamped
__device__ __forceinline__ unsigned int range_limit(long long x) {
  int v = (int)(x & 1023);
  v = v < 512 ? v : v - 1024;
  v += 128;
  return (unsigned int)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void jpeg_idct_kernel(const short* __restrict__ coefs,
                                 unsigned char* __restrict__ planes, const Params p) {
  int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= p.blocks) return;
  int c = (p.ncomp > 1 && blk >= p.block_off[1]) + (p.ncomp > 2 && blk >= p.block_off[2]);
  int local = blk - p.block_off[c];
  int by = local / p.bw[c], bx = local - by * p.bw[c];

  union { int4 v[8]; short s[64]; } cf;
  const int4* src = reinterpret_cast<const int4*>(coefs + (size_t)blk * 64);
#pragma unroll
  for (int i = 0; i < 8; ++i) cf.v[i] = src[i];

  long long ws[64];
#pragma unroll
  for (int col = 0; col < 8; ++col) {  // pass 1: columns, dequantised
    long long in[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) in[r] = (long long)cf.s[r * 8 + col] * p.qt[c][r * 8 + col];
    idct_1d(in, 1, 11, o);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[r * 8 + col] = (int)o[r];
  }
  size_t pitch = (size_t)p.bw[c] * 8;
  unsigned char* dst = planes + p.plane_off[c] + (size_t)by * 8 * pitch + (size_t)bx * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    long long o[8];
    idct_1d(ws + r * 8, 1, 18, o);
    uint2 row;
    row.x = range_limit(o[0]) | range_limit(o[1]) << 8 | range_limit(o[2]) << 16 |
            range_limit(o[3]) << 24;
    row.y = range_limit(o[4]) | range_limit(o[5]) << 8 | range_limit(o[6]) << 16 |
            range_limit(o[7]) << 24;
    *reinterpret_cast<uint2*>(dst + r * pitch) = row;
  }
}

// ------------------------------------------------------------------- K6b
__device__ __forceinline__ int sample(const unsigned char* __restrict__ pl, int pitch, int cw,
                                      int ch, int up, int y, int x) {
  switch (up) {
    case UP_H2V1: {
      int c = x >> 1, odd = x & 1;
      int n = odd ? min(c + 1, cw - 1) : max(c - 1, 0);
      const unsigned char* row = pl + (size_t)y * pitch;
      return (3 * row[c] + row[n] + 1 + odd) >> 2;
    }
    case UP_H1V2: {
      int r = y >> 1, odd = y & 1;
      int n = odd ? min(r + 1, ch - 1) : max(r - 1, 0);
      return (3 * pl[(size_t)r * pitch + x] + pl[(size_t)n * pitch + x] + 1 + odd) >> 2;
    }
    case UP_H2V2: {
      int r = y >> 1, rn = (y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
      int c = x >> 1, odd = x & 1;
      int cn = odd ? min(c + 1, cw - 1) : max(c - 1, 0);
      const unsigned char* near = pl + (size_t)r * pitch;
      const unsigned char* far = pl + (size_t)rn * pitch;
      int s0 = 3 * near[c] + far[c], s1 = 3 * near[cn] + far[cn];
      return (3 * s0 + s1 + 8 - odd) >> 4;
    }
    case UP_H2V1_BOX: return pl[(size_t)y * pitch + (x >> 1)];
    case UP_H2V2_BOX: return pl[(size_t)(y >> 1) * pitch + (x >> 1)];
    default: return pl[(size_t)y * pitch + x];
  }
}

__device__ __forceinline__ unsigned char clamp255(int v) {
  return (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void jpeg_color_kernel(const unsigned char* __restrict__ planes,
                                  unsigned char* __restrict__ out, const Params p) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.height * p.width) return;
  int y = (int)(idx / p.width), x = (int)(idx - (long long)y * p.width);
  int v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (c < p.ncomp)
      v[c] = sample(planes + p.plane_off[c], p.bw[c] * 8, p.cw[c], p.ch[c], p.up[c], y, x);
  if (p.mode == 3) {  // one plane as grey
    out[idx] = (unsigned char)v[0];
    return;
  }
  if (p.mode == 4) {  // rgb_gray_convert: FIX(0.299), FIX(0.587), FIX(0.114) + ONE_HALF
    out[idx] = (unsigned char)((19595 * v[0] + 38470 * v[1] + 7471 * v[2] + 32768) >> 16);
    return;
  }
  int r, g, b;
  if (p.mode == 0) {  // ycc_rgb_convert
    int cb = v[1] - 128, cr = v[2] - 128;
    r = v[0] + ((91881 * cr + 32768) >> 16);
    g = v[0] + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
    b = v[0] + ((116130 * cb + 32768) >> 16);
  } else if (p.mode == 1) {
    r = v[0]; g = v[1]; b = v[2];
  } else {
    r = g = b = v[0];
  }
  unsigned char* o = out + idx * 3;
  o[0] = clamp255(r); o[1] = clamp255(g); o[2] = clamp255(b);
}

// ---------------------------------------------------- host entropy decoder
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { OK = 0, TRUNCATED = 1, BAD_CODE = 2, BAD_TABLE = 3 };

// (length << 8 | symbol) per 16-bit lookahead; length 0: no code
bool build_lut(const unsigned char* t, std::vector<uint16_t>& lut) {
  lut.assign(1 << 16, 0);
  unsigned code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < t[len - 1]; ++i) {
      if (code >= (1u << len)) return false;
      unsigned lo = code << (16 - len), hi = (code + 1) << (16 - len);
      for (unsigned j = lo; j < hi; ++j) lut[j] = (uint16_t)(len << 8 | t[16 + k]);
      ++code;
      ++k;
    }
    code <<= 1;
  }
  return true;
}

struct Bits {
  const unsigned char* d;
  long long pos, end;
  uint64_t acc = 0;
  int nbits = 0, phantom = 0;  // bits in acc; of them, ones fed past the data

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0xFF;
      if (phantom == 0 && pos < end) {
        if (d[pos] != 0xFF) {
          b = d[pos++];
        } else if (pos + 1 < end && d[pos + 1] == 0x00) {
          pos += 2;
        } else {
          phantom += 8;  // a marker: feed ones and stay before it
        }
      } else {
        phantom += 8;
      }
      acc |= b << (56 - nbits);
      nbits += 8;
    }
  }
  bool overrun() const { return phantom > nbits; }
  void reset() { acc = 0; nbits = 0; phantom = 0; }
};

inline int huff(Bits& br, const std::vector<uint16_t>& lut, int& sym) {
  br.fill();
  uint16_t e = lut[br.acc >> 48];
  int len = e >> 8;
  if (len == 0) return BAD_CODE;
  sym = e & 255;
  br.acc <<= len;
  br.nbits -= len;
  return OK;
}

inline int extend(Bits& br, int s) {
  int v = (int)(br.acc >> (64 - s));
  br.acc <<= s;
  br.nbits -= s;
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" {

// One scan's entropy-coded bytes data[begin, end). `comp` holds, per scan
// component, 5 ints: h, v, the block grid's width, and the blocks across and
// down of a non-interleaved scan; `tables` per scan component its DC then its
// AC table, 16 counts + 256 values each; `outs` per scan component the int16
// [grid rows, grid width, 64] buffer (natural order). MCUs: mcux x mcuy when
// ns > 1. Returns 0, 1 (truncated), 2 (no Huffman code matches) or 3 (a bad
// table).
int jpeg_entropy_scan(const unsigned char* data, long long begin, long long end, int ns,
                      const int* comp, const unsigned char* tables, int mcux, int mcuy,
                      int restart, const long long* outs) {
  if (ns < 1 || ns > 4) return BAD_TABLE;
  std::vector<uint16_t> luts[8];
  for (int s = 0; s < 2 * ns; ++s)
    if (!build_lut(tables + s * 272, luts[s])) return BAD_TABLE;
  long long nmcu = ns > 1 ? (long long)mcux * mcuy : (long long)comp[3] * comp[4];
  int per_row = ns > 1 ? mcux : comp[3];
  Bits br{data, begin, end};
  int pred[4] = {0, 0, 0, 0};
  long long left = restart;
  for (long long m = 0; m < nmcu; ++m) {
    if (restart && left == 0) {  // the next RST marker
      br.reset();
      while (br.pos + 1 < end && !(data[br.pos] == 0xFF && data[br.pos + 1] >= 0xD0 &&
                                   data[br.pos + 1] <= 0xD7))
        ++br.pos;
      if (br.pos + 1 >= end) return TRUNCATED;
      br.pos += 2;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      left = restart;
    }
    int my = (int)(m / per_row), mx = (int)(m % per_row);
    for (int s = 0; s < ns; ++s) {
      const int* cp = comp + 5 * s;
      int hs = ns > 1 ? cp[0] : 1, vs = ns > 1 ? cp[1] : 1;
      short* out = reinterpret_cast<short*>(outs[s]);
      for (int v = 0; v < vs; ++v) {
        for (int h = 0; h < hs; ++h) {
          short* blk = out + ((size_t)(my * vs + v) * cp[2] + (size_t)(mx * hs + h)) * 64;
          int t, rc = huff(br, luts[2 * s], t);
          if (rc) return rc;
          if (t > 16) return BAD_CODE;
          if (t) pred[s] += extend(br, t);
          blk[0] = (short)pred[s];
          for (int k = 1; k < 64; ++k) {
            int rs;
            if ((rc = huff(br, luts[2 * s + 1], rs))) return rc;
            int r = rs >> 4;
            t = rs & 15;
            if (t) {
              k += r;
              blk[kNatural[k]] = (short)extend(br, t);
            } else if (r != 15) {
              break;
            } else {
              k += 15;
            }
          }
        }
      }
    }
    if (br.overrun()) return TRUNCATED;
    --left;
  }
  return OK;
}

// K6a: `params` is the host int array of ops/kernels/jpeg.py::_params,
// `qt` int32 [3, 64] on the host; coefs int16 [blocks, 64] and planes on the card.
int jpeg_idct(const short* coefs, unsigned char* planes, const int* params, const int* qt,
              void* stream) {
  Params p = make_params(params, qt);
  if (p.blocks > 0)
    jpeg_idct_kernel<<<(p.blocks + 127) / 128, 128, 0, (cudaStream_t)stream>>>(coefs, planes, p);
  return (int)cudaGetLastError();
}

// K6b: the planes of K6a in, uint8 [H, W, 3] or [H, W] out, on the card.
int jpeg_color(const unsigned char* planes, unsigned char* out, const int* params,
               void* stream) {
  Params p = make_params(params, nullptr);
  long long n = (long long)p.height * p.width;
  if (n > 0)
    jpeg_color_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(planes, out,
                                                                                   p);
  return (int)cudaGetLastError();
}

}  // extern "C"
