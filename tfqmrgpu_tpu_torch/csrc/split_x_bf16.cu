// The X split pass of the bf16 split modes of K2 and K3 (panel_mma.cuh),
// and the tensor maps of their product.  It replaces no TPU kernel: the
// JAX package splits K2's X windows with XLA before its kernel
// (tfqmrgpu_tpu/ops/pairpanel.py, split_bf16x2 / split_bf16x3 of the X
// panel), and K3's TPU kernel splits the gathered X rows in VMEM.  Here X
// is split once a multiply, into the layout the product's TMA boxes read,
// instead of once for every tile that lists a block (about six times over
// at the golden class).
//
// What it computes: the bf16 planes of the float32 X halves x_re and x_im
// (rows of ldx floats, nblocks * lm rows of c lanes), the planes of
// ops/pairpanel.py's split_planes to the bit (hi by the mantissa mask,
// ties away from zero; the residuals rounded to nearest even, subnormal
// operands and differences flushed to zero as XLA does on the CPU; a NaN
// keeps the upper half of its bits, quieted, as the CPU's arithmetic and
// pairpanel._bf16 keep it, and a hi or mid plane that split_bf16x2 /
// split_bf16x3 convert to bf16 turns a NaN into 0xFFFF, as torch's
// conversion on the CPU does), stored lane-major:
//
//   xs[plane][lane block of 16][re|im][16 lanes][block b * klm + i]
//
// rows i in [lm, klm) of a block and lanes in [c, 16 * nlb16) zero.
//
// What bounds it on the H100: bytes.  It reads X once (8 bytes an entry,
// re and im) and writes 2 bytes a plane, at the golden class 36.8 MB in
// and 18.4 MB a plane out.  A CTA takes 64 rows of 32 lanes of one half:
// a warp splits 8 rows, one lane a thread, so that its reads coalesce
// across the lanes; the planes go through shared memory, so that a warp's
// stores are whole 128-byte runs of one lane's rows.  (A thread storing
// its own 8 rows, 16 bytes to a lane 32 lanes apart from its neighbours',
// took about five times the bytes' time on an H100 80GB HBM3 at 700 W;
// PERF.md.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "panel_mma.cuh"

namespace {

__device__ __forceinline__ bool nan_bits(uint32_t b) {
  return (b & 0x7FFFFFFFu) > 0x7F800000u;
}

// v rounded by the mantissa mask (ties away from zero;
// pairpanel.rn16_f32): its upper 16 bits, and that value as a float32
__device__ __forceinline__ uint32_t rn16(float v, float& as_f32) {
  const uint32_t h = (__float_as_uint(v) + 0x8000u) & 0xFFFF0000u;
  as_f32 = __uint_as_float(h);
  return h >> 16;
}

// the same as a plane that split_bf16x2 / split_bf16x3 convert to bf16:
// a NaN becomes 0xFFFF, as torch's conversion gives it on the CPU
__device__ __forceinline__ uint32_t rn16_plane(float v, float& as_f32) {
  const uint32_t h = rn16(v, as_f32);
  return nan_bits(h << 16) ? 0xFFFFu : h;
}

// float32 -> bf16, to nearest even; a NaN keeps its upper half, quieted
// (pairpanel._bf16)
__device__ __forceinline__ uint32_t bf16_rne(float v) {
  const uint32_t b = __float_as_uint(v);
  if (nan_bits(b)) return (b >> 16) | 0x40u;
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}

// a - b as XLA computes it on the CPU (pairpanel._sub): subnormal operands
// read as zero, a subnormal difference flushed to zero; a NaN operand's
// bits quieted (a's first), and inf - inf the CPU's default NaN
__device__ __forceinline__ float sub(float a, float b) {
  const uint32_t ab = __float_as_uint(a), bb = __float_as_uint(b);
  if (nan_bits(ab)) return __uint_as_float(ab | 0x00400000u);
  if (nan_bits(bb)) return __uint_as_float(bb | 0x00400000u);
  const float d = __fsub_rn(flush(a), flush(b));
  if (d != d) return __uint_as_float(0xFFC00000u);
  return flush(d);
}

// the bf16 planes of v (split_bf16x2 / split_bf16x3; 'bf16' the upper
// half of rn16_f32 alone)
template <int P>
__device__ __forceinline__ void split(float v, uint32_t (&out)[P]) {
  float hf;
  if constexpr (P == 1) {
    out[0] = rn16(v, hf);
  } else if constexpr (P == 2) {
    out[0] = rn16_plane(v, hf);
    out[1] = bf16_rne(sub(v, hf));
  } else {
    out[0] = rn16_plane(v, hf);
    const float r1 = sub(v, hf);
    float mf;
    out[1] = rn16_plane(r1, mf);
    out[2] = bf16_rne(sub(r1, mf));
  }
}

template <int P>
__global__ void __launch_bounds__(256)
split_x_bf16_kernel(const float* __restrict__ x_re,
                    const float* __restrict__ x_im, long long ldx,
                    uint16_t* __restrict__ xs, int lm, int klm, int c,
                    int nlb16, long long xrows,
                    unsigned long long* count) {
  // a CTA's tile, 64 rows of 32 lanes of one half, as P planes [lane][8
  // chunks of 8 rows]; chunk k of lane l at k ^ (l % 8), so that neither
  // the split's stores nor the copy-out's loads meet in a bank
  __shared__ uint4 tile[P][32][8];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long r0 = static_cast<long long>(blockIdx.y) * 64;
  const int h = blockIdx.z;
  count_launch(count);
  {  // warp w splits rows r0 + 8w.. of the 32 lanes, one lane a thread
    const int j = blockIdx.x * 32 + lane;
    const long long row = r0 + 8 * w;
    const float* x = h ? x_im : x_re;
    const long long blk = row / klm;
    const int i0 = static_cast<int>(row - blk * klm);
    uint32_t wd[P][4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = i0 + e;
      const float v = row < xrows && i < lm && j < c
                          ? x[(blk * lm + i) * ldx + j] : 0.f;
      uint32_t parts[P];
      split<P>(v, parts);
#pragma unroll
      for (int pl = 0; pl < P; ++pl) {
        if (e % 2 == 0)
          wd[pl][e / 2] = parts[pl];
        else
          wd[pl][e / 2] |= parts[pl] << 16;
      }
    }
#pragma unroll
    for (int pl = 0; pl < P; ++pl)
      tile[pl][lane][w ^ (lane & 7)] =
          make_uint4(wd[pl][0], wd[pl][1], wd[pl][2], wd[pl][3]);
  }
  __syncthreads();
  // thread t writes 16 bytes, rows r0 + 8(t%8).. of lane t/8: a warp
  // writes four whole 128-byte runs of rows
  const int l = tid >> 3, k = tid & 7;
  const int j = blockIdx.x * 32 + l;
  const long long row = r0 + 8 * k;
  if (j >= nlb16 * 16 || row >= xrows) return;
#pragma unroll
  for (int pl = 0; pl < P; ++pl) {
    const size_t dst =
        ((static_cast<size_t>(pl) * nlb16 + j / 16) * 2 + h) * 16 + j % 16;
    *reinterpret_cast<uint4*>(xs + dst * xrows + row) =
        tile[pl][l][k ^ (l & 7)];
  }
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  Splits x_re and x_im (nblocks * lm rows of ldx floats,
// c lanes used) into xs, the [planes, nlb16, 2, 16, nblocks * klm] bf16
// planes (16-byte aligned); planes is 1, 2 or 3 (split_planes of 'bf16',
// 'bf16x3' / 'bf16x4', 'bf16x6').
extern "C" int tfq_split_x_bf16(const void* x_re, const void* x_im, int ldx,
                                void* xs, int nblocks, int lm, int klm,
                                int c, int nlb16, int planes, void* stream,
                                void* count) {
  if (nblocks <= 0 || c <= 0) return cudaSuccess;
  if (lm <= 0 || klm < lm || klm % 16 != 0 || nlb16 * 16 < c ||
      ldx < c || reinterpret_cast<uintptr_t>(xs) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long xrows = static_cast<long long>(nblocks) * klm;
  const dim3 grid((nlb16 * 16 + 31) / 32,
                  static_cast<unsigned>((xrows + 63) / 64), 2);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xr = static_cast<const float*>(x_re);
  const auto* xi = static_cast<const float*>(x_im);
  auto* out = static_cast<uint16_t*>(xs);
  auto* cnt = static_cast<unsigned long long*>(count);
  switch (planes) {
    case 1:
      split_x_bf16_kernel<1><<<grid, 256, 0, st>>>(xr, xi, ldx, out, lm, klm,
                                                   c, nlb16, xrows, cnt);
      break;
    case 2:
      split_x_bf16_kernel<2><<<grid, 256, 0, st>>>(xr, xi, ldx, out, lm, klm,
                                                   c, nlb16, xrows, cnt);
      break;
    case 3:
      split_x_bf16_kernel<3><<<grid, 256, 0, st>>>(xr, xi, ldx, out, lm, klm,
                                                   c, nlb16, xrows, cnt);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The two tensor maps of the split product (panel_mma.cuh, encode_maps)
// into maps (256 bytes of host memory): A's slabs [n_boxes, 128, kc] and
// the X planes xs [planes, nlb16, 2, 16, xrows].  Returns 0, a
// cudaError_t, or 1000 + the CUresult of a refused map.
extern "C" int tfq_panel_mma_maps(void* maps, const void* a, int n_boxes,
                                  const void* xs, int xrows, int nlb16,
                                  int planes, int kc, int lanes) {
  return pmma::encode_maps(maps, a, n_boxes, xs, xrows, nlb16, planes, kc,
                           lanes);
}
