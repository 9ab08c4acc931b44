// K1's Ozaki modes on the tensor cores of Hopper (sm_90a): the oz kernel of
// the packed 'z' route (ops/pairpanel.py, OzPairPanelMultiply).  It computes
// what the Ozaki branches of the TPU kernel
// tfqmrgpu_tpu/ops/pairpanel.py::_make_call.kernel compute (its dots(),
// :1527-1647, and finish(), :1487-1506), for every tile t of a packed plan:
//
//   D_st = A_s[t] @ X_t[union rows of t]     s + t <= p - 1
//
// A_s[t] is slice s of the tile's fused panel [2M, K] (P rows over Q rows,
// M = r_tile*LM, K = ku*LM), the p slices stacked as [p*2M, K]; X_t is
// slice t of the fused X panel [rows, p*2LN] (re lanes, then im lanes, a
// slice after another), gathered by the tile's union slots (xloc).  Every
// D_st is an exact sum: the slicer bounds each product (and in 'oz' and
// 'xi8' each diagonal's sum) within 2^24 (float32) or 2^31 (int32) units of
// its grid, so the order of the sums inside a dot does not matter and the
// tensor cores give the bits of any exact evaluation.  The bodies keep the
// JAX reduction's order exactly:
//
//   body  operands, MMA                        reduction, output
//   ozc   A bf16 or int8 (re-scaled to bf16    one accumulator a product;
//         here), X bf16; m16n8k16 BF16 into    the products folded in
//         FP32                                 diagonal order, TwoSum for
//                                              d <= 4, a plain tail beyond;
//                                              then finish(): [M, 4LN] =
//                                              re_acc|im_acc|re_err|im_err
//   xi8   A and X int8; m16n8k32 INT8 into     int32 diagonal sums, split
//         INT32                                at 2^12 (hi, then lo) and
//                                              TwoSum-folded, d ascending;
//                                              then finish()
//   oz    A int8 (re-scaled) or bf16, X bf16;  float32 diagonal sums, raw:
//         m16n8k16 BF16 into FP32              [2M, p*2LN]
//
// The float32 arithmetic of the folds uses __fadd_rn / __fsub_rn /
// __fmul_rn, which the compiler neither contracts nor reorders.
//
// Design (a first, simple kernel).  A CTA owns 16 output rows by 8*NB
// lanes of one tile (the CTAs of a tile run next to one another, so that
// its operands come from L2 after the first); its four warps own the four
// real products of that block: (P rows | Q rows) x (re lanes | im lanes),
// one m16 x (8*NB) block each, with every accumulator the body needs in
// registers (ozc: one set a product, p(p+1)/2 of them; xi8 and oz: one set
// a diagonal).  A stage is one MMA depth (16 bf16 or 32 int8 entries): the
// A rows of the block for all p slices and the X rows of the union for all
// p slices, copied into shared memory by cp.async, 16 bytes a copy where
// LM is a multiple of the stage depth (a stage then lies in one slot of
// the union), else 4 (X from a lane-major copy the wrapper makes, [p*2LN,
// rows], so that a 32-bit word holds consecutive depth entries of one
// lane, the layout of the B fragments; int8 A of the bf16 bodies raw, made
// bf16 in the fragments).
// Two stages: the copies of stage s+1 are in flight while the warps take
// every kept product of stage s; two barriers a stage.
// Depth past the tile's union (kcount) is skipped: its A columns are zero.
// The fold of ozc and xi8 runs in each warp's registers; finish() reads
// the four warps' (acc, err) planes from shared memory.  No atomics: every
// output is written once and repeated launches give the same bits.
//
// What bounds it on the H100: at the golden class (12.96 GFlop by the
// reference's count) the slice products, p(p+1)/2 of them, at the data
// sheet's 1979 TOPS INT8 (xi8) or 989 TFlop/s BF16, and the A slice planes
// read once.  This design re-reads A for every lane block and X for every
// row block from L2 and issues mma.sync from shared memory; PERF.md gives
// its times against the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "panel_mma.cuh"   // pmma::mma_bf16, pmma::mma_s8

namespace {

constexpr int BODY_OZ = 0, BODY_OZC = 1, BODY_XI8 = 2;
constexpr int THREADS = 128;      // four warps
constexpr int WPR = 8;            // 32-bit words of one stage row
constexpr int STRIDE = WPR + 4;   // padded: the fragment loads hit 32 banks
constexpr int TWOSUM_D = 4;       // ozc: TwoSum for diagonals d <= 4

template <int BODY>
struct Shape {
  static constexpr bool INT = BODY == BODY_XI8;
  static constexpr int NB = INT ? 2 : 1;      // n8 lane blocks of a warp
  static constexpr int LANES = 8 * NB;        // lanes of a half of the CTA
  static constexpr int EPW = INT ? 4 : 2;     // entries of a word
  static constexpr int KC = WPR * EPW;        // depth of a stage
};

struct OzArgs {
  const void* a;        // [ntiles, p*2m, ku*lm] int8 or bf16
  const void* x;        // X^T [p*2c, rows] int8 (xi8) or bf16
  float* y;             // oz: [ntiles, 2m, p*2c]; ozc, xi8: [ntiles, m, 4c]
  const int* xloc;      // [ntiles, ku]: the union's X blocks
  const int* kcount;    // [ntiles]: the union's size
  int ntiles, m, ku, lm, c, rows, q, a_int8;
};

// 2^e as a float32, for e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((127 + e) << 23);
}

// One Knuth TwoSum step, the JAX body's order:
//   tot = acc + b; av = tot - b; bv = tot - av;
//   err = err + ((acc - av) + (b - bv)); acc = tot
__device__ __forceinline__ void two_sum(float& acc, float& err, float b) {
  const float tot = __fadd_rn(acc, b);
  const float av = __fsub_rn(tot, b);
  const float bv = __fsub_rn(tot, av);
  err = __fadd_rn(err, __fadd_rn(__fsub_rn(acc, av), __fsub_rn(b, bv)));
  acc = tot;
}

// RAW8: int8 A in a bf16 body (staged raw, made bf16 in the fragments)
template <int BODY, int P, bool RAW8>
__global__ void __launch_bounds__(THREADS)
pairpanel_oz_kernel(const OzArgs p) {
  using S = Shape<BODY>;
  constexpr int NB = S::NB, LANES = S::LANES, EPW = S::EPW, KC = S::KC;
  constexpr int NPROD = P * (P + 1) / 2;
  constexpr int NACC = BODY == BODY_OZC ? NPROD : P;
  using Acc = typename std::conditional<S::INT, int, float>::type;
  constexpr int A_WORDS = P * 2 * 16 * STRIDE;      // [slice][P|Q][row][k]
  constexpr int X_WORDS = P * 2 * LANES * STRIDE;   // [slice][lane][k]
  extern __shared__ __align__(16) uint32_t smem[];  // two stages of A, X
  // ozc, xi8: the warps' (acc, err) planes [P|Q][re|im][acc|err][16][LANES]
  __shared__ float s_r[BODY == BODY_OZ ? 1 : 8 * 16 * LANES];

  // the CTAs of one tile are consecutive (lane blocks fastest), so that the
  // tile's A slices and its union's X rows are read from device memory
  // about once and then from L2
  const int nlb = (p.c + LANES - 1) / LANES, nrb = (p.m + 15) / 16;
  const int lb = blockIdx.x % nlb, rest = blockIdx.x / nlb;
  const int t = rest / nrb, i0 = (rest % nrb) * 16, j0 = lb * LANES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = warp >> 1, hl = warp & 1;
  const int m = p.m, c = p.c, lm = p.lm;
  const size_t kdim = static_cast<size_t>(p.ku) * lm;
  const int kt = __ldg(p.kcount + t) * lm;        // depth the union holds
  const int* xl = p.xloc + static_cast<size_t>(t) * p.ku;
  const size_t a_tile = static_cast<size_t>(t) * P * 2 * m;  // first A row
  // int8 A of the bf16 bodies is staged raw (a row's KC entries in 4 words)
  // and turned into bf16 slice values as the fragments are loaded
  constexpr bool a_raw8 = !S::INT && RAW8;
  constexpr int a_wpr = a_raw8 ? WPR / 2 : WPR;
  constexpr int a_epw = (S::INT || a_raw8) ? 4 : 2;  // A entries of a word
  constexpr int a_esz = 4 / a_epw, x_esz = 4 / EPW;  // bytes of an entry
  // a stage lies in one slot of the union and its rows are 16-byte
  // aligned where LM is a multiple of KC: then 16-byte copies
  const bool wide = lm % KC == 0;

  Acc acc[NACC][NB][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[i][nb][f] = 0;

  // ---- the copies of the stage at depth k0 into buffer buf: 16-byte
  // cp.async where the stage is one slot (wide), else 4 bytes a copy,
  // zero-filled past the union, the tile's rows and lanes
  auto stage_wide = [&](int k0, int buf) {
    uint32_t* s_a = smem + buf * (A_WORDS + X_WORDS);
    uint32_t* s_x = s_a + A_WORDS;
    constexpr int A_CH = a_wpr / 4;            // 16-byte pieces of a row
    for (int e = tid; e < P * 2 * 16 * A_CH; e += THREADS) {
      const int ch = e % A_CH, r = (e / A_CH) % 16;
      const int hh = (e / (A_CH * 16)) % 2, sl = e / (A_CH * 32);
      const bool ok = i0 + r < m;
      const size_t off =
          ((a_tile + sl * 2 * m + hh * m + i0 + r) * kdim + k0) * a_esz +
          ch * 16;
      panel::cp_async16(reinterpret_cast<float*>(
                            s_a + ((sl * 2 + hh) * 16 + r) * STRIDE + ch * 4),
                        static_cast<const char*>(p.a) + (ok ? off : 0), ok);
    }
    const size_t row0 =
        static_cast<size_t>(__ldg(xl + k0 / lm)) * lm + k0 % lm;
    for (int e = tid; e < P * 2 * LANES * 2; e += THREADS) {
      const int ch = e & 1, n = (e >> 1) % (2 * LANES);
      const int sl = e / (4 * LANES);
      const int half = n / LANES, j = j0 + n % LANES;
      const bool ok = j < c;
      const size_t col = static_cast<size_t>(sl) * 2 * c + half * c + j;
      const size_t off = (col * p.rows + row0) * x_esz + ch * 16;
      panel::cp_async16(reinterpret_cast<float*>(
                            s_x + (sl * 2 * LANES + n) * STRIDE + ch * 4),
                        static_cast<const char*>(p.x) + (ok ? off : 0), ok);
    }
  };
  auto stage = [&](int k0, int buf) {
    if (wide) {
      stage_wide(k0, buf);
      return;
    }
    uint32_t* s_a = smem + buf * (A_WORDS + X_WORDS);
    uint32_t* s_x = s_a + A_WORDS;
    for (int e = tid; e < P * 2 * 16 * a_wpr; e += THREADS) {
      const int w = e % a_wpr, r = (e / a_wpr) % 16;
      const int hh = (e / (16 * a_wpr)) % 2, sl = e / (2 * 16 * a_wpr);
      const int k = k0 + w * a_epw;
      const bool ok = i0 + r < m && k < kt;
      const size_t off = (a_tile + sl * 2 * m + hh * m + i0 + r) * kdim + k;
      const char* src = static_cast<const char*>(p.a) + (ok ? off * a_esz : 0);
      panel::cp_async4(reinterpret_cast<float*>(
                           s_a + ((sl * 2 + hh) * 16 + r) * STRIDE + w),
                       src, ok);
    }
    // X from its lane-major copy: a word holds EPW consecutive rows of one
    // slot; where a stage lies in one slot (LM >= KC) its first row is
    // found once
    const size_t row0 = lm >= KC ? static_cast<size_t>(__ldg(xl + k0 / lm)) *
                                       lm + k0 % lm
                                 : 0;
    for (int e = tid; e < P * 2 * LANES * WPR; e += THREADS) {
      const int w = e % WPR, n = (e / WPR) % (2 * LANES);
      const int sl = e / (2 * LANES * WPR);
      const int half = n / LANES, j = j0 + n % LANES;
      const int k = k0 + w * EPW;
      const bool ok = j < c && k < kt;
      size_t off = 0;
      if (ok) {
        const size_t col = static_cast<size_t>(sl) * 2 * c + half * c + j;
        const size_t row =
            lm >= KC ? row0 + w * EPW
                     : static_cast<size_t>(__ldg(xl + k / lm)) * lm + k % lm;
        off = (col * p.rows + row) * x_esz;
      }
      panel::cp_async4(reinterpret_cast<float*>(
                           s_x + (sl * 2 * LANES + n) * STRIDE + w),
                       static_cast<const char*>(p.x) + off, ok);
    }
  };

  // ---- the kept products of the stage in buffer buf
  auto compute = [&](int buf) {
    const uint32_t* s_a = smem + buf * (A_WORDS + X_WORDS);
    const uint32_t* s_x = s_a + A_WORDS;
    uint32_t bfr[P][NB][2];
#pragma unroll
    for (int sl = 0; sl < P; ++sl)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint32_t* b =
            s_x + (sl * 2 * LANES + hl * LANES + nb * 8 + g) * STRIDE;
        bfr[sl][nb][0] = b[tq];
        bfr[sl][nb][1] = b[tq + 4];
      }
#pragma unroll
    for (int sl = 0; sl < P; ++sl) {
      const uint32_t* a0 = s_a + ((sl * 2 + h) * 16 + g) * STRIDE;
      const uint32_t* a8 = a0 + 8 * STRIDE;
      uint32_t afr[4];
      if constexpr (a_raw8) {
        // entries 2tq, 2tq+1 (and 2tq+8, 2tq+9) of rows g and g+8, raw
        // ints times 2^-(s+1)q: at most 7 significant bits, so the upper
        // half of their float32 bits is that bf16 exactly (JAX: int8 ->
        // f32 -> * 2^-(s+1)q -> bf16)
        const float sc = pow2f(-(sl + 1) * p.q);
        auto cvt = [&](const uint32_t* row, int byte) {
          const uint32_t u = reinterpret_cast<const uint16_t*>(row)[byte / 2];
          const float lo = __fmul_rn(
              static_cast<float>(static_cast<int8_t>(u & 0xFFu)), sc);
          const float hi = __fmul_rn(
              static_cast<float>(static_cast<int8_t>(u >> 8)), sc);
          return (__float_as_uint(lo) >> 16) |
                 (__float_as_uint(hi) & 0xFFFF0000u);
        };
        afr[0] = cvt(a0, 2 * tq);
        afr[1] = cvt(a8, 2 * tq);
        afr[2] = cvt(a0, 2 * tq + 8);
        afr[3] = cvt(a8, 2 * tq + 8);
      } else {
        afr[0] = a0[tq];
        afr[1] = a8[tq];
        afr[2] = a0[tq + 4];
        afr[3] = a8[tq + 4];
      }
#pragma unroll
      for (int tt = 0; tt + sl < P; ++tt) {
        const int d = sl + tt;
        const int i = BODY == BODY_OZC ? d * (d + 1) / 2 + sl : d;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if constexpr (S::INT)
            pmma::mma_s8(reinterpret_cast<int(&)[4]>(acc[i][nb]), afr,
                         bfr[tt][nb][0], bfr[tt][nb][1]);
          else
            pmma::mma_bf16(reinterpret_cast<float(&)[4]>(acc[i][nb]), afr,
                           bfr[tt][nb][0], bfr[tt][nb][1]);
        }
      }
    }
  };

  // ---- the walk: stage st+1's copies are in flight while st multiplies
  const int nst = (kt + KC - 1) / KC;
  if (nst > 0) stage(0, 0);
  panel::cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) stage((st + 1) * KC, (st + 1) & 1);
    panel::cp_async_commit();
    panel::cp_async_wait<1>();       // this thread's copies of stage st
    __syncthreads();                 // everyone's
    compute(st & 1);
    __syncthreads();                 // before stage st+2 overwrites it
  }

  // ---- the reductions; fragment entry f: row g + 8*(f/2), lane 2tq + f%2
  if constexpr (BODY == BODY_OZ) {
    const size_t yld = 2 * static_cast<size_t>(P) * c;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = i0 + g + 8 * (f >> 1);
        const int j = j0 + nb * 8 + 2 * tq + (f & 1);
        if (i >= m || j >= c) continue;
        float* yrow = p.y + (static_cast<size_t>(t) * 2 * m + h * m + i) * yld +
                      hl * c + j;
#pragma unroll
        for (int d = 0; d < P; ++d) yrow[static_cast<size_t>(d) * 2 * c] =
            acc[d][nb][f];
      }
    return;
  } else {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float sum, err;
        if constexpr (BODY == BODY_OZC) {
          sum = acc[0][nb][f];
          err = 0.f;
          float tail = 0.f;
#pragma unroll
          for (int d = 1; d < P; ++d)
#pragma unroll
            for (int s = 0; s <= d; ++s) {
              const float b = acc[d * (d + 1) / 2 + s][nb][f];
              if (d <= TWOSUM_D)
                two_sum(sum, err, b);
              else
                tail = __fadd_rn(tail, b);
            }
          err = __fadd_rn(err, tail);
        } else {
#pragma unroll
          for (int d = 0; d < P; ++d) {
            const int tot = acc[d][nb][f];
            const int lo = tot % 4096;          // truncated, as lax.rem
            const int hi = tot - lo;
            const float sc = pow2f(-(d + 2) * p.q);
            const float vh = __fmul_rn(__int2float_rn(hi), sc);
            const float vl = __fmul_rn(__int2float_rn(lo), sc);
            if (d == 0) {
              sum = vh;
              err = 0.f;
            } else {
              two_sum(sum, err, vh);
            }
            two_sum(sum, err, vl);
          }
        }
        const int r = g + 8 * (f >> 1), jj = nb * 8 + 2 * tq + (f & 1);
        float* base = s_r + ((h * 2 + hl) * 2) * 16 * LANES + r * LANES + jj;
        base[0] = sum;
        base[16 * LANES] = err;
      }
    __syncthreads();
    // ---- finish(): re = P1 - Q2, im = P2 + Q1, each one TwoSum step
    const size_t yld = 4 * static_cast<size_t>(c);
    for (int e = tid; e < 16 * LANES; e += THREADS) {
      const int r = e / LANES, jj = e % LANES;
      const int i = i0 + r, j = j0 + jj;
      if (i >= m || j >= c) continue;
      auto R = [&](int hh, int hhl, int k) {
        return s_r[((hh * 2 + hhl) * 2 + k) * 16 * LANES + r * LANES + jj];
      };
      const float a1 = R(0, 0, 0), b1 = -R(1, 1, 0);
      const float t1 = __fadd_rn(a1, b1);
      const float av = __fsub_rn(t1, b1);
      const float bv = __fsub_rn(t1, av);
      const float e1 =
          __fadd_rn(__fadd_rn(__fsub_rn(a1, av), __fsub_rn(b1, bv)),
                    __fsub_rn(R(0, 0, 1), R(1, 1, 1)));
      const float a2 = R(0, 1, 0), b2 = R(1, 0, 0);
      const float t2 = __fadd_rn(a2, b2);
      const float av2 = __fsub_rn(t2, b2);
      const float bv2 = __fsub_rn(t2, av2);
      const float e2 =
          __fadd_rn(__fadd_rn(__fsub_rn(a2, av2), __fsub_rn(b2, bv2)),
                    __fadd_rn(R(0, 1, 1), R(1, 0, 1)));
      float* yrow = p.y + (static_cast<size_t>(t) * m + i) * yld + j;
      yrow[0] = t1;
      yrow[c] = t2;
      yrow[2 * c] = e1;
      yrow[3 * c] = e2;
    }
  }
}

template <int BODY, int P, bool RAW8 = false>
cudaError_t launch(const OzArgs& a, cudaStream_t stream) {
  constexpr int LANES = Shape<BODY>::LANES;
  constexpr int bytes = 2 * 4 * (P * 2 * 16 * STRIDE + P * 2 * LANES * STRIDE);
  const cudaError_t err = cudaFuncSetAttribute(
      pairpanel_oz_kernel<BODY, P, RAW8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(a.ntiles) *
                           ((a.m + 15) / 16) * ((a.c + LANES - 1) / LANES);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const unsigned nblocks = static_cast<unsigned>(blocks);
  pairpanel_oz_kernel<BODY, P, RAW8><<<nblocks, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  a holds the tiles' A slices [ntiles, p*2m, ku*lm] (int8
// if a_int8 or body 2, else bf16); x the X slices lane-major, [p*2c, rows]
// (the transpose of the [rows, p*2c] slice planes; int8 for body 2, else
// bf16); y the output (body 0 'oz': [ntiles, 2m, p*2c]; 1
// 'ozc' and 2 'xi8': [ntiles, m, 4c]); xloc [ntiles, ku] and kcount
// [ntiles] the tiles' union slots; q the slice width.  The kernel is built
// for the slice counts of ops/pairpanel.py's OZ_KERNEL_P.
extern "C" int tfq_pairpanel_oz(const void* a, const void* x, void* y,
                                const void* xloc, const void* kcount,
                                int ntiles, int m, int ku, int lm, int c,
                                int rows, int p, int q, int body, int a_int8,
                                void* stream) {
  if (ntiles <= 0) return cudaSuccess;
  if (m <= 0 || ku <= 0 || lm <= 0 || lm % 4 != 0 || c <= 0 || rows <= 0 ||
      rows % lm != 0 || q < 2 || q > 8 ||
      (reinterpret_cast<uintptr_t>(a) % 4) != 0 ||
      (reinterpret_cast<uintptr_t>(x) % 4) != 0)
    return cudaErrorInvalidValue;
  const OzArgs args{a, x, static_cast<float*>(y),
                    static_cast<const int*>(xloc),
                    static_cast<const int*>(kcount), ntiles, m, ku, lm, c,
                    rows, q, a_int8 != 0};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case BODY_OZ:
      switch (p * 2 + (a_int8 != 0)) {
        case 14: return static_cast<int>(launch<BODY_OZ, 7>(args, st));
        case 16: return static_cast<int>(launch<BODY_OZ, 8>(args, st));
        case 17: return static_cast<int>(launch<BODY_OZ, 8, true>(args, st));
        case 18: return static_cast<int>(launch<BODY_OZ, 9>(args, st));
        case 19: return static_cast<int>(launch<BODY_OZ, 9, true>(args, st));
        case 22: return static_cast<int>(launch<BODY_OZ, 11>(args, st));
        case 23: return static_cast<int>(launch<BODY_OZ, 11, true>(args, st));
        case 28: return static_cast<int>(launch<BODY_OZ, 14>(args, st));
        case 29: return static_cast<int>(launch<BODY_OZ, 14, true>(args, st));
        default: return cudaErrorInvalidValue;
      }
    case BODY_OZC:
      switch (p * 2 + (a_int8 != 0)) {
        case 14: return static_cast<int>(launch<BODY_OZC, 7>(args, st));
        case 16: return static_cast<int>(launch<BODY_OZC, 8>(args, st));
        case 17: return static_cast<int>(launch<BODY_OZC, 8, true>(args, st));
        case 18: return static_cast<int>(launch<BODY_OZC, 9>(args, st));
        case 19: return static_cast<int>(launch<BODY_OZC, 9, true>(args, st));
        default: return cudaErrorInvalidValue;
      }
    case BODY_XI8:
      if (a_int8 == 0) return cudaErrorInvalidValue;
      switch (p) {
        case 8: return static_cast<int>(launch<BODY_XI8, 8>(args, st));
        case 9: return static_cast<int>(launch<BODY_XI8, 9>(args, st));
        default: return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
}
