// The staged complex panel product of the bf16 split modes, which K2
// (pairpanel_tiles_bf16.cu) and K3 (rowtile_spmm_bf16.cu) both run on the
// BF16 tensor cores of Hopper (sm_90a) with mma.sync.
//
// What it computes.  The same product as panel_stage.cuh, over the same
// unit tables and work list (ops/paneltiles.py), with every float32 operand
// split into bf16 planes and the product taken as a sum of bf16 plane
// products, the splits and products of the JAX package's modes:
//
//   mode    planes  products, in the order of K2's TPU dots
//   bf16    1       Ah.Xh
//   bf16x3  2       Ah.Xh + Ah.Xl + Al.Xh
//   bf16x4  2       Ah.Xh + Ah.Xl + Al.Xh + Al.Xl
//   bf16x6  3       Ah.Xh + Ah.Xm + Am.Xh + Am.Xm + Ah.Xl + Al.Xh
//
// (tfqmrgpu_tpu/ops/pairpanel.py:1663-1693; K3's, pallas_spmm.py:236-263,
// differ only in the order of bf16x6's, and K3 runs this order too).  The
// high planes are the bit-masked round to nearest (ties away from zero,
// pairpanel.rn16_f32), the residual planes bf16 rounded to nearest even.
// Every product is exact in float32; the tensor cores sum them in float32.
//
// Operands.  A is split once per upload on the host side
// (paneltiles.bf16_planes): plane p of tile t is [ku*LM/2, 2*rlm] words,
// word (d, r) holding the bf16 entries of depth rows 2d and 2d+1 of column
// r (re columns, then im columns), the pair an mma fragment register takes.
// X is split inside the kernel: a thread loads its float32 pairs of a
// stage's X rows into registers, splits them and stores the bf16 planes
// into shared memory in the same pair layout, so no split copy of X exists
// in device memory.
//
// Work units.  A unit is BM = 64 output rows by BN lanes of the host's
// union tables (ops/paneltiles.py, mma_shape): BM rows of one tile, or
// BM / rlm whole tiles side by side sharing one X slab, the ascending union
// of their blocks; a tile's A rows are zero at a step it has no block for.
// A warp owns 16 rows (an m16 block, re rows and im rows) by NB lane blocks
// of 8 (re lanes and im lanes), so the four real products of a complex
// product land in one thread's registers, and the epilogue writes
//   y_re = P(re rows, re lanes) - P(im rows, im lanes)
//   y_im = P(re rows, im lanes) + P(im rows, re lanes),
// masked to X's pattern where a mask is given (K3).
//
// The pipeline.  A stage is 16 depth rows of one unit step (one m16n8k16
// depth); at LM 4 and 8 a step is one stage whose depth rows past LM stay
// zero, which adds nothing.  Two buffers: while the warps multiply stage s,
// the A slice of stage s+1 is in flight by 16-byte cp.async and its X rows
// by loads into registers, split and stored after the products; one barrier
// a stage.  Persistent CTAs walk the host's work list.  No atomics, every
// output is written once and the sum order is fixed, so repeated launches
// give the same bits.
//
// What bounds it on the H100: at the golden class the BF16 products of a
// mode (1 to 6 passes of 12.96 GFlop at 989 TFlop/s on the data sheet)
// against the A planes and X (PERF.md gives each mode's bound and time).
// This first design is plain mma.sync without TMA or wgmma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "panel_stage.cuh"   // cp.async helpers, kMaxRun

namespace pmma {

// The products of a mode: term i multiplies A plane a_of(i) with X plane
// x_of(i), in the order of pairpanel.SPLIT_TERMS.
template <int MODE>
struct Mode {
  static_assert(MODE == 1 || MODE == 3 || MODE == 4 || MODE == 6, "mode");
  static constexpr int PLANES = MODE == 1 ? 1 : MODE == 6 ? 3 : 2;
  static constexpr int TERMS = MODE;
  __device__ static constexpr int a_of(int i) {
    return MODE == 6 ? (i == 0 || i == 1 || i == 4 ? 0 : i == 5 ? 2 : 1)
                     : (i < 2 ? 0 : 1);
  }
  __device__ static constexpr int x_of(int i) {
    return MODE == 6 ? (i == 0 || i == 2 || i == 5 ? 0 : i == 4 ? 2 : 1)
                     : (i == 1 || i == 3 ? 1 : 0);
  }
};

struct Args {
  const uint32_t* a;     // [planes, ntiles, ku*lm/2, 2*rlm] bf16 pairs
  const float* x_re;     // rows of ldx floats
  const float* x_im;
  float* y_re;           // rows of ldy floats
  float* y_im;
  const unsigned char* mask;  // [n_rows/lm, c/ln], or null: keep everything
  const int* uslot;      // [ngroups, ksteps, nt]: the union's X block
  const int* ukidx;      // [ngroups, ksteps, nt]: its index in tile n, or -1
  const int* ucount;     // [ngroups]: union steps of the group (>= 1)
  const int4* items;     // work list: (group, first row in tile, first lane, 0)
  const int* cta_start;  // [nctas + 1]
  long long ldx, ldy;
  long long plane;       // words of one A plane: ntiles*ku*lm/2*2*rlm
  int ntiles, rlm, ku, lm, c, ln, n_rows, nt, ksteps;
};

template <int BN_, int WN_>
struct Tiling {
  static constexpr int BM = 64, BN = BN_, WN = WN_;
  static constexpr int WM = BM / 16;              // warps along the rows
  static constexpr int WARPS = WM * WN;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NB = BN / 8 / WN;          // lane blocks of a warp
  static constexpr int KP = 8;                    // depth pairs of a stage
  static constexpr int A_STRIDE = 2 * BM + 8;     // words of a depth pair
  static constexpr int X_STRIDE = 2 * BN + 8;     // (+8: no bank conflicts)
  static constexpr int XPOS = KP * 2 * BN / THREADS;  // X pairs a thread
  static_assert(BN % (8 * WN) == 0 && NB >= 1, "lane blocks");
  static_assert(KP * 2 * BN % THREADS == 0, "X pairs per thread");
};

template <class Tl, int P>
struct Smem {
  static constexpr int A_STAGE = P * Tl::KP * Tl::A_STRIDE;   // words
  static constexpr int X_STAGE = P * Tl::KP * Tl::X_STRIDE;
  static constexpr int WORDS = 2 * (A_STAGE + X_STAGE);
  static constexpr size_t BYTES =
      sizeof(uint32_t) * WORDS + sizeof(int4) * panel::kMaxRun;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The float32 bits of v rounded to a bf16 value by the mantissa mask
// (ties away from zero; pairpanel.rn16_f32).
__device__ __forceinline__ uint32_t rn16_bits(float v) {
  return (__float_as_uint(v) + 0x8000u) & 0xFFFF0000u;
}

__device__ __forceinline__ uint32_t bf16_rne(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// a - b with subnormal operands read as zero and a subnormal difference
// flushed to zero, as XLA computes the split residuals (pairpanel._sub)
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}
__device__ __forceinline__ float sub(float a, float b) {
  return flush(__fsub_rn(flush(a), flush(b)));
}

// The bf16 planes of v (split_bf16x2 / split_bf16x3 of ops/pairpanel.py,
// the same bits for every finite v).
template <int P>
__device__ __forceinline__ void split(float v, uint32_t (&out)[P]) {
  const uint32_t h = rn16_bits(v);
  out[0] = h >> 16;
  if constexpr (P == 2) {
    out[1] = bf16_rne(sub(v, __uint_as_float(h)));
  } else if constexpr (P == 3) {
    const float r1 = sub(v, __uint_as_float(h));
    const uint32_t m = rn16_bits(r1);
    out[1] = m >> 16;
    out[2] = bf16_rne(sub(r1, __uint_as_float(m)));
  }
}

template <class Tl, int MODE>
__device__ __forceinline__ void run(const Args& p) {
  using Md = Mode<MODE>;
  constexpr int P = Md::PLANES;
  constexpr int BM = Tl::BM, BN = Tl::BN, KP = Tl::KP, NB = Tl::NB;
  constexpr int THREADS = Tl::THREADS;
  using Sm = Smem<Tl, P>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const s_a = smem;                      // [2][P][KP][A_STRIDE]
  uint32_t* const s_x = smem + 2 * Sm::A_STAGE;    // [2][P][KP][X_STRIDE]
  int4* const s_items = reinterpret_cast<int4*>(smem + Sm::WORDS);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;           // fragment row, pair
  const int wm = warp % Tl::WM, wn = warp / Tl::WM;
  const int first = p.cta_start[blockIdx.x];
  const int nmine = p.cta_start[blockIdx.x + 1] - first;
  const int chunks = p.lm >= 16 ? p.lm / 16 : 1;
  const int kpr = (p.lm >= 16 ? 16 : p.lm) / 2;    // real depth pairs
  const size_t a_row = 2 * static_cast<size_t>(p.rlm);
  const size_t a_tile = static_cast<size_t>(p.ku) * p.lm / 2 * a_row;

  // zero both stages: depth pairs past LM / 2 are never written (LM < 16)
  for (int e = tid; e < Sm::WORDS; e += THREADS) smem[e] = 0u;
  for (int e = tid; e < nmine; e += THREADS) {
    int4 it = p.items[first + e];
    it.w = p.ucount[it.x];
    s_items[e] = it;
  }
  __syncthreads();
  int total = 0;
  for (int e = 0; e < nmine; ++e) total += s_items[e].w;
  total *= chunks;
  if (total == 0) return;

  // ---- the fetch side: the stage at cursor f
  struct Cursor { int item, u, ch; };
  auto advance = [&](Cursor& k) {
    if (++k.ch == chunks) {
      k.ch = 0;
      if (++k.u == s_items[k.item].w) {
        k.u = 0;
        ++k.item;
      }
    }
  };
  // A: 16-byte pieces (4 columns of one depth pair of one plane)
  constexpr int COLS4 = 2 * BM / 4;
  auto fetch_a = [&](const Cursor& k, int buf) {
    const int4 it = s_items[k.item];
    const size_t ids = (static_cast<size_t>(it.x) * p.ksteps + k.u) * p.nt;
    uint32_t* st = s_a + buf * Sm::A_STAGE;
    const int pieces = P * kpr * COLS4;
    for (int e = tid; e < pieces; e += THREADS) {
      const int pl = e / (kpr * COLS4);
      const int rem = e - pl * kpr * COLS4;
      const int kp = rem / COLS4;
      const int col = (rem - kp * COLS4) * 4;
      const int half = col / BM, r = col - half * BM;
      const int n = p.nt > 1 ? r / p.rlm : 0;
      const int rin = r - n * p.rlm;
      const int kidx = n < p.nt ? __ldg(p.ukidx + ids + n) : -1;
      const int t = it.x * p.nt + n;
      const bool ok = kidx >= 0 && t < p.ntiles && it.y + rin < p.rlm;
      const uint32_t* src =
          ok ? p.a + pl * p.plane + t * a_tile +
                   (static_cast<size_t>(kidx) * p.lm / 2 + k.ch * KP + kp) *
                       a_row +
                   half * p.rlm + it.y + rin
             : p.a;
      panel::cp_async16(reinterpret_cast<float*>(
                            st + (pl * KP + kp) * Tl::A_STRIDE + col),
                        src, ok);
    }
  };
  // X: a thread's float32 pairs (depth rows 2d, 2d+1 of one lane)
  float2 xv[Tl::XPOS];
  auto load_x = [&](const Cursor& k) {
    const int4 it = s_items[k.item];
    const int blk = __ldg(p.uslot + (static_cast<size_t>(it.x) * p.ksteps +
                                     k.u) * p.nt);
    const size_t row0 = static_cast<size_t>(blk) * p.lm + k.ch * 16;
#pragma unroll
    for (int i = 0; i < Tl::XPOS; ++i) {
      const int e = tid + i * THREADS;
      const int kp = e / (2 * BN), l2 = e % (2 * BN);
      const int half = l2 / BN, j = it.z + l2 - half * BN;
      const float* xp = half ? p.x_im : p.x_re;
      float2 v = make_float2(0.f, 0.f);
      if (kp < kpr && j < p.c) {
        const size_t row = row0 + 2 * kp;
        v.x = xp[row * p.ldx + j];
        v.y = xp[(row + 1) * p.ldx + j];
      }
      xv[i] = v;
    }
  };
  auto store_x = [&](int buf) {
    uint32_t* st = s_x + buf * Sm::X_STAGE;
#pragma unroll
    for (int i = 0; i < Tl::XPOS; ++i) {
      const int e = tid + i * THREADS;
      const int kp = e / (2 * BN), l2 = e % (2 * BN);
      uint32_t lo[P], hi[P];
      split<P>(xv[i].x, lo);
      split<P>(xv[i].y, hi);
#pragma unroll
      for (int pl = 0; pl < P; ++pl)
        st[(pl * KP + kp) * Tl::X_STRIDE + l2] = lo[pl] | (hi[pl] << 16);
    }
  };

  // ---- the products: acc[nb][row half][lane half][fragment]
  float acc[NB][2][2][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[nb][h][hl][f] = 0.f;

  auto compute = [&](int buf) {
    const uint32_t* sa = s_a + buf * Sm::A_STAGE;
    const uint32_t* sx = s_x + buf * Sm::X_STAGE;
    uint32_t af[2][P][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int pl = 0; pl < P; ++pl) {
        const uint32_t* b = sa + pl * KP * Tl::A_STRIDE + h * BM + wm * 16 + g;
        af[h][pl][0] = b[tq * Tl::A_STRIDE];
        af[h][pl][1] = b[tq * Tl::A_STRIDE + 8];
        af[h][pl][2] = b[(tq + 4) * Tl::A_STRIDE];
        af[h][pl][3] = b[(tq + 4) * Tl::A_STRIDE + 8];
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col0 = (wn * NB + nb) * 8;
      uint32_t bf[2][P][2];
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
#pragma unroll
        for (int pl = 0; pl < P; ++pl) {
          const uint32_t* b =
              sx + pl * KP * Tl::X_STRIDE + hl * BN + col0 + g;
          bf[hl][pl][0] = b[tq * Tl::X_STRIDE];
          bf[hl][pl][1] = b[(tq + 4) * Tl::X_STRIDE];
        }
#pragma unroll
      for (int i = 0; i < Md::TERMS; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
            mma_bf16(acc[nb][h][hl], af[h][Md::a_of(i)],
                     bf[hl][Md::x_of(i)][0], bf[hl][Md::x_of(i)][1]);
    }
  };

  auto epilogue = [&](int item) {
    const int4 it = s_items[item];
    const int ncc = p.mask ? p.c / p.ln : 0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = wm * 16 + g + 8 * rr;            // row in the unit
      const int n = p.nt > 1 ? r / p.rlm : 0;
      const int t = it.x * p.nt + n;
      const int i = it.y + r - n * p.rlm;           // row in the tile
      const long long row = static_cast<long long>(t) * p.rlm + i;
      if (n >= p.nt || t >= p.ntiles || i >= p.rlm || row >= p.n_rows)
        continue;
      const unsigned char* mrow =
          p.mask ? p.mask + static_cast<size_t>(row / p.lm) * ncc : nullptr;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = it.z + (wn * NB + nb) * 8 + 2 * tq + cc;
          if (j >= p.c) continue;
          const bool keep = !mrow || mrow[j / p.ln] != 0;
          const int f = 2 * rr + cc;
          const float vr = acc[nb][0][0][f] - acc[nb][1][1][f];
          const float vi = acc[nb][0][1][f] + acc[nb][1][0][f];
          p.y_re[static_cast<size_t>(row) * p.ldy + j] = keep ? vr : 0.f;
          p.y_im[static_cast<size_t>(row) * p.ldy + j] = keep ? vi : 0.f;
        }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hl = 0; hl < 2; ++hl)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[nb][h][hl][f] = 0.f;
  };

  // ---- the walk: stage s is multiplied while stage s+1 is fetched
  Cursor fet{0, 0, 0};
  fetch_a(fet, 0);
  panel::cp_async_commit();
  load_x(fet);
  store_x(0);
  advance(fet);
  panel::cp_async_wait<0>();
  __syncthreads();
  int c_item = 0, c_left = s_items[0].w * chunks;
  for (int s = 0; s < total; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < total;
    if (more) {
      fetch_a(fet, buf ^ 1);
      load_x(fet);
    }
    panel::cp_async_commit();
    compute(buf);
    if (--c_left == 0) {
      epilogue(c_item);
      if (++c_item < nmine) c_left = s_items[c_item].w * chunks;
    }
    if (more) {
      store_x(buf ^ 1);
      advance(fet);
    }
    panel::cp_async_wait<0>();
    __syncthreads();
  }
}

// ---- host side: the instantiations and their launch

// K::template get<Tl, MODE>() is a source's __global__ function.
template <class K, class Tl, int MODE>
cudaError_t launch_one(const Args& p, int nctas, cudaStream_t stream,
                       int* slots) {
  auto kernel = K::template get<Tl, MODE>();
  constexpr size_t bytes = Smem<Tl, Mode<MODE>::PLANES>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (slots) {                   // the CTAs the card holds at once
    int dev = 0, nsm = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, Tl::THREADS, bytes)) != cudaSuccess)
      return err;
    *slots = (occ > 0 ? occ : 1) * nsm;
    return cudaSuccess;
  }
  kernel<<<nctas, Tl::THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The CTA shapes (rows, lanes): wide (64, 64) for c >= 64 lanes a plane,
// narrow (64, 16) below; ops/paneltiles.py names the same two (MMA_WIDE,
// MMA_NARROW).
template <class K, int MODE>
cudaError_t dispatch_shape(const Args& p, int bm, int bn, int nctas,
                           cudaStream_t stream, int* slots) {
  if (bm != 64) return cudaErrorInvalidValue;
  if (bn == 64)
    return launch_one<K, Tiling<64, 2>, MODE>(p, nctas, stream, slots);
  if (bn == 16)
    return launch_one<K, Tiling<16, 1>, MODE>(p, nctas, stream, slots);
  return cudaErrorInvalidValue;
}

// Checks the arguments and launches mode ``mode`` (1, 3, 4 or 6 products)
// or, with ``slots``, only reports the CTAs the card holds at once.
template <class K>
cudaError_t dispatch(const Args& p, int mode, int bm, int bn, int nctas,
                     cudaStream_t stream, int* slots) {
  const bool lm_ok = p.lm >= 16 ? p.lm % 16 == 0 : (p.lm == 4 || p.lm == 8);
  if (!lm_ok || p.ku <= 0 || p.rlm <= 0 || p.rlm % 4 != 0 ||
      p.rlm % p.lm != 0 || p.nt <= 0 || p.ksteps <= 0 || p.c <= 0 ||
      (p.mask && (p.ln <= 0 || p.c % p.ln != 0)))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(p.a) % 16 != 0)  // 16-byte A pieces
    return cudaErrorInvalidValue;
  switch (mode) {
    case 1: return dispatch_shape<K, 1>(p, bm, bn, nctas, stream, slots);
    case 3: return dispatch_shape<K, 3>(p, bm, bn, nctas, stream, slots);
    case 4: return dispatch_shape<K, 4>(p, bm, bn, nctas, stream, slots);
    case 6: return dispatch_shape<K, 6>(p, bm, bn, nctas, stream, slots);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pmma
