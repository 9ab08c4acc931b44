// The staged complex panel product of the bf16 split modes, which K2
// (pairpanel_tiles_bf16.cu) and K3 (rowtile_spmm_bf16.cu) both run on the
// BF16 tensor cores of Hopper (sm_90a) with wgmma.
//
// What it computes.  The same product as panel_stage.cuh, over the same
// kind of unit tables and work list (ops/paneltiles.py), with every float32
// operand split into bf16 planes and the product taken as a sum of bf16
// plane products, the splits and products of the JAX package's modes:
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
// Operands, both split once and laid out as the stages are staged:
// - A once an upload (paneltiles.bf16_planes): for each unit of 64 output
//   rows and each step of its union, a slab [chunk][plane][128 rows][KC]:
//   rows 0-63 the re rows of the unit, 64-127 its im rows, a tile's rows
//   zero at a step it has no block for (and past its rows), depth past LM
//   zero (LM 4 and 8 take a 16-deep step).  A stage is one box of it.
// - X once a multiply, by the split pass (split_x_bf16.cu): lane-major
//   planes [plane][lane block of 16][re|im][16 lanes][block rows, each
//   block padded to the step's depth], so that a stage's X, every plane,
//   both halves and the CTA's lanes, is one box.
// Both boxes land K-major with the 32- or 64-byte swizzle the wgmma
// descriptors name (KB, the bytes of a stage's depth).
//
// Work units.  A unit is 64 output rows by the CTA's lanes (LANES: 128
// wide, 32 narrow; ops/paneltiles.py, mma_shape) of the union tables: 64
// rows of one tile, or 64 / rlm whole tiles side by side sharing one X
// slab.  A CTA has two warpgroups, each owning 64 rows by LANES / 2 lanes
// (re and im), sharing the staged A.  Its wgmma width N = LANES takes the
// warpgroup's re and im lanes interleaved by 16, so a stage's products are
// two wgmmas a product term: the unit's re rows and its im rows against
// those lanes.  The four real products of a complex output land in one
// thread's registers, and the epilogue writes
//   y_re = P(re rows, re lanes) - P(im rows, im lanes)
//   y_im = P(re rows, im lanes) + P(im rows, re lanes),
// masked to X's pattern where a mask is given (K3), in 16-byte rows where
// Y's rows allow (lane pairs exchange halves by a shuffle).
//
// The pipeline.  A ring of NST stages (3-6: as many as fit, at most 6)
// with full and empty mbarriers;
// a stage is KC (16 or 32) depth rows of one union step, one TMA box of A
// and one of X.  Thread 0 keeps the ring NST - 1 stages ahead of the
// products, also across the CTA's units, so the next unit's first stages
// arrive during this one's epilogue; every thread walks the same schedule,
// and the copies are predicated inside the asm (no branch on the thread
// index while wgmmas are in flight).  Each warp releases a stage with one
// arrival once the wgmmas that read it are done.  Persistent CTAs (one an
// SM) walk the host's work list.  No atomics: every output is written once
// and the sum order is fixed, so repeated launches give the same bits.
//
// What bounds it on the H100: at the golden class the BF16 products of a
// mode (1 to 6 passes of 12.96 GFlop at 989 TFlop/s on the data sheet)
// against the A slabs and the X planes it stages from L2 (PERF.md gives
// each mode's bound, byte model and time).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "launch_count.cuh"
#include "hopper.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

namespace pmma {

using namespace hopper;

constexpr int THREADS = 256;           // two warpgroups
constexpr int BM = 64;                 // output rows of a unit (wgmma M)
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on H100

// The products of a mode: term i multiplies A plane a_of(i) with X plane
// x_of(i), in the order of pairpanel.SPLIT_TERMS.
template <int MODE>
struct Mode {
  static_assert(MODE == 1 || MODE == 3 || MODE == 4 || MODE == 6, "mode");
  static constexpr int PLANES = MODE == 1 ? 1 : MODE == 6 ? 3 : 2;
  static constexpr int TERMS = MODE;
  __host__ __device__ static constexpr int a_of(int i) {
    return MODE == 6 ? (i == 0 || i == 1 || i == 4 ? 0 : i == 5 ? 2 : 1)
                     : (i < 2 ? 0 : 1);
  }
  __host__ __device__ static constexpr int x_of(int i) {
    return MODE == 6 ? (i == 0 || i == 2 || i == 5 ? 0 : i == 4 ? 2 : 1)
                     : (i == 1 || i == 3 ? 1 : 0);
  }
};

// LANES: a CTA's lanes (128 wide, 32 narrow); P: planes; KB: the bytes of
// a stage's depth (32: 16 rows, one wgmma depth; 64: 32 rows, two)
template <int LANES, int P, int KB>
struct Cfg {
  static_assert(LANES == 128 || LANES == 32, "CTA lanes");
  static_assert(KB == 32 || KB == 64, "stage depth");
  static constexpr int N = LANES;                  // a warpgroup's width
  static constexpr int NACC = N / 2;               // registers of a D
  static constexpr int KC = KB / 2;                // bf16 rows of a stage
  static constexpr int KS = KB / 32;               // wgmma depths of it
  static constexpr int A_PLANE = 2 * BM * KB;      // 64 re + 64 im rows
  static constexpr int X_PLANE = 2 * LANES * KB;   // re and im lanes
  static constexpr int A_BYTES = P * A_PLANE;
  static constexpr int X_BYTES = P * X_PLANE;
  static constexpr int STAGE = (A_BYTES + X_BYTES + 1023) / 1024 * 1024;
  static constexpr int FREE = SMEM_LIMIT - 1024 - 256;
  static constexpr int NST = FREE / STAGE < 6 ? FREE / STAGE : 6;
  static constexpr int SMEM = NST * STAGE + 256 + 1024;
  static_assert(NST >= 3, "a ring of three stages or more");
};

// The stage depth (16 or 32 rows) at block size lm: 32 where a step holds
// them, else 16 (16-row stages took 15-42% longer at the golden class on
// an H100 80GB HBM3 at 700 W, bf16x6 with its deeper 6-stage ring
// included; PERF.md).
// ops/paneltiles.py's mma_stage_rows gives the same; the launch refuses
// another.
inline int stage_rows(int lm) {
  return (lm < 16 ? 16 : lm) % 32 == 0 ? 32 : 16;
}

struct Args {
  float* y_re;           // rows of ldy floats
  float* y_im;
  const unsigned char* mask;  // [n_rows/lm, c/ln], or null: keep everything
  const int* uslot;      // [ngroups, ksteps, nt]: the union's X block
  const int* ucount;     // [ngroups]: union steps of the group (>= 1)
  const int* abase;      // [ngroups]: the group's first A slab
  const int4* items;     // work list: (group, first row in tile, first lane, 0)
  const int* cta_start;  // [nctas + 1]
  long long ldy;
  int ntiles, rlm, lm, klm, c, ln, n_rows, nt, ksteps;
  unsigned long long* count;  // the launch counter (launch_count.cuh), or null
};

template <int LANES, int MODE, int KB>
__device__ __forceinline__ void run(const CUtensorMap* tma_a,
                                    const CUtensorMap* tma_x,
                                    const Args& p) {
  using Md = Mode<MODE>;
  constexpr int P = Md::PLANES;
  using C = Cfg<LANES, P, KB>;
  constexpr int NST = C::NST, N = C::N, NACC = C::NACC;
  extern __shared__ unsigned char smem_raw[];
  // the ring's stages on 1024-byte boundaries (the swizzle's period)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(smem + NST * C::STAGE);
  const uint32_t empty = full + 8 * NST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  count_launch(p.count);
  const int first = p.cta_start[blockIdx.x];
  const int nmine = p.cta_start[blockIdx.x + 1] - first;
  const int chunks = p.klm / C::KC;

  if (tid == 0) {
    for (int b = 0; b < NST; ++b) {
      mbar_init(full + 8 * b, 1);
      mbar_init(empty + 8 * b, THREADS / 32);   // every warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (nmine <= 0) return;

  // ---- the producer: every thread walks the CTA's units and their stages,
  // the sequence the warps consume, and keeps NST - 1 stages ahead; thread
  // 0 issues the copies
  int p_k = 0, p_st = 0, p_b = 0, issued = 0;
  uint32_t p_ph = 0;
  int4 p_it = __ldg(p.items + first);
  int p_cnt = __ldg(p.ucount + p_it.x);
  // issue the stages before global stage `limit`: the buffer of stage
  // `limit` - 1 - NST is released once every warp has waited for the
  // products of stage `limit` - NST
  auto produce = [&](int limit) {
    while (issued < limit && p_k < nmine) {
      if (p_st == p_cnt * chunks) {
        p_st = 0;
        if (++p_k < nmine) {
          p_it = __ldg(p.items + first + p_k);
          p_cnt = __ldg(p.ucount + p_it.x);
        }
        continue;
      }
      const int u = p_st / chunks, ch = p_st - u * chunks;
      mbar_wait(empty + 8 * p_b, p_ph ^ 1);
      const uint32_t bar = full + 8 * p_b;
      mbar_expect_tx(bar, C::A_BYTES + C::X_BYTES, tid == 0);
      const uint32_t stage = ring + p_b * C::STAGE;
      // A: the unit's slab of step u, chunk ch, every plane
      const int slab = __ldg(p.abase + p_it.x) + (p_it.y / BM) * p_cnt + u;
      tma_load_3d(stage, tma_a, bar, 0, 0, (slab * chunks + ch) * P,
                  tid == 0);
      // X: the step's block rows, the CTA's lanes, both halves, every plane
      const int blk = __ldg(p.uslot + (static_cast<size_t>(p_it.x) *
                                       p.ksteps + u) * p.nt);
      tma_load_5d(stage + C::A_BYTES, tma_x, bar, blk * p.klm + ch * C::KC,
                  0, 0, p_it.z / 16, 0, tid == 0);
      ++p_st;
      ++issued;
      if (++p_b == NST) {
        p_b = 0;
        p_ph ^= 1;
      }
    }
  };

  // ---- the products: warpgroup wg takes lanes wg*LANES/2.. of the unit;
  // warp w of it rows 16w.. (re and im rows)
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  auto release = [&](int bb) { mbar_arrive(empty + 8 * bb, lane == 0); };
  float acc_r[NACC], acc_i[NACC];     // the unit's re rows, its im rows
  int b = 0, consumed = 0;
  uint32_t ph = 0;
  const int ncc = p.mask ? p.c / p.ln : 0;
  const bool vec = p.ldy % 4 == 0 && p.c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.y_re) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.y_im) % 16 == 0;

  for (int k = 0; k < nmine; ++k) {
    const int4 it = __ldg(p.items + first + k);
    const int nst = __ldg(p.ucount + it.x) * chunks;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc_r[i] = acc_i[i] = 0.f;
    int pending = -1;   // the stage whose products may still be running
    for (int st = 0; st < nst; ++st, ++consumed) {
      produce(consumed + NST - 1);
      mbar_wait(full + 8 * b, ph);
      const uint32_t s_a = ring + b * C::STAGE;
      const uint32_t s_x = s_a + C::A_BYTES + wg * (C::X_PLANE / 2);
      wgmma_fence();
      static_for<0, C::KS>([&](auto kkc) {
        constexpr int kk = decltype(kkc)::value;
        static_for<0, Md::TERMS>([&](auto ic) {
          constexpr int i = decltype(ic)::value;
          const uint32_t a = s_a + Md::a_of(i) * C::A_PLANE + 32 * kk;
          const uint64_t xd =
              desc_sw<KB>(s_x + Md::x_of(i) * C::X_PLANE + 32 * kk, 8 * KB);
          WgmmaSS<N>::run(acc_r, desc_sw<KB>(a, 8 * KB), xd);
          WgmmaSS<N>::run(acc_i, desc_sw<KB>(a + BM * KB, 8 * KB), xd);
        });
      });
      wgmma_commit();
      wgmma_wait<1>();   // the stage before this one is done
      if (pending >= 0) release(pending);
      pending = b;
      if (++b == NST) {
        b = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      pin(acc_r[i]);
      pin(acc_i[i]);
    }
    release(pending);

    // ---- the epilogue.  Register 4jj + f of a D: row g + 8(f/2) of the
    // warp's 16, column 8jj + 2tq + f%2 of N, which is lane 16q + 8s +
    // 2tq + f%2 of the warpgroup (jj = 4q + 2h + s, h: re 0, im 1).  Lane
    // pairs swap halves: an even tq gets row g, lanes 2tq..+3, an odd one
    // row g+8, lanes 2tq-2..+1.
    const bool odd = tq & 1;
    const int r = 16 * w + g + (odd ? 8 : 0);      // row in the unit
    const int n = p.nt > 1 ? r / p.rlm : 0;
    const int t = it.x * p.nt + n;
    const int i = it.y + r - n * p.rlm;            // row in the tile
    const long long row = static_cast<long long>(t) * p.rlm + i;
    const bool live = n < p.nt && t < p.ntiles && i < p.rlm &&
                      row < p.n_rows;
    const unsigned char* mrow =
        p.mask ? p.mask + static_cast<size_t>(row / p.lm) * ncc : nullptr;
    float* yr = p.y_re + static_cast<size_t>(row) * p.ldy;
    float* yi = p.y_im + static_cast<size_t>(row) * p.ldy;
#pragma unroll
    for (int q = 0; q < N / 32; ++q)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* rr = acc_r + 4 * (4 * q + s);       // re lanes
        const float* ri = acc_r + 4 * (4 * q + 2 + s);   // im lanes
        const float* ir = acc_i + 4 * (4 * q + s);
        const float* ii = acc_i + 4 * (4 * q + 2 + s);
        float vr[4], vi[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          vr[f] = rr[f] - ii[f];
          vi[f] = ri[f] + ir[f];
        }
        const float sr0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? vr[0] : vr[2], 1);
        const float sr1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? vr[1] : vr[3], 1);
        const float si0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? vi[0] : vi[2], 1);
        const float si1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? vi[1] : vi[3], 1);
        float4 qr = odd ? make_float4(sr0, sr1, vr[2], vr[3])
                        : make_float4(vr[0], vr[1], sr0, sr1);
        float4 qi = odd ? make_float4(si0, si1, vi[2], vi[3])
                        : make_float4(vi[0], vi[1], si0, si1);
        const int j = it.z + wg * (N / 2) + 16 * q + 8 * s + 2 * (tq & 2);
        if (!live || j >= p.c) continue;
        if (mrow) {   // X's pattern, one read a block of LN lanes
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p.ln % 4 == 0) {
            if (!mrow[j / p.ln]) qr = qi = z;
          } else {
            float* er = &qr.x;
            float* ei = &qi.x;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j + e < p.c && !mrow[(j + e) / p.ln]) er[e] = ei[e] = 0.f;
          }
        }
        if (vec && j + 3 < p.c) {
          *reinterpret_cast<float4*>(yr + j) = qr;
          *reinterpret_cast<float4*>(yi + j) = qi;
        } else {
          const float* er = &qr.x;
          const float* ei = &qi.x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < p.c) {
              yr[j + e] = er[e];
              yi[j + e] = ei[e];
            }
        }
      }
  }
}

// ---- host side: the tensor maps, the instantiations and their launch

// The two tensor maps of a multiply, made once per A and per X buffer by
// the wrapper (maps: 2 x 128 bytes, A's then X's):
// - A: the slabs [n_boxes][128 rows][KC] bf16 (n_boxes = slabs * chunks *
//   planes), boxes {KC, 128, planes};
// - X: the lane-major planes [planes][nlb16][2][16][xrows] bf16, boxes
//   {KC, 16, 2, lanes / 16, planes}.
// Returns 0, a cudaError_t, or 1000 + the CUresult of a refused map.
inline int encode_maps(void* maps, const void* a, long long n_boxes,
                       const void* xs, long long xrows, int nlb16, int planes,
                       int kc, int lanes) {
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(xs) % 16 || xrows % 16 || n_boxes <= 0 ||
      (kc != 16 && kc != 32) || (lanes != 128 && lanes != 32) ||
      planes < 1 || planes > 3 || nlb16 <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap m[2];   // aligned here; the caller's buffer need not be
  const auto sw = kc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t k = static_cast<cuuint64_t>(kc);
  CUresult cr = encode<3>(
      &m[0], false, a, {k, 128, static_cast<cuuint64_t>(n_boxes)},
      {k * 2, k * 2 * 128},
      {static_cast<cuuint32_t>(kc), 128, static_cast<cuuint32_t>(planes)},
      sw);
  if (cr != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(cr);
  const cuuint64_t xr = static_cast<cuuint64_t>(xrows);
  cr = encode<5>(
      &m[1], false, xs,
      {xr, 16, 2, static_cast<cuuint64_t>(nlb16),
       static_cast<cuuint64_t>(planes)},
      {xr * 2, xr * 2 * 16, xr * 2 * 32,
       xr * 2 * 32 * static_cast<cuuint64_t>(nlb16)},
      {static_cast<cuuint32_t>(kc), 16, 2,
       static_cast<cuuint32_t>(lanes / 16), static_cast<cuuint32_t>(planes)},
      sw);
  if (cr != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(cr);
  memcpy(maps, m, sizeof(m));
  return cudaSuccess;
}

// K::template get<LANES, MODE, KB>() is a source's __global__ function,
// taking (tma_a, tma_x, Args).
template <class K, int LANES, int MODE, int KB>
cudaError_t launch_one(const void* maps, const Args& p, int nctas,
                       cudaStream_t stream, int* slots) {
  auto kernel = K::template get<LANES, MODE, KB>();
  constexpr int bytes = Cfg<LANES, Mode<MODE>::PLANES, KB>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (slots) {                   // the CTAs the card holds at once
    int dev = 0, nsm = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, THREADS, bytes)) != cudaSuccess)
      return err;
    *slots = (occ > 0 ? occ : 1) * nsm;
    return cudaSuccess;
  }
  CUtensorMap m[2];
  memcpy(m, maps, sizeof(m));
  kernel<<<nctas, THREADS, bytes, stream>>>(m[0], m[1], p);
  return cudaGetLastError();
}

// The instantiations: wide (128 lanes) and narrow (32) CTAs, 16- and
// 32-row stages.
template <class K, int MODE>
cudaError_t dispatch_shape(const void* maps, const Args& p, int lanes,
                           int kc, int nctas, cudaStream_t stream,
                           int* slots) {
  if (kc != stage_rows(p.lm)) return cudaErrorInvalidValue;
  if (lanes == 128)
    return kc == 32
               ? launch_one<K, 128, MODE, 64>(maps, p, nctas, stream, slots)
               : launch_one<K, 128, MODE, 32>(maps, p, nctas, stream, slots);
  if (lanes == 32)
    return kc == 32
               ? launch_one<K, 32, MODE, 64>(maps, p, nctas, stream, slots)
               : launch_one<K, 32, MODE, 32>(maps, p, nctas, stream, slots);
  return cudaErrorInvalidValue;
}

// Checks the arguments and launches mode ``mode`` (1, 3, 4 or 6 products)
// for CTAs of bm rows by bn lanes and stages of kc rows, or, with
// ``slots``, only reports the CTAs the card holds at once.
template <class K>
cudaError_t dispatch(const void* maps, const Args& p, int mode, int bm,
                     int bn, int kc, int nctas, cudaStream_t stream,
                     int* slots) {
  const bool lm_ok = p.lm >= 16 ? p.lm % 16 == 0 : (p.lm == 4 || p.lm == 8);
  if (!lm_ok || p.klm != (p.lm < 16 ? 16 : p.lm) || p.rlm <= 0 ||
      p.rlm % p.lm != 0 || p.nt <= 0 || p.ksteps <= 0 || p.c <= 0 ||
      bm != BM || (p.mask && (p.ln <= 0 || p.c % p.ln != 0)))
    return cudaErrorInvalidValue;
  switch (mode) {
    case 1: return dispatch_shape<K, 1>(maps, p, bn, kc, nctas, stream, slots);
    case 3: return dispatch_shape<K, 3>(maps, p, bn, kc, nctas, stream, slots);
    case 4: return dispatch_shape<K, 4>(maps, p, bn, kc, nctas, stream, slots);
    case 6: return dispatch_shape<K, 6>(maps, p, bn, kc, nctas, stream, slots);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pmma
