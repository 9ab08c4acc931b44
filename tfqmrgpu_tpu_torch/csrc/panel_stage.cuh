// The staged complex FP32 panel product that K2 (pairpanel_tiles.cu) and K3
// (rowtile_spmm.cu) both run on Hopper (sm_90a).
//
// What it computes.  Tiles of rlm output rows each own a fused A panel and a
// list of X blocks (LM rows each, ascending):
//
//   for every tile t and its k-th X block (k ascending):
//     acc += A[t][k*LM : +LM, :]^T-slice  @  X[block(t, k)*LM : +LM, :]
//   y_re = acc_re(re rows) - acc_im(im rows),  y_im = acc_im(re) + acc_re(im)
//
// A is stored depth-major, [ntiles, ku*LM, 2*rlm]: row d of a panel holds
// the rlm re entries and then the rlm im entries that multiply X row d of
// the tile's gathered rows.  X and Y are two planes (re, im) of rows with a
// common row stride, which covers K3's separate [nr, c] planes and K2's
// fused [n_rows, 2c] panel alike.  An optional byte mask [n_rows/LM, c/LN]
// zeroes blocks of Y outside X's pattern (K3).
//
// Work units.  A unit is BM output rows by BN lanes: BM rows of one tile
// where rlm >= BM, else nt = BM / rlm whole tiles side by side (a group).
// On wide lanes the host gives every group the ascending union of its
// tiles' X blocks (uslot), and for each union step and tile the block's
// index in that tile's panel, or -1 (ukidx): an X row is staged once a unit
// however many of its tiles use it, and a tile's threads skip the steps it
// has no block for.  On narrow lanes an X slab is small and a union of many
// short tiles would only add steps, so every tile gets a slab of its own
// and step s is each tile's own s-th block.  The sum order of every output
// is its tile's own k ascending, chunks ascending, FMAs in the order
// re += ar*xr, re -= ai*xi, im += ar*xi, im += ai*xr: it does not depend on
// the CTA shape, on nt, on the work list or on the SM count, padding adds
// nothing, there are no atomics and every output is written once, so
// repeated launches give the same bits.
//
// The pipeline.  A CTA walks a run of units of the host's work list
// (persistent: one wave of CTAs for the whole product; the host deals the
// units by their steps, longest first, so the CTAs end together and no
// stretch of long units lands on a few of them).  Its stage stream
// runs through the units without a break: stage = KC depth rows of the A
// slice [KC, 2*BM] and of the X rows [KC, 2*BN] (re | im), copied with
// 16-byte cp.async (A rows are contiguous in the depth-major layout; X
// rows fall back to 4-byte copies where the lanes or the pointers are not
// 16-byte aligned, a template branch), into a ring of NS stages with one
// barrier a stage, so that one unit's epilogue overlaps the next unit's
// copies.  A stage's position advances by increments; the block ids of a
// stage are themselves copied NS-1 stages ahead of the copies that need
// them, into a small ring beside the stages.  Each thread keeps a TM x TN
// complex micro-tile in registers and reads its operands of a depth step
// as four 16-byte loads.
//
// What bounds it on the H100: the FP32 pipe.  tools/fma_f32_probe.cu gives
// the rate this micro-tile sustains from shared memory with no copies; the
// kernels' share of it, and what the copies cost, are in PERF.md.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "launch_count.cuh"

// The ring depth; tools/kernel_compare.py times others (-DTFQ_PANEL_STAGES=n).
#ifndef TFQ_PANEL_STAGES
#define TFQ_PANEL_STAGES 5
#endif

namespace panel {

constexpr int kMaxRun = 64;      // units of one CTA's run (headers in smem)
constexpr int kStages = TFQ_PANEL_STAGES;

__device__ __forceinline__ void cp_async4(float* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;  // 0 source bytes: the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* smem) {
  return *reinterpret_cast<const float4*>(smem);
}

struct Args {
  const float* a;        // [ntiles, ku*lm, 2*rlm], depth-major panels
  const float* x_re;     // rows of ldx floats
  const float* x_im;
  float* y_re;           // rows of ldy floats
  float* y_im;
  const unsigned char* mask;  // [n_rows/lm, c/ln], or null: keep everything
  const int* uslot;      // [ngroups, ksteps, nt]: tile n's X block of a step
  const int* ukidx;      // [ngroups, ksteps, nt]: its index in tile n, or -1
  const int* ucount;     // [ngroups]: union steps of the group (>= 1)
  const int4* items;     // work list: (group, first row in tile, first lane, 0)
  const int* cta_start;  // [nctas + 1]: CTA b runs items cta_start[b : b+2]
  long long ldx, ldy;
  int ntiles, rlm, ku, lm, c, ln, n_rows, nt, ksteps;
  unsigned long long* count;  // the launch counter (launch_count.cuh), or null
};

// UNION_: the tiles of a unit share one X slab (the union of their blocks);
// else every tile has its own (narrow lanes, where a slab is small and a
// union of many short tiles would only add steps).
template <int BM_, int BN_, int TM_, int TN_, int KC_, bool UNION_>
struct Tiling {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KC = KC_;
  static constexpr bool UNION = UNION_;
  static constexpr int NT_MAX = BM / 4;    // most tiles side by side
  static constexpr int SLABS = UNION ? 1 : NT_MAX;
  static constexpr int NS = kStages;
  static constexpr int TX = BN / TN;       // threads along the lanes
  static constexpr int TY = BM / TM;       // threads along the rows
  static constexpr int THREADS = TX * TY;
  static constexpr int A_ROW = 2 * BM;     // a depth row of A: re | im
  static constexpr int X_ROW = 2 * BN;     // a depth row of X: re | im
  static constexpr int X_OFF = KC * A_ROW;
  static constexpr int X_SLAB = KC * X_ROW;
  static constexpr int STAGE = X_OFF + SLABS * X_SLAB;  // floats of a stage
  static constexpr int ID_ROW = 2 * NT_MAX;  // per tile: X block, then index
  static constexpr int ID_ROWS = 2 * NS - 1;        // rows of the id ring
  static constexpr int ID_INTS = (ID_ROWS * ID_ROW + 3) / 4 * 4;
  static constexpr int A_PIECES = KC * A_ROW / 4;   // 16-byte pieces of A
  static constexpr int NA = (A_PIECES + THREADS - 1) / THREADS;
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * (NS * STAGE + ID_INTS) + sizeof(int4) * kMaxRun;
  static_assert(BN % TN == 0 && BM % TM == 0, "micro-tiles must divide");
  static_assert(BM % 4 == 0 && BN % 4 == 0 && TM % 2 == 0,
                "rows and lanes are copied in 16-byte pieces");
  static_assert(ID_ROW <= THREADS, "one thread copies one id of a row");
  static_assert(BM % 4 == 0, "tiles have multiples of 4 rows");
  static_assert(NS >= 2 && NS <= 8, "ring depth");
};

// The whole product of one CTA.  VX4: X rows in 16-byte pieces (lanes and
// pointers 16-byte aligned), else in 4-byte pieces.
template <class Tl, bool VX4>
__device__ __forceinline__ void run(const Args& p) {
  constexpr int BM = Tl::BM, BN = Tl::BN, TM = Tl::TM, TN = Tl::TN;
  constexpr int KC = Tl::KC, NS = Tl::NS, NA = Tl::NA;
  constexpr int THREADS = Tl::THREADS;
  extern __shared__ __align__(16) float smem[];
  int* s_ids = reinterpret_cast<int*>(smem + NS * Tl::STAGE);
  int4* s_items = reinterpret_cast<int4*>(s_ids + Tl::ID_INTS);
  count_launch(p.count);

  const int tid = threadIdx.x;
  const int tx = tid % Tl::TX;
  const int ty = tid / Tl::TX;
  const int first = p.cta_start[blockIdx.x];
  const int nmine = p.cta_start[blockIdx.x + 1] - first;
  const int chunks = p.lm / KC;
  const size_t a_row = 2 * static_cast<size_t>(p.rlm);  // of a depth row

  // the run's item headers, with the step count of each item's group
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

  // this thread's A copies: piece i sits at depth row a_q(i), column
  // a_col(i) of every stage's slice (re columns [0, BM), im [BM, 2*BM));
  // kept are its tile in the unit (-1: never copied) and its row there
  auto a_q = [&](int i) { return (tid + i * THREADS) / (Tl::A_ROW / 4); };
  auto a_col = [&](int i) {
    return ((tid + i * THREADS) % (Tl::A_ROW / 4)) * 4;
  };
  int a_n[NA], a_rin[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = a_col(i) % BM;
    const int n = p.nt > 1 ? r / p.rlm : 0;
    a_rin[i] = r - n * p.rlm;
    a_n[i] = (tid + i * THREADS < Tl::A_PIECES && n < p.nt) ? n : -1;
  }

  // this thread's tile in a unit (its TM rows lie in one tile)
  const int my_n = p.nt > 1 ? (ty * TM) / p.rlm : 0;
  const bool my_ok = my_n < p.nt;

  // ---- the fetch side.  Stage g's block ids (the X block and its index in
  // each tile's panel) ride in row g % ID_ROWS of the id ring: they are
  // copied with the stage that is fetched NS-1 stages before g, so they have
  // landed, under that stage's barrier, when stage g's copies need them and
  // when its product reads them as skip flags.
  struct Cursor { int item, u, ch, steps; };
  auto advance = [&](Cursor& k) {
    if (++k.ch == chunks) {
      k.ch = 0;
      if (++k.u == k.steps) {
        k.u = 0;
        ++k.item;
        k.steps = k.item < nmine ? s_items[k.item].w : 0;
      }
    }
  };
  auto copy_ids = [&](const Cursor& k, int row) {
    if (tid < 2 * p.nt) {
      const size_t base =
          (static_cast<size_t>(s_items[k.item].x) * p.ksteps + k.u) * p.nt;
      const bool slot = tid < p.nt;
      const int n = slot ? tid : tid - p.nt;
      cp_async4(reinterpret_cast<float*>(s_ids + row * Tl::ID_ROW +
                                         (slot ? 0 : Tl::NT_MAX) + n),
                (slot ? p.uslot : p.ukidx) + base + n, true);
    }
  };
  Cursor ahead{0, 0, 0, s_items[0].w};   // the stage whose ids are copied
  Cursor fet = ahead;                    // the stage that is fetched
  int ahead_row = 0, ahead_stage = 0, f_row = 0, f_buf = 0;
  for (; ahead_stage < NS - 1 && ahead_stage < total; ++ahead_stage) {
    copy_ids(ahead, ahead_row++);
    advance(ahead);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float* a_src[NA];
  int f_j0 = 0;
  // one X slab a unit: the union's, or a unit's only tile's
  const bool one_slab = Tl::UNION || p.nt == 1;
  size_t x_off = 0;              // that slab's first float
  auto fetch = [&]() {           // one stage into buffer f_buf, then advance
    const int* ids = s_ids + f_row * Tl::ID_ROW;
    if (fet.ch == 0) {           // a new step: its sources
      const int4 it = s_items[fet.item];
      f_j0 = it.z;
      if (one_slab)
        x_off = static_cast<size_t>(ids[0]) * p.lm * p.ldx + it.z;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int kidx = a_n[i] >= 0 ? ids[Tl::NT_MAX + a_n[i]] : -1;
        const int t = it.x * p.nt + a_n[i];
        const bool ok = kidx >= 0 && t < p.ntiles && it.y + a_rin[i] < p.rlm;
        a_src[i] = ok ? p.a + (static_cast<size_t>(t) * p.ku + kidx) * p.lm *
                                  a_row +
                            (a_col(i) / BM) * p.rlm + it.y + a_rin[i]
                      : nullptr;
      }
    }
    float* st = smem + f_buf * Tl::STAGE;
    const int q0 = fet.ch * KC;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (tid + i * THREADS < Tl::A_PIECES) {
        const bool ok = a_src[i] != nullptr;
        cp_async16(st + a_q(i) * Tl::A_ROW + a_col(i),
                   ok ? a_src[i] + (q0 + a_q(i)) * a_row : p.a, ok);
      }
    }
    // X rows: one slab for the unit, or one for each of its tiles
    constexpr int VW = VX4 ? 4 : 1;              // floats of one copy
    constexpr int PER = KC * BN / VW;            // copies of a slab's plane
    auto copy_x = [&](float* d, const float* re, const float* im, size_t g,
                      bool ok) {
      if constexpr (VX4) {
        cp_async16(d, re + g, ok);
        cp_async16(d + BN, im + g, ok);
      } else {
        cp_async4(d, re + g, ok);
        cp_async4(d + BN, im + g, ok);
      }
    };
    if (one_slab) {
      for (int e = tid; e < PER; e += THREADS) {
        const int q = e / (BN / VW), jj = (e % (BN / VW)) * VW;
        const bool ok = f_j0 + jj < p.c;
        copy_x(st + Tl::X_OFF + q * Tl::X_ROW + jj, p.x_re, p.x_im,
               ok ? x_off + (q0 + q) * static_cast<size_t>(p.ldx) + jj : 0,
               ok);
      }
    } else {
      for (int e = tid; e < p.nt * PER; e += THREADS) {
        const int n = e / PER, r = e % PER;
        const int q = r / (BN / VW), jj = (r % (BN / VW)) * VW;
        const bool ok = f_j0 + jj < p.c && ids[Tl::NT_MAX + n] >= 0;
        const size_t row = static_cast<size_t>(ids[n]) * p.lm + q0 + q;
        copy_x(st + Tl::X_OFF + n * Tl::X_SLAB + q * Tl::X_ROW + jj, p.x_re,
               p.x_im, ok ? row * p.ldx + f_j0 + jj : 0, ok);
      }
    }
    if (ahead_stage < total) {   // the ids of the stage NS-1 on
      copy_ids(ahead, ahead_row);
      advance(ahead);
      ++ahead_stage;
      if (++ahead_row == Tl::ID_ROWS) ahead_row = 0;
    }
    advance(fet);
    if (++f_buf == NS) f_buf = 0;
    if (++f_row == Tl::ID_ROWS) f_row = 0;
  };

  float acc_re[TM][TN], acc_im[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      acc_re[m][n] = 0.f;
      acc_im[m][n] = 0.f;
    }

  int fetched = 0;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (fetched < total) {
      fetch();
      ++fetched;
    }
    cp_async_commit();
  }

  // ---- the compute side
  int c_item = 0, c_left = s_items[0].w * chunks, c_buf = 0, c_row = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<NS - 2>();     // this thread's copies of stage s landed
    __syncthreads();             // everyone's did; stage s-1 is consumed
    if (fetched < total) {
      fetch();                   // refills the buffer of stage s-1
      ++fetched;
    }
    cp_async_commit();

    const float* st = smem + c_buf * Tl::STAGE;
    if (++c_buf == NS) c_buf = 0;
    const float* s_a = st + ty * TM;
    const float* s_x =
        st + Tl::X_OFF + (Tl::UNION ? 0 : my_n * Tl::X_SLAB) + tx * TN;
    const bool has =
        my_ok && s_ids[c_row * Tl::ID_ROW + Tl::NT_MAX + my_n] >= 0;
    if (++c_row == Tl::ID_ROWS) c_row = 0;
    if (has) {
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        float ar[TM], ai[TM], xr[TN], xi[TN];
        if constexpr (TM == 4 && TN == 4) {   // four 16-byte loads
          const float4 va = ld4(s_a + q * Tl::A_ROW);
          const float4 vb = ld4(s_a + q * Tl::A_ROW + BM);
          const float4 vc = ld4(s_x + q * Tl::X_ROW);
          const float4 vd = ld4(s_x + q * Tl::X_ROW + BN);
          ar[0] = va.x, ar[1] = va.y, ar[2] = va.z, ar[3] = va.w;
          ai[0] = vb.x, ai[1] = vb.y, ai[2] = vb.z, ai[3] = vb.w;
          xr[0] = vc.x, xr[1] = vc.y, xr[2] = vc.z, xr[3] = vc.w;
          xi[0] = vd.x, xi[1] = vd.y, xi[2] = vd.z, xi[3] = vd.w;
        } else {
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            ar[m] = s_a[q * Tl::A_ROW + m];
            ai[m] = s_a[q * Tl::A_ROW + BM + m];
          }
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            xr[n] = s_x[q * Tl::X_ROW + n];
            xi[n] = s_x[q * Tl::X_ROW + BN + n];
          }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            acc_re[m][n] = fmaf(ar[m], xr[n], acc_re[m][n]);
            acc_re[m][n] = fmaf(-ai[m], xi[n], acc_re[m][n]);
            acc_im[m][n] = fmaf(ar[m], xi[n], acc_im[m][n]);
            acc_im[m][n] = fmaf(ai[m], xr[n], acc_im[m][n]);
          }
      }
    }

    if (--c_left == 0) {
      // the unit is complete: write its outputs once and start the next
      const int4 it = s_items[c_item];
      const int t = it.x * p.nt + my_n;
      const int i0 = it.y + ty * TM - my_n * p.rlm;    // row inside the tile
      const int j0 = it.z + tx * TN;
      const int ncc = p.mask ? p.c / p.ln : 0;
      int jb[TN];                // the mask's column block of each lane
#pragma unroll
      for (int n = 0; n < TN; ++n)
        jb[n] = p.mask && j0 + n < p.c ? (j0 + n) / p.ln : -1;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const long long row = static_cast<long long>(t) * p.rlm + i0 + m;
        const bool row_ok =
            my_ok && t < p.ntiles && i0 + m < p.rlm && row < p.n_rows;
        if (row_ok) {
          const unsigned char* mrow =
              p.mask ? p.mask + static_cast<size_t>(row / p.lm) * ncc
                     : nullptr;
          float vr[TN], vi[TN];
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const bool keep = !mrow || (jb[n] >= 0 && mrow[jb[n]] != 0);
            vr[n] = keep ? acc_re[m][n] : 0.f;
            vi[n] = keep ? acc_im[m][n] : 0.f;
          }
          float* yr = p.y_re + static_cast<size_t>(row) * p.ldy + j0;
          float* yi = p.y_im + static_cast<size_t>(row) * p.ldy + j0;
          if constexpr (VX4 && TN == 4) {
            if (j0 < p.c) {       // c % 4 == 0: the four lanes lie inside
              *reinterpret_cast<float4*>(yr) =
                  make_float4(vr[0], vr[1], vr[2], vr[3]);
              *reinterpret_cast<float4*>(yi) =
                  make_float4(vi[0], vi[1], vi[2], vi[3]);
            }
          } else {
#pragma unroll
            for (int n = 0; n < TN; ++n)
              if (j0 + n < p.c) {
                yr[n] = vr[n];
                yi[n] = vi[n];
              }
          }
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          acc_re[m][n] = 0.f;
          acc_im[m][n] = 0.f;
        }
      }
      if (++c_item < nmine) c_left = s_items[c_item].w * chunks;
    }
  }
}

// ---- host side: the instantiations and their launch

// K names the kernel of a source: K::template get<Tl, VX4>() is its
// __global__ function for one tiling.
template <class K, class Tl, bool VX4>
cudaError_t launch_one(const Args& p, int nctas, cudaStream_t stream,
                       int* slots) {
  auto kernel = K::template get<Tl, VX4>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tl::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  if (slots) {                   // the CTAs the card holds at once
    int dev = 0, nsm = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, Tl::THREADS, Tl::SMEM_BYTES)) != cudaSuccess)
      return err;
    *slots = (occ > 0 ? occ : 1) * nsm;
    return cudaSuccess;
  }
  kernel<<<nctas, Tl::THREADS, Tl::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// The CTA shapes: wide (c >= 64 lanes, one X slab a unit) and narrow (a
// slab for each tile).  ops/paneltiles.py names the same two (WIDE, NARROW)
// and builds the unit tables for them.
// The depth chunk KC divides LM: min(LM, 16) for the reference's LM values.
template <class K, bool VX4>
cudaError_t dispatch_shape(const Args& p, int bm, int bn, int nctas,
                           cudaStream_t stream, int* slots) {
#define TFQ_PANEL_SHAPE(BM, BN, TM, TN, UNION)                                \
  if (bm == BM && bn == BN) {                                                 \
    if (p.lm % 16 == 0)                                                       \
      return launch_one<K, Tiling<BM, BN, TM, TN, 16, UNION>, VX4>(           \
          p, nctas, stream, slots);                                           \
    if (p.lm % 8 == 0)                                                        \
      return launch_one<K, Tiling<BM, BN, TM, TN, 8, UNION>, VX4>(            \
          p, nctas, stream, slots);                                           \
    if (p.lm % 4 == 0)                                                        \
      return launch_one<K, Tiling<BM, BN, TM, TN, 4, UNION>, VX4>(            \
          p, nctas, stream, slots);                                           \
    return cudaErrorInvalidValue; /* LM not a multiple of 4 */                \
  }
  TFQ_PANEL_SHAPE(64, 64, 4, 4, true)
  TFQ_PANEL_SHAPE(32, 8, 2, 2, false)
#undef TFQ_PANEL_SHAPE
  return cudaErrorInvalidValue;  // not a shape this library was built for
}

// Checks the arguments, picks the copy branch from them and launches (or,
// with ``slots``, only reports the CTAs the card holds at once).
template <class K>
cudaError_t dispatch(const Args& p, int bm, int bn, int nctas,
                     cudaStream_t stream, int* slots) {
  if (p.lm <= 0 || p.ku <= 0 || p.rlm <= 0 || p.rlm % p.lm != 0 ||
      p.nt <= 0 || p.ksteps <= 0 || p.c <= 0 ||
      (p.mask && (p.ln <= 0 || p.c % p.ln != 0)))
    return cudaErrorInvalidValue;
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (!aligned(p.a)) return cudaErrorInvalidValue;  // A rows: 16-byte pieces
  // 16-byte X copies and Y stores need 16-byte aligned rows and planes
  const bool vec = p.c % 4 == 0 && p.ldx % 4 == 0 && p.ldy % 4 == 0 &&
                   aligned(p.x_re) && aligned(p.x_im) && aligned(p.y_re) &&
                   aligned(p.y_im);
  return vec ? dispatch_shape<K, true>(p, bm, bn, nctas, stream, slots)
             : dispatch_shape<K, false>(p, bm, bn, nctas, stream, slots);
}

}  // namespace panel
