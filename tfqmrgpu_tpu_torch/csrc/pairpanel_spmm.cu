// Pair-plan block-sparse product on Hopper (sm_90a):
//
//   Y[iY] = sum_{p in [starts[iY], starts[iY+1])}  A[pair_a[p]] . X[pair_x[p]]
//
// with complex LM x LM blocks of A and LM x LN blocks of X and Y, each held
// as separate real and imaginary planes.  It replaces the TPU kernel K1,
// tfqmrgpu_tpu/ops/pairpanel.py::_make_call.kernel, which gathers a tile's
// union X blocks into VMEM and multiplies them with a fused union-ELL A
// panel on the MXU.
//
// 'z' (double): the FP64 tensor cores over a plan-time tile schedule
// (ops/pairpanel.py::build_tile_schedule).  A CTA of warps_m x warps_n warps
// (at most four) owns a tile of Y blocks, R block rows x W block columns, as
// one [R*LM, W*LN] complex accumulator held in registers; each warp holds a
// WTM x WTN part of it (at most 32 x 32: 64 accumulators a thread, so two
// CTAs of four warps fill an SM's registers).  Step k of the tile stacks the
// A blocks (i, k) of its rows into an [R*LM, LM] slice and puts the X
// blocks (k, c) of its columns side by side in an [LM, W*LN] slice, so
// every A and X block is staged once per tile and the tile is one dense
// product per step.  The steps stream through shared memory KC = min(LM, 8)
// deep in a ring of cp.async stages (four; six for LM <= 8, whose stages
// are short), with 16-byte copies (8-byte X copies for odd LN); each
// thread loads the block ids of its next stage's copies one stage ahead, so
// that no copy waits on a table read.  Absent blocks are staged as zeros
// (cp.async zero fill), and a warp whose rows have no A block in a step
// skips it (the step's slot mask; one warp-uniform test outside the MMA
// loop).  The products are mma.sync.m16n8k4 in FP64 (the sm_90 shape: the
// older m8n8k4 runs at half the rate on the H100), four a k-step for the
// complex product, re += Are.Xre + (-Aim).Xim and im += Are.Xim + Aim.Xre,
// the -Aim fragment negated in registers (exact).  Row strides of the
// staged slices (= 4 mod 16 doubles) keep the fragment reads free of bank
// conflicts.  Every Y element is written once, by one thread (16-byte
// stores for even LN); there are no atomics, so the sum order is fixed and
// repeated launches give identical bits.  Block sizes whose LM or LN is not
// a multiple of the MMA tile pad inside the tile: LM = 4 and 8 share one
// m16 fragment between 4 or 2 block rows, and LN = 4, 5, 9, 10 take
// WTN = 8 or 16 with W = floor(warps_n*WTN / LN) blocks a tile; the columns
// past W*LN are computed and never stored.
//
// What bounds it on the H100: at the golden-class shape (LM = LN = 32,
// 49,456 pairs) the work is 12.96 GFlop of FP64 over 198 MB of A, X and Y:
// 0.19 ms at the 67 TFlop/s of the FP64 tensor cores, against 0.06 ms for
// the bytes.  The schedule's 1 x 4 tiles stage 1.01 GB per multiply from
// L2 (the first design, one pair at a time, staged 1.62 GB).
//
// 'c' (float): the first design's loop over the pair table in FP32 FMAs
// (no TF32): one CTA of 256 threads owns G = max(1, 256 / (LM*LN)) Y
// blocks and stages each pair's A and X blocks in shared memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// ----------------------------------------------------------------- 'z'

constexpr int kMaxWarps = 4;

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? BYTES : 0;  // 0 source bytes: zero fill
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A . B on the FP64 tensor cores: A 16x4 (rows g, g+8; column t),
// B 4x8 (row t, column g), D 16x8 (rows g, g+8; columns 2t, 2t+1), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[2],
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int LM, int LN>
struct TileGeo {
  static constexpr int WTM = LM >= 32 ? 32 : 16;              // warp tile rows
  static constexpr int WTN = LN >= 32 ? 32 : (LN + 7) / 8 * 8;  // and columns
  static constexpr int FM = WTM / 16;     // m16 fragments of a warp
  static constexpr int FN = WTN / 8;      // n8 fragments of a warp
  static constexpr int KC = LM < 8 ? LM : 8;  // depth of one stage
  static constexpr int CH = LM / KC;      // stages of one step
  // row stride of the A slice, = 4 (mod 16) doubles: the 16 lanes of a
  // half warp read rows g and columns t at 16 distinct bank pairs
  static constexpr int AS = KC % 8 == 0 ? KC + 4 : KC;
  static constexpr int XV = LN % 2 == 0 ? 2 : 1;  // doubles of one X copy
  static constexpr int XP = LN / XV;      // X copies of one block row
  static constexpr int AP = KC / 2;       // 16-byte A copies of a slice row
  static constexpr int SPAN = LM < 16 ? 16 / LM : 1;  // A slots of a fragment
  // copies of one thread per stage, at most (M*AP and W*KC*XP over the
  // CTA's threads, for any warp grid)
  static constexpr int PA = (WTM * KC + 63) / 64;
  static constexpr int PX = (WTN * KC + 32 * XV - 1) / (32 * XV);
  // ring depth: small blocks make short stages, so more of them in flight
  static constexpr int NST = LM <= 8 ? 6 : 4;
  static_assert(LM % 4 == 0, "the MMA depth is 4");
};

// Shared memory of one launch: the ring's slot masks, then per stage
// [A re | A im] (M x AS each) and [X re | X im] (KC x SN each, SN = N + 4,
// which keeps the B fragment reads free of bank conflicts as well).
template <int LM, int LN>
__host__ __device__ constexpr size_t stage_doubles(int m, int n) {
  using G = TileGeo<LM, LN>;
  return 2 * static_cast<size_t>(m) * G::AS + 2 * G::KC * (n + 4);
}

template <int LM, int LN>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
pairpanel_spmm_mma_kernel(const double* __restrict__ a_re,
                          const double* __restrict__ a_im,
                          const double* __restrict__ x_re,
                          const double* __restrict__ x_im,
                          const int* __restrict__ tile_steps,
                          const int* __restrict__ tile_y,
                          const int* __restrict__ step_a,
                          const int* __restrict__ step_x,
                          const unsigned long long* __restrict__ step_mask,
                          double* __restrict__ y_re, double* __restrict__ y_im,
                          int R, int W, int warps_n) {
  using G = TileGeo<LM, LN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* s_mask = reinterpret_cast<unsigned long long*>(smem_raw);
  double* s_data = reinterpret_cast<double*>(smem_raw + 16 * G::NST);

  const int nthreads = blockDim.x;
  const int warps_m = nthreads / 32 / warps_n;
  const int M = warps_m * G::WTM;  // == R * LM
  const int N = warps_n * G::WTN;  // >= W * LN
  const int SN = N + 4;
  const int a_plane = M * G::AS;
  const int x_plane = G::KC * SN;
  const int stage = static_cast<int>(stage_doubles<LM, LN>(M, N));
  const int na = M * G::AP;           // A copies of a stage
  const int nx = W * G::KC * G::XP;   // X copies of a stage

  const int tile = blockIdx.x;
  const int step0 = tile_steps[tile];
  const int nst = (tile_steps[tile + 1] - step0) * G::CH;
  const int tid = threadIdx.x;

  // The block ids a thread's copies of the next stage read, loaded one
  // stage ahead so that their latency hides behind a stage's products.
  int id_a[G::PA], id_x[G::PX];
  unsigned long long id_mask = 0;
  auto load_ids = [&](int s) {
    const int step = step0 + s / G::CH;
#pragma unroll
    for (int p = 0; p < G::PA; ++p) {
      const int e = tid + p * nthreads;
      id_a[p] = e < na ? step_a[static_cast<size_t>(step) * R + e / G::AP / LM]
                       : -1;
    }
#pragma unroll
    for (int p = 0; p < G::PX; ++p) {
      const int e = tid + p * nthreads;
      id_x[p] = e < nx
                    ? step_x[static_cast<size_t>(step) * W + e / (G::KC * G::XP)]
                    : -1;
    }
    if (tid == 0) id_mask = step_mask[step];
  };

  // stage s: step step0 + s / CH, depth k0 = (s % CH) * KC of its blocks,
  // with the ids load_ids(s) brought
  auto fetch = [&](int s) {
    const int buf = s % G::NST;
    const int k0 = (s % G::CH) * G::KC;
    double* st = s_data + static_cast<size_t>(buf) * stage;
    if (tid == 0) s_mask[buf] = id_mask;
#pragma unroll
    for (int p = 0; p < G::PA; ++p) {
      const int e = tid + p * nthreads;
      if (e >= na) break;
      const int m = e / G::AP, q = e % G::AP;  // slice row, 16-byte piece
      const int ia = id_a[p];
      const size_t g =
          ia >= 0 ? (static_cast<size_t>(ia) * LM + m % LM) * LM + k0 + 2 * q
                  : 0;
      double* dst = st + m * G::AS + 2 * q;
      cp_async_zfill<16>(dst, a_re + g, ia >= 0);
      cp_async_zfill<16>(dst + a_plane, a_im + g, ia >= 0);
    }
#pragma unroll
    for (int p = 0; p < G::PX; ++p) {
      const int e = tid + p * nthreads;
      if (e >= nx) break;
      const int w = e / (G::KC * G::XP), rest = e % (G::KC * G::XP);
      const int kk = rest / G::XP, q = rest % G::XP;
      const int ix = id_x[p];
      const size_t g =
          ix >= 0 ? (static_cast<size_t>(ix) * LM + k0 + kk) * LN + G::XV * q
                  : 0;
      double* dst = st + 2 * a_plane + kk * SN + w * LN + G::XV * q;
      cp_async_zfill<8 * G::XV>(dst, x_re + g, ix >= 0);
      cp_async_zfill<8 * G::XV>(dst + x_plane, x_im + g, ix >= 0);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp / warps_n) * G::WTM, n0 = (warp % warps_n) * G::WTN;
  // the A slots under this warp's rows: one when FM = 2 (LM >= 32), SPAN
  // for a single fragment
  unsigned long long wbits = 0;
#pragma unroll
  for (int fm = 0; fm < G::FM; ++fm)
    wbits |= ((1ull << G::SPAN) - 1) << ((m0 + fm * 16) / LM);

  double acc_re[G::FM][G::FN][4], acc_im[G::FM][G::FN][4];
#pragma unroll
  for (int fm = 0; fm < G::FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < G::FN; ++fn)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc_re[fm][fn][v] = 0.0;
        acc_im[fm][fn][v] = 0.0;
      }

  for (int s = 0; s < G::NST - 1; ++s) {
    if (s < nst) {
      load_ids(s);
      fetch(s);
    }
    cp_async_commit();
  }
  if (G::NST - 1 < nst) load_ids(G::NST - 1);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<G::NST - 2>();  // stage s has landed
    // ... for every thread; and every warp is done with stage s - 1,
    // whose buffer the next fetch refills
    __syncthreads();
    if (s + G::NST - 1 < nst) {
      fetch(s + G::NST - 1);
      if (s + G::NST < nst) load_ids(s + G::NST);
    }
    cp_async_commit();
    const int buf = s % G::NST;
    // a warp whose rows have no A block in this step has nothing to add
    // (warp-uniform, and outside the MMA loop, which it would split)
    if (!(s_mask[buf] & wbits)) continue;
    const double* sa_re = s_data + static_cast<size_t>(buf) * stage;
    const double* sa_im = sa_re + a_plane;
    const double* sx_re = sa_re + 2 * a_plane;
    const double* sx_im = sx_re + x_plane;
#pragma unroll
    for (int k4 = 0; k4 < G::KC; k4 += 4) {
      double b_re[G::FN], b_im[G::FN];
#pragma unroll
      for (int fn = 0; fn < G::FN; ++fn) {
        const int o = (k4 + tq) * SN + n0 + fn * 8 + gq;
        b_re[fn] = sx_re[o];
        b_im[fn] = sx_im[o];
      }
#pragma unroll
      for (int fm = 0; fm < G::FM; ++fm) {
        const int o = (m0 + fm * 16 + gq) * G::AS + k4 + tq;
        const double ar[2] = {sa_re[o], sa_re[o + 8 * G::AS]};
        const double ai[2] = {sa_im[o], sa_im[o + 8 * G::AS]};
        const double nai[2] = {-ai[0], -ai[1]};
        // two passes, so that an MMA never waits on the one just before
#pragma unroll
        for (int fn = 0; fn < G::FN; ++fn) {
          mma_f64(acc_re[fm][fn], ar, b_re[fn]);
          mma_f64(acc_im[fm][fn], ar, b_im[fn]);
        }
#pragma unroll
        for (int fn = 0; fn < G::FN; ++fn) {
          mma_f64(acc_re[fm][fn], nai, b_im[fn]);
          mma_f64(acc_im[fm][fn], ai, b_re[fn]);
        }
      }
    }
  }

  // epilogue: tile element (m, n) is element (m % LM, n % LN) of the Y
  // block in slot (m / LM, n / LN), written by this thread alone
  const int* ty = tile_y + static_cast<size_t>(tile) * R * W;
#pragma unroll
  for (int fm = 0; fm < G::FM; ++fm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + fm * 16 + gq + 8 * h;
      const int r = m / LM, i = m % LM;
#pragma unroll
      for (int fn = 0; fn < G::FN; ++fn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // for even LN, columns 2t and 2t+1 lie in one block: one 16-byte
          // store of both
          if (G::XV == 2 && e == 1) continue;
          const int n = n0 + fn * 8 + 2 * tq + e;
          const int w = n / LN;
          if (w >= W) continue;
          const int ys = ty[r * W + w];
          if (ys < 0) continue;
          const size_t g = (static_cast<size_t>(ys) * LM + i) * LN + n % LN;
          const double* re = &acc_re[fm][fn][2 * h];
          const double* im = &acc_im[fm][fn][2 * h];
          if (G::XV == 2) {
            *reinterpret_cast<double2*>(y_re + g) = make_double2(re[0], re[1]);
            *reinterpret_cast<double2*>(y_im + g) = make_double2(im[0], im[1]);
          } else {
            y_re[g] = re[e];
            y_im[g] = im[e];
          }
        }
    }
}

template <int LM, int LN>
cudaError_t launch_tiles(const void* a_re, const void* a_im, const void* x_re,
                         const void* x_im, const void* tile_steps,
                         const void* tile_y, const void* step_a,
                         const void* step_x, const void* step_mask,
                         void* y_re, void* y_im, int ntiles, int warps_m,
                         int warps_n, int R, int W, cudaStream_t stream) {
  using G = TileGeo<LM, LN>;
  const int warps = warps_m * warps_n;
  if (warps_m < 1 || warps_n < 1 || warps > kMaxWarps ||
      R * LM != warps_m * G::WTM || W < 1 || W * LN > warps_n * G::WTN ||
      R > 64)
    return cudaErrorInvalidValue;
  if (ntiles <= 0) return cudaSuccess;
  const size_t smem =
      16 * G::NST + sizeof(double) * G::NST *
                        stage_doubles<LM, LN>(warps_m * G::WTM,
                                              warps_n * G::WTN);
  auto kernel = pairpanel_spmm_mma_kernel<LM, LN>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(ntiles), 32 * warps, smem, stream>>>(
      static_cast<const double*>(a_re), static_cast<const double*>(a_im),
      static_cast<const double*>(x_re), static_cast<const double*>(x_im),
      static_cast<const int*>(tile_steps), static_cast<const int*>(tile_y),
      static_cast<const int*>(step_a), static_cast<const int*>(step_x),
      static_cast<const unsigned long long*>(step_mask),
      static_cast<double*>(y_re), static_cast<double*>(y_im), R, W, warps_n);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- 'c'

constexpr int kThreads = 256;

template <int LM, int LN>
struct Geometry {
  static constexpr int NA = LM * LM;                         // A block elements
  static constexpr int NE = LM * LN;                         // X / Y block elements
  static constexpr int TPG = NE < kThreads ? NE : kThreads;  // threads per Y block
  static constexpr int G = kThreads / TPG;                   // Y blocks per CTA
  static constexpr int E = NE / TPG;                         // outputs per thread
  static constexpr int ROWS = TPG / LN;                      // row step between them
  static_assert(NE % TPG == 0, "a Y block must split evenly over its threads");
  static_assert(TPG % LN == 0, "a thread's outputs must share one column");
};

template <int LM, int LN>
__global__ void __launch_bounds__(kThreads)
pairpanel_spmm_kernel(const float* __restrict__ a_re,
                      const float* __restrict__ a_im,
                      const float* __restrict__ x_re,
                      const float* __restrict__ x_im,
                      const int* __restrict__ starts,
                      const int* __restrict__ pair_a,
                      const int* __restrict__ pair_x,
                      float* __restrict__ y_re, float* __restrict__ y_im,
                      int nnzb_y) {
  using Geo = Geometry<LM, LN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = threadIdx.x / Geo::TPG;  // group (Y block) inside the CTA
  const int t = threadIdx.x % Geo::TPG;  // thread inside the group
  const long long iy = static_cast<long long>(blockIdx.x) * Geo::G + g;
  const bool owner = g < Geo::G && iy < nnzb_y;
  int p = 0, p_end = 0;
  if (owner) {
    p = starts[iy];
    p_end = starts[iy + 1];
  }
  float* s_are = reinterpret_cast<float*>(smem_raw) + g * (2 * Geo::NA + 2 * Geo::NE);
  float* s_aim = s_are + Geo::NA;
  float* s_xre = s_aim + Geo::NA;
  float* s_xim = s_xre + Geo::NE;
  const int i0 = t / LN;
  const int j = t % LN;

  float acc_re[Geo::E], acc_im[Geo::E];
#pragma unroll
  for (int r = 0; r < Geo::E; ++r) {
    acc_re[r] = 0.f;
    acc_im[r] = 0.f;
  }

  // Every thread of the CTA takes part in both barriers; a group whose
  // pair range is used up idles until the longest range of the CTA ends.
  // The barrier at the top also keeps the next stage from overwriting
  // blocks that are still being read.
  while (__syncthreads_or(p < p_end)) {
    const bool live = p < p_end;
    if (live) {
      const size_t ia = static_cast<size_t>(pair_a[p]) * Geo::NA;
      const size_t ix = static_cast<size_t>(pair_x[p]) * Geo::NE;
      for (int e = t; e < Geo::NA; e += Geo::TPG) {
        s_are[e] = a_re[ia + e];
        s_aim[e] = a_im[ia + e];
      }
      for (int e = t; e < Geo::NE; e += Geo::TPG) {
        s_xre[e] = x_re[ix + e];
        s_xim[e] = x_im[ix + e];
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = 0; k < LM; ++k) {
        const float xr = s_xre[k * LN + j];
        const float xi = s_xim[k * LN + j];
#pragma unroll
        for (int r = 0; r < Geo::E; ++r) {
          const int i = i0 + r * Geo::ROWS;
          const float ar = s_are[i * LM + k];
          const float ai = s_aim[i * LM + k];
          acc_re[r] += ar * xr - ai * xi;
          acc_im[r] += ar * xi + ai * xr;
        }
      }
    }
    ++p;
  }

  if (owner) {
    const size_t iy0 = static_cast<size_t>(iy) * Geo::NE;
#pragma unroll
    for (int r = 0; r < Geo::E; ++r) {  // element (i0 + r*ROWS, j) = t + r*TPG
      y_re[iy0 + t + r * Geo::TPG] = acc_re[r];
      y_im[iy0 + t + r * Geo::TPG] = acc_im[r];
    }
  }
}

template <int LM, int LN>
cudaError_t launch_pairs(const void* a_re, const void* a_im, const void* x_re,
                         const void* x_im, const void* starts,
                         const void* pair_a, const void* pair_x, void* y_re,
                         void* y_im, int nnzb_y, cudaStream_t stream) {
  using Geo = Geometry<LM, LN>;
  constexpr size_t smem = sizeof(float) * Geo::G * (2 * Geo::NA + 2 * Geo::NE);
  if (nnzb_y <= 0) return cudaSuccess;
  auto kernel = pairpanel_spmm_kernel<LM, LN>;
  if (smem > 48 * 1024) {  // (64,64) stages 64 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>((nnzb_y + Geo::G - 1) / Geo::G);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a_re), static_cast<const float*>(a_im),
      static_cast<const float*>(x_re), static_cast<const float*>(x_im),
      static_cast<const int*>(starts), static_cast<const int*>(pair_a),
      static_cast<const int*>(pair_x), static_cast<float*>(y_re),
      static_cast<float*>(y_im), nnzb_y);
  return cudaGetLastError();
}

// The reference's compiled block sizes (allowed_block_sizes.h:4-18).
#define TFQ_BLOCK_SIZES(X) \
  X(4, 4) X(4, 5) X(4, 8) X(4, 32) X(8, 8) X(8, 9) X(8, 10) X(8, 32) X(8, 64) \
  X(16, 16) X(16, 32) X(16, 64) X(32, 32) X(32, 64) X(64, 64)

}  // namespace

// C interface, loaded with ctypes.  Each returns the cudaError_t of the
// launch (0 on success), or -1 for a block size outside the compiled list.

// 'z': the tables of ops/pairpanel.py::TileSchedule for its warp grid.
extern "C" int tfq_pairpanel_spmm_f64(
    const void* a_re, const void* a_im, const void* x_re, const void* x_im,
    const void* tile_steps, const void* tile_y, const void* step_a,
    const void* step_x, const void* step_mask, void* y_re, void* y_im,
    int ntiles, int lm, int ln, int warps_m, int warps_n, int rows, int cols,
    void* stream) {
#define TFQ_TILES(M, N)                                                      \
  if (lm == M && ln == N)                                                    \
    return static_cast<int>(launch_tiles<M, N>(                              \
        a_re, a_im, x_re, x_im, tile_steps, tile_y, step_a, step_x,          \
        step_mask, y_re, y_im, ntiles, warps_m, warps_n, rows, cols,         \
        static_cast<cudaStream_t>(stream)));
  TFQ_BLOCK_SIZES(TFQ_TILES)
#undef TFQ_TILES
  return -1;
}

// 'c': the plan's pair table.
extern "C" int tfq_pairpanel_spmm_f32(const void* a_re, const void* a_im,
                                      const void* x_re, const void* x_im,
                                      const void* starts, const void* pair_a,
                                      const void* pair_x, void* y_re,
                                      void* y_im, int nnzb_y, int lm, int ln,
                                      void* stream) {
#define TFQ_PAIRS(M, N)                                                      \
  if (lm == M && ln == N)                                                    \
    return static_cast<int>(launch_pairs<M, N>(                              \
        a_re, a_im, x_re, x_im, starts, pair_a, pair_x, y_re, y_im, nnzb_y,  \
        static_cast<cudaStream_t>(stream)));
  TFQ_BLOCK_SIZES(TFQ_PAIRS)
#undef TFQ_PAIRS
  return -1;
}
