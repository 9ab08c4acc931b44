// Packed pair-plan product on Hopper (sm_90a), FP32 (K2):
//
//   for every tile t and union slot k < ku (ascending):
//     xs = X[xloc[t, k]*LM : +LM, :]              (re lanes and im lanes)
//     acc += A[t][:, k*LM : +LM] @ xs              ([2*rlm, 2*c])
//   Y[t*rlm + i, :] = [P1 - Q2 | P2 + Q1],  P = acc[:rlm], Q = acc[rlm:]
//
// with A[t] the fused [2*rlm, ku*LM] panel of tile t (re rows over im rows,
// rlm = r_tile*LM), X and Y the fused permuted panels [n_slots*LM, 2*c]
// (re in lanes [0, c), im in lanes [c, 2c)), index 1 the re lanes and 2 the
// im lanes, and rows at or past n_rows = n_slots*LM cut.  It replaces the
// TPU kernel tfqmrgpu_tpu/ops/pairpanel.py::_make_call.kernel_tile_pipe in
// its exact-FP32 ('highest') mode.  The TPU kernel held the whole X panel
// in VMEM, ran copy-code programs on the scalar core to gather tile j+1's
// union blocks into one of two per-tile buffers while the MXU multiplied
// tile j, and carried its state along a sequential grid.
//
// Design: CTAs of 256 threads, each owning one BN-wide block of Y's lanes
// for a run of consecutive work units.  A unit is BM rows of outputs: a
// block of rows of one tile when rlm >= BM, else nt = BM / rlm whole tiles
// side by side.  The CTA reads xloc itself.  Its stage stream runs through
// the units of the run, each unit's union slots k ascending and each slot's
// LM rows in KC-deep chunks, without a break: for every stage it copies the
// A slice (BM re rows and BM im rows, KC deep, stored transposed) and the
// union X rows [KC, BN] of its tiles (re and im lanes) into shared memory
// with 4-byte cp.async copies, two stages in flight, so that the copies of
// the next chunk, and at a unit's end those of the next tile, run while the
// current one is multiplied and the finished tile is written.  Ragged rows,
// lanes and tiles are copied as zeros.  Each thread keeps a TM x TN
// micro-tile of the re and im outputs in registers (its rows lie in one
// tile) and writes each output exactly once.  There are no atomics: the sum
// order is fixed (k ascending, chunks ascending; padding slots add exact
// zeros), so repeated launches give the same bits, and the result does not
// depend on the run length or on how many tiles a CTA holds side by side.
// Two CTA shapes cover wide (c >= 64) and narrow lanes, as in K3
// (rowtile_spmm.cu), whose stage layout this kernel shares.
//
// What bounds it on the H100: at the golden-class plan grouped by G = 8
// (LM = 32, r_tile = 1, ku = 12, c = 256, 562 tiles) the work is 12.96 GFlop
// needed and 14.14 GFlop packed, over 55 MB of A panels and 36.8 MB each of
// X and Y: bound by the FP32 pipe (0.19 ms at 67 TFlop/s), not by device
// memory (0.04 ms).  The micro-tiles give 16 FMAs per pair of shared-memory
// loads.  Left for later work: 16-byte or TMA copies, reuse of X rows that
// neighbouring tiles share, and a tensor-core mode behind an accuracy gate.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;  // 0 source bytes: the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* a;    // [ntiles, 2*rlm, ku*lm]
  const int* xloc;   // [ntiles, ku]
  const float* x;    // [n_rows, 2*c]
  float* y;          // [n_rows, 2*c]
  int ntiles, rlm, ku, lm, c, n_rows;
  int nt;            // tiles side by side in a unit (1 when rlm >= BM)
  int row_blocks;    // units per tile (1 when rlm < BM)
  int nunits;
  int run;           // consecutive units per CTA
  int xl_tiles;      // tiles whose xloc rows a CTA stages in shared memory
};

template <int BM, int BN, int TM, int TN, int KC>
struct Tiling {
  static constexpr int TX = BN / TN;   // threads along the lanes
  static constexpr int TY = BM / TM;   // threads along the rows
  static constexpr int AS = BM + 4;    // row stride of the transposed A slice
  static constexpr int A_ELEMS = KC * AS;
  static constexpr int NA = (BM * KC + kThreads - 1) / kThreads;  // A copies
  static_assert(TX * TY == kThreads, "the micro-tiles must cover the CTA");
  static_assert(BN % TN == 0 && BM % TM == 0, "micro-tiles must divide");
  static_assert(BN % 4 == 0, "X rows are copied in 16-byte pieces");
};

// The floats of shared memory one CTA uses for its two stages.
template <int BM, int BN, int TM, int TN, int KC>
size_t stage_floats(int nt) {
  using Tl = Tiling<BM, BN, TM, TN, KC>;
  return 2 * (2 * static_cast<size_t>(Tl::A_ELEMS)
              + 2 * static_cast<size_t>(nt) * KC * BN);
}

// VX: floats per X copy, 4 (16-byte pieces) where the lanes allow it, else 1
template <int BM, int BN, int TM, int TN, int KC, int VX>
__global__ void __launch_bounds__(kThreads)
pairpanel_tiles_kernel(const Args p) {
  using Tl = Tiling<BM, BN, TM, TN, KC>;
  extern __shared__ __align__(16) float smem[];
  const int x_elems = p.nt * KC * BN;            // one plane of one stage
  const int stage_elems = 2 * Tl::A_ELEMS + 2 * x_elems;
  int* s_xloc = reinterpret_cast<int*>(smem + 2 * stage_elems);

  const int j0 = blockIdx.y * BN;
  const int u0 = blockIdx.x * p.run;
  const int u1 = min(u0 + p.run, p.nunits);
  const int chunks = p.lm / KC;
  const int per_unit = p.ku * chunks;
  const int nstages = (u1 - u0) * per_unit;
  const size_t kulm = static_cast<size_t>(p.ku) * p.lm;
  const size_t ldx = 2 * static_cast<size_t>(p.c);  // row stride of X and Y
  const int tid = threadIdx.x;
  const int tx = tid % Tl::TX;
  const int ty = tid / Tl::TX;
  // this thread's tile in a unit (its TM rows lie in one tile) and the X
  // slab it reads (clamped: rows past nt*rlm are padding)
  const int my_n = p.nt > 1 ? (ty * TM) / p.rlm : 0;
  const int my_slab = min(my_n, p.nt - 1);

  // the A copies of this thread: the same slice positions at every stage
  int a_n[Tl::NA], a_r[Tl::NA];
#pragma unroll
  for (int i = 0; i < Tl::NA; ++i) {
    const int r = (tid + i * kThreads) / KC;
    a_n[i] = r >= BM ? p.nt : (p.nt > 1 ? r / p.rlm : 0);
    a_r[i] = r - a_n[i] * p.rlm;
  }

  // the xloc rows of the run's tiles, staged once
  const int tbase = (u0 / p.row_blocks) * p.nt;
  for (int e = tid; e < p.xl_tiles * p.ku; e += kThreads) {
    const long long t = tbase + e / p.ku;
    s_xloc[e] = t < p.ntiles
                    ? p.xloc[static_cast<size_t>(tbase) * p.ku + e] : 0;
  }
  __syncthreads();

  auto fetch = [&](int s) {
    const int u = u0 + s / per_unit;
    const int rem = s % per_unit;
    const int k = rem / chunks, q0 = (rem % chunks) * KC;
    const int tu = (u / p.row_blocks) * p.nt;      // the unit's first tile
    const int i0 = (u % p.row_blocks) * BM;        // and first row in it
    float* st = smem + (s & 1) * stage_elems;
    const size_t acol = static_cast<size_t>(k) * p.lm + q0;
#pragma unroll
    for (int i = 0; i < Tl::NA; ++i) {
      const int e = tid + i * kThreads;
      if (e < BM * KC) {
        const int r = e / KC, q = e % KC;        // coalesced along q
        const int t = tu + a_n[i], ii = i0 + a_r[i];
        const bool ok = a_n[i] < p.nt && t < p.ntiles && ii < p.rlm;
        const size_t g =
            ok ? (static_cast<size_t>(t) * 2 * p.rlm + ii) * kulm + acol + q
               : 0;
        cp_async4(st + q * Tl::AS + r, p.a + g, ok);
        cp_async4(st + Tl::A_ELEMS + q * Tl::AS + r,
                  p.a + g + static_cast<size_t>(p.rlm) * kulm, ok);
      }
    }
    const int* xl = s_xloc + (tu - tbase) * p.ku + k;
    constexpr int PER = KC * BN / VX;              // copies per tile slab
    for (int e = tid; e < p.nt * PER; e += kThreads) {
      const int n = e / PER, rem2 = e % PER;
      const int q = rem2 / (BN / VX), jj = (rem2 % (BN / VX)) * VX;
      const bool ok = tu + n < p.ntiles && j0 + jj < p.c;
      const size_t row =
          ok ? static_cast<size_t>(xl[n * p.ku]) * p.lm + q0 + q : 0;
      const size_t g = row * ldx + (ok ? j0 + jj : 0);
      float* d = st + 2 * Tl::A_ELEMS + e * VX;    // [n][q][BN] layout
      if constexpr (VX == 4) {
        cp_async16(d, p.x + g, ok);
        cp_async16(d + x_elems, p.x + g + p.c, ok);
      } else {
        cp_async4(d, p.x + g, ok);
        cp_async4(d + x_elems, p.x + g + p.c, ok);
      }
    }
    cp_async_commit();
  };

  float acc_re[TM][TN], acc_im[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      acc_re[m][n] = 0.f;
      acc_im[m][n] = 0.f;
    }

  if (nstages > 0) fetch(0);
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_are = smem + (s & 1) * stage_elems;
    const float* s_aim = s_are + Tl::A_ELEMS;
    const float* s_xre = s_are + 2 * Tl::A_ELEMS + my_slab * KC * BN;
    const float* s_xim = s_xre + x_elems;
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float ar[TM], ai[TM], xr[TN], xi[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        ar[m] = s_are[q * Tl::AS + ty * TM + m];
        ai[m] = s_aim[q * Tl::AS + ty * TM + m];
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        xr[n] = s_xre[q * BN + tx * TN + n];
        xi[n] = s_xim[q * BN + tx * TN + n];
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
    __syncthreads();  // the buffer is refilled by the fetch two stages on

    if ((s + 1) % per_unit == 0) {
      // the unit is complete: write its outputs once and start the next
      const int u = u0 + s / per_unit;
      const int t = (u / p.row_blocks) * p.nt + my_n;
      const int i = (u % p.row_blocks) * BM + ty * TM - my_n * p.rlm;
      const bool tile_ok = my_n < p.nt && t < p.ntiles;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const long long row = static_cast<long long>(t) * p.rlm + i + m;
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int j = j0 + tx * TN + n;
          if (tile_ok && i + m < p.rlm && row < p.n_rows && j < p.c) {
            const size_t g = static_cast<size_t>(row) * ldx + j;
            p.y[g] = acc_re[m][n];
            p.y[g + p.c] = acc_im[m][n];
          }
          acc_re[m][n] = 0.f;
          acc_im[m][n] = 0.f;
        }
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int KC, int VX>
cudaError_t launch(Args p, cudaStream_t stream) {
  p.nt = p.rlm < BM ? BM / p.rlm : 1;
  p.row_blocks = p.rlm < BM ? 1 : (p.rlm + BM - 1) / BM;
  const long long nunits =
      static_cast<long long>((p.ntiles + p.nt - 1) / p.nt) * p.row_blocks;
  const int col_blocks = (p.c + BN - 1) / BN;
  const size_t stage_bytes =
      sizeof(float) * stage_floats<BM, BN, TM, TN, KC>(p.nt);
  auto kernel = pairpanel_tiles_kernel<BM, BN, TM, TN, KC, VX>;
  constexpr size_t kMaxSmem = 227 * 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, kThreads, stage_bytes + 1024)) != cudaSuccess)
    return err;
  // one wave: the CTAs that fit the card at once, each taking a run of
  // consecutive units (the result does not depend on the run length),
  // shortened where the run's xloc rows would crowd shared memory
  const long long slots = static_cast<long long>(occ > 0 ? occ : 1) * nsm;
  long long run = (nunits * col_blocks + slots - 1) / slots;
  if (run < 1) run = 1;
  auto xl_tiles = [&](long long r) {  // a run may start inside a tile
    return p.row_blocks == 1 ? r * p.nt
                             : (r + p.row_blocks - 1) / p.row_blocks + 1;
  };
  while (run > 1 && xl_tiles(run) * p.ku * sizeof(int) > 32 * 1024)
    run = (run + 1) / 2;
  const long long nctas = (nunits + run - 1) / run;
  const size_t smem = stage_bytes + xl_tiles(run) * p.ku * sizeof(int);
  if (nunits > 0x7fffffffLL || nctas > 0x7fffffffLL || col_blocks > 65535 ||
      smem > kMaxSmem)
    return cudaErrorInvalidConfiguration;
  p.nunits = static_cast<int>(nunits);
  p.run = static_cast<int>(run);
  p.xl_tiles = static_cast<int>(xl_tiles(run));
  kernel<<<dim3(static_cast<unsigned>(nctas), col_blocks), kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

// The depth chunk KC divides LM: min(LM, 16) for the reference's LM values.
template <int BM, int BN, int TM, int TN, int VX>
cudaError_t dispatch_kc(const Args& p, cudaStream_t stream) {
  if (p.lm % 16 == 0) return launch<BM, BN, TM, TN, 16, VX>(p, stream);
  if (p.lm % 8 == 0) return launch<BM, BN, TM, TN, 8, VX>(p, stream);
  if (p.lm % 4 == 0) return launch<BM, BN, TM, TN, 4, VX>(p, stream);
  return cudaErrorInvalidValue;  // LM not a multiple of 4
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  c is the lane count of one plane (G*LN); x and y hold
// 2*c lanes per row and n_rows = n_slots*lm rows.
extern "C" int tfq_pairpanel_tiles_f32(const void* a_panels, const void* xloc,
                                       const void* x, void* y, int ntiles,
                                       int rlm, int ku, int lm, int c,
                                       int n_rows, void* stream) {
  if (ntiles <= 0 || n_rows <= 0 || c <= 0) return cudaSuccess;
  if (lm <= 0 || ku <= 0 || rlm <= 0 || rlm % lm != 0)
    return cudaErrorInvalidValue;
  Args p{static_cast<const float*>(a_panels), static_cast<const int*>(xloc),
         static_cast<const float*>(x), static_cast<float*>(y),
         ntiles, rlm, ku, lm, c, n_rows, 1, 1, 0, 1, 1};
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte X copies need 16-byte aligned rows and im lanes
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (c < 64)
    err = dispatch_kc<128, 8, 2, 2, 1>(p, s);
  else if (vec)
    err = dispatch_kc<64, 64, 4, 4, 4>(p, s);
  else
    err = dispatch_kc<64, 64, 4, 4, 1>(p, s);
  return static_cast<int>(err);
}
