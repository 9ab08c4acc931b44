// Row-tile union-ELL block-sparse product on Hopper (sm_90a), FP32:
//
//   for every tile t and union block k (ascending):
//     xs = X[xcols[t, k]*LM : +LM, :]            (re and im, [LM, c])
//     d_r += A[t][:, k*LM : +LM] @ xs_re,  d_i += A[t][:, k*LM : +LM] @ xs_im
//   y_re = d_r[:rlm] - d_i[rlm:],  y_im = d_i[:rlm] + d_r[rlm:]
//
// with A[t] the fused [2*rlm, ku*LM] panel of tile t (re rows, then im rows),
// X and Y the [nr, c] panels (c = ncc*LN columns of right-hand sides), and
// Y masked to X's block pattern.  It replaces the TPU kernel K3,
// tfqmrgpu_tpu/ops/pallas_spmm.py::_make_call.kernel, in its exact-FP32
// ('highest') mode.  The TPU kernel kept the whole X panel in VMEM and
// gathered a tile's union rows into scratch; on the H100 the panel (37 MB
// at the golden-class shape) lives in device memory and L2, and the CTA
// gathers the rows it needs into shared memory, one depth chunk at a time.
//
// Design: a CTA of 256 threads owns a BM x BN block of one tile's outputs
// (rows of rlm, columns of c).  It walks the tile's union blocks k in
// ascending order and each block's LM rows in KC-deep chunks; for every
// chunk it stages the A slice (BM re rows and BM im rows, KC deep, stored
// transposed so that a thread's rows lie side by side) and the X rows
// [KC, BN] (re and im) in shared memory with 4-byte cp.async copies, two
// stages in flight: the copies of chunk s+1 run while chunk s is
// multiplied.  Out-of-range rows and columns are copied as zeros
// (cp.async's zero fill).  Each thread keeps a TM x TN micro-tile of y_re
// and y_im in registers, with its TM rows and TN columns contiguous, so
// that one depth step reads its A and X values as a few vector loads from
// shared memory for 4*TM*TN FMAs; it writes every output exactly once,
// masked, in the epilogue.  There are no atomics: the sum order is fixed
// and does not depend on r_tile (padding blocks add exact zeros) or on the
// CTA shape, and repeated launches give the same bits.  Two CTA shapes
// cover wide (c >= 64) and narrow right-hand sides; in the narrow one the
// threads run down the rows instead of along c.
//
// What bounds it on the H100: at the golden-class 'c' shape (LM = 32,
// r_tile = 2, ku = 12, c = 512, 141 tiles) the useful work is 12.96 GFlop
// over about 99 MB (A blocks 25 MB, X and Y 37 MB each), about 130 flop per
// byte, so it is bound by the FP32 pipe (67 TFlop/s: 0.19 ms), not by
// device memory (30 us).  Left for later work: TMA copies of whole A
// slices, reuse of X rows between neighbouring tiles through L2, and a
// tensor-core mode (3xTF32 or the like) only behind an accuracy gate.

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN, int TM, int TN, int KC>
struct Tiling {
  static constexpr int TX = BN / TN;   // threads along the columns
  static constexpr int TY = BM / TM;   // threads along the rows
  static constexpr int AS = BM + 4;    // row stride of the transposed A slice
  static constexpr int A_ELEMS = KC * AS;  // one plane of one stage
  static constexpr int X_ELEMS = KC * BN;
  static_assert(TX * TY == kThreads, "the micro-tiles must cover the CTA");
  static_assert(BN % TN == 0 && BM % TM == 0, "micro-tiles must divide");
};

template <int BM, int BN, int TM, int TN, int KC>
__global__ void __launch_bounds__(kThreads)
rowtile_spmm_kernel(const float* __restrict__ a_fused,
                    const int* __restrict__ xcols,
                    const float* __restrict__ x_re,
                    const float* __restrict__ x_im,
                    const unsigned char* __restrict__ mask,
                    float* __restrict__ y_re, float* __restrict__ y_im,
                    int rlm, int ku, int lm, int nr, int c, int ln,
                    int row_blocks) {
  using Tl = Tiling<BM, BN, TM, TN, KC>;
  // two stages of [A re | A im | X re | X im]
  __shared__ __align__(16) float smem[2][2 * Tl::A_ELEMS + 2 * Tl::X_ELEMS];

  const int tile = blockIdx.x / row_blocks;
  const int i0 = (blockIdx.x % row_blocks) * BM;  // first row inside the tile
  const int j0 = blockIdx.y * BN;                 // first column
  const int tid = threadIdx.x;
  const int tx = tid % Tl::TX;
  const int ty = tid / Tl::TX;
  const size_t kulm = static_cast<size_t>(ku) * lm;
  const float* a_tile = a_fused + static_cast<size_t>(tile) * 2 * rlm * kulm;
  const int* tile_cols = xcols + static_cast<size_t>(tile) * ku;
  const int chunks = lm / KC;
  const int nstages = ku * chunks;

  // stage s: union block k = s / chunks, rows q0 = (s % chunks)*KC of it
  auto fetch = [&](int s) {
    const int k = s / chunks, q0 = (s % chunks) * KC;
    float* st = smem[s & 1];
    const size_t acol = static_cast<size_t>(k) * lm + q0;
    for (int e = tid; e < BM * KC; e += kThreads) {
      const int r = e / KC, q = e % KC;           // coalesced along q
      const int i = i0 + r;
      const bool ok = i < rlm;
      const size_t g = static_cast<size_t>(ok ? i : 0) * kulm + acol + q;
      cp_async4(st + q * Tl::AS + r, a_tile + g, ok);
      cp_async4(st + Tl::A_ELEMS + q * Tl::AS + r,
                a_tile + static_cast<size_t>(rlm) * kulm + g, ok);
    }
    const size_t xrow0 = static_cast<size_t>(tile_cols[k]) * lm + q0;
    for (int e = tid; e < KC * BN; e += kThreads) {
      const int q = e / BN, jj = e % BN;          // coalesced along j
      const bool ok = j0 + jj < c;
      const size_t g = (xrow0 + q) * static_cast<size_t>(c) + (ok ? j0 + jj : 0);
      cp_async4(st + 2 * Tl::A_ELEMS + e, x_re + g, ok);
      cp_async4(st + 2 * Tl::A_ELEMS + Tl::X_ELEMS + e, x_im + g, ok);
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

  fetch(0);
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_are = smem[s & 1];
    const float* s_aim = s_are + Tl::A_ELEMS;
    const float* s_xre = s_are + 2 * Tl::A_ELEMS;
    const float* s_xim = s_xre + Tl::X_ELEMS;
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
  }

  // epilogue: every (row < nr, column < c) is written by exactly one thread
  const int ncc = c / ln;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = i0 + ty * TM + m;
    const long long row = static_cast<long long>(tile) * rlm + i;
    if (i >= rlm || row >= nr) continue;
    const unsigned char* mrow = mask + static_cast<size_t>(row / lm) * ncc;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int j = j0 + tx * TN + n;
      if (j >= c) continue;
      const bool keep = mrow[j / ln] != 0;
      const size_t g = static_cast<size_t>(row) * c + j;
      y_re[g] = keep ? acc_re[m][n] : 0.f;
      y_im[g] = keep ? acc_im[m][n] : 0.f;
    }
  }
}

template <int BM, int BN, int TM, int TN, int KC>
cudaError_t launch(const float* a_fused, const int* xcols, const float* x_re,
                   const float* x_im, const unsigned char* mask, float* y_re,
                   float* y_im, int ntiles, int rlm, int ku, int lm, int nr,
                   int c, int ln, cudaStream_t stream) {
  const int row_blocks = (rlm + BM - 1) / BM;
  const long long nblocks = static_cast<long long>(ntiles) * row_blocks;
  const int col_blocks = (c + BN - 1) / BN;
  if (nblocks > 0x7fffffffLL || col_blocks > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(nblocks),
                  static_cast<unsigned>(col_blocks));
  rowtile_spmm_kernel<BM, BN, TM, TN, KC><<<grid, kThreads, 0, stream>>>(
      a_fused, xcols, x_re, x_im, mask, y_re, y_im, rlm, ku, lm, nr, c, ln,
      row_blocks);
  return cudaGetLastError();
}

// The depth chunk KC divides LM: min(LM, 16) for the reference's LM values.
template <int BM, int BN, int TM, int TN>
cudaError_t dispatch_kc(const float* a_fused, const int* xcols,
                        const float* x_re, const float* x_im,
                        const unsigned char* mask, float* y_re, float* y_im,
                        int ntiles, int rlm, int ku, int lm, int nr, int c,
                        int ln, cudaStream_t stream) {
#define TFQ_KC(K)                                                            \
  if (lm % K == 0)                                                           \
    return launch<BM, BN, TM, TN, K>(a_fused, xcols, x_re, x_im, mask, y_re, \
                                     y_im, ntiles, rlm, ku, lm, nr, c, ln,   \
                                     stream);
  TFQ_KC(16)
  TFQ_KC(8)
  TFQ_KC(4)
#undef TFQ_KC
  return cudaErrorInvalidValue;  // LM not a multiple of 4
}

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  mask is the [nr/lm, c/ln] byte table of X's pattern.
extern "C" int tfq_rowtile_spmm_f32(const void* a_fused, const void* xcols,
                                    const void* x_re, const void* x_im,
                                    const void* mask, void* y_re, void* y_im,
                                    int ntiles, int rlm, int ku, int lm,
                                    int nr, int c, int ln, void* stream) {
  if (ntiles <= 0 || nr <= 0 || c <= 0) return cudaSuccess;
  if (lm <= 0 || ln <= 0 || c % ln != 0 || rlm % lm != 0)
    return cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(a_fused);
  const auto* xc = static_cast<const int*>(xcols);
  const auto* xr = static_cast<const float*>(x_re);
  const auto* xi = static_cast<const float*>(x_im);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* yr = static_cast<float*>(y_re);
  auto* yi = static_cast<float*>(y_im);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c >= 64)
    err = dispatch_kc<64, 64, 4, 4>(a, xc, xr, xi, mk, yr, yi, ntiles, rlm,
                                    ku, lm, nr, c, ln, s);
  else
    err = dispatch_kc<128, 8, 2, 2>(a, xc, xr, xi, mk, yr, yi, ntiles, rlm,
                                    ku, lm, nr, c, ln, s);
  return static_cast<int>(err);
}
