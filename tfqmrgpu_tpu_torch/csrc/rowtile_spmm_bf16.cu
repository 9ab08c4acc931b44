// Row-tile union-ELL block-sparse product on the BF16 tensor cores of
// Hopper (sm_90a): K3 in the JAX package's bf16 split modes ('bf16x3',
// 'bf16x4', 'bf16x6'; its 'bf16' runs the exact-FP32 kernel, as the TPU
// kernel does).  It computes what rowtile_spmm.cu computes,
//
//   d_r = A[t] @ X_re[xcols[t]],  d_i = A[t] @ X_im[xcols[t]]
//   y_re = d_r[:rlm] - d_i[rlm:],  y_im = d_i[:rlm] + d_r[rlm:]
//
// masked to X's block pattern, with every product taken as the mode's sum
// of bf16 plane products, as the TPU kernel
// tfqmrgpu_tpu/ops/pallas_spmm.py::_make_call.kernel does in these modes
// (its dots, :236-263).  The TPU kernel split A once (shipped as hi/lo
// planes, or split in the kernel for 'bf16x6') and split the gathered X
// rows in VMEM; here A is split once per upload into bf16 planes
// (paneltiles.bf16_planes) and X inside the kernel from the float32 rows it
// loads.
//
// What bounds it on the H100, at the golden-class 'c' shape (LM 32, r_tile
// 2, ku 12, c 512): the mode's bf16 products, 3 to 6 passes of 12.96 GFlop
// at 989 TFlop/s, against the A planes (27.7 MB a plane) and X and Y.
//
// Design: the staged tensor-core product of panel_mma.cuh, which K2's split
// modes (pairpanel_tiles_bf16.cu) run too; X and Y are separate re and im
// planes with row stride c, and X's block mask is applied in the epilogue.

#include "panel_mma.cuh"

namespace {

template <class Tl, int MODE>
__global__ void __launch_bounds__(Tl::THREADS, 2)
rowtile_spmm_bf16_kernel(const pmma::Args p) {
  pmma::run<Tl, MODE>(p);
}

struct RowTileBf16 {
  template <class Tl, int MODE>
  static auto get() { return rowtile_spmm_bf16_kernel<Tl, MODE>; }
};

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  a_planes holds the bf16 planes [planes, ntiles,
// ku*lm/2, 2*rlm]; mask is the [nr/lm, c/ln] byte table of X's pattern;
// the unit tables and the work list are those of ops/paneltiles.py for CTAs
// of bm rows by bn columns; mode is 3, 4 or 6 (or 1).
extern "C" int tfq_rowtile_spmm_bf16(
    const void* a_planes, const void* x_re, const void* x_im,
    const void* mask, void* y_re, void* y_im, const void* uslot,
    const void* ukidx, const void* ucount, const void* items,
    const void* cta_start, int nctas, int ntiles, int rlm, int ku, int lm,
    int nr, int c, int ln, int nt, int ksteps, int bm, int bn, int mode,
    void* stream) {
  if (ntiles <= 0 || nr <= 0 || c <= 0 || nctas <= 0) return cudaSuccess;
  if (!mask) return cudaErrorInvalidValue;
  const pmma::Args p{
      static_cast<const uint32_t*>(a_planes),
      static_cast<const float*>(x_re), static_cast<const float*>(x_im),
      static_cast<float*>(y_re), static_cast<float*>(y_im),
      static_cast<const unsigned char*>(mask),
      static_cast<const int*>(uslot), static_cast<const int*>(ukidx),
      static_cast<const int*>(ucount), static_cast<const int4*>(items),
      static_cast<const int*>(cta_start), c, c,
      static_cast<long long>(ntiles) * ku * lm * rlm, ntiles, rlm, ku, lm, c,
      ln, nr, nt, ksteps};
  return static_cast<int>(pmma::dispatch<RowTileBf16>(
      p, mode, bm, bn, nctas, static_cast<cudaStream_t>(stream), nullptr));
}

// The CTAs of this kernel the card holds at once for the shape (bm, bn),
// block size lm, c columns and mode, or minus the cudaError_t.
extern "C" int tfq_rowtile_spmm_bf16_slots(int bm, int bn, int lm, int c,
                                           int mode) {
  pmma::Args p{};
  p.ldx = p.ldy = p.c = c;
  p.rlm = p.lm = lm;
  p.ku = p.nt = p.ksteps = 1;
  p.a = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(16));
  int slots = 0;
  const cudaError_t err =
      pmma::dispatch<RowTileBf16>(p, mode, bm, bn, 0, nullptr, &slots);
  return err == cudaSuccess ? slots : -static_cast<int>(err);
}
