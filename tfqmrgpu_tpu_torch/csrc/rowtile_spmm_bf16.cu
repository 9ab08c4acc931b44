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
// rows in VMEM; here A is split once per upload into the product's staged
// bf16 slabs (paneltiles.bf16_planes) and X once a multiply by the split
// pass (split_x_bf16.cu).
//
// What bounds it on the H100, at the golden-class 'c' shape (LM 32, r_tile
// 2, ku 12, c 512): the mode's bf16 products, 3 to 6 passes of 12.96 GFlop
// at 989 TFlop/s, against the A planes (13.9 MB a plane) and X and Y.
//
// Design: the warpgroup product of panel_mma.cuh, which K2's split modes
// (pairpanel_tiles_bf16.cu) run too; Y is separate re and im planes with
// row stride c, and X's block mask is applied in the epilogue.

#include "panel_mma.cuh"

namespace {

template <int LANES, int MODE, int KB>
__global__ void __launch_bounds__(pmma::THREADS, 1)
rowtile_spmm_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                         const __grid_constant__ CUtensorMap tma_x,
                         const pmma::Args p) {
  pmma::run<LANES, MODE, KB>(&tma_a, &tma_x, p);
}

struct RowTileBf16 {
  template <int LANES, int MODE, int KB>
  static auto get() { return rowtile_spmm_bf16_kernel<LANES, MODE, KB>; }
};

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  maps holds the tensor maps of the A slabs and the X
// planes (tfq_panel_mma_maps); mask is the [nr/lm, c/ln] byte table of X's
// pattern; the unit tables, the groups' first slabs (abase) and the work
// list are those of ops/paneltiles.py for CTAs of bm rows by bn lanes;
// stages hold kc rows (paneltiles.mma_stage_rows); mode is 3, 4 or 6 (or
// 1).
extern "C" int tfq_rowtile_spmm_bf16(
    const void* maps, const void* mask, void* y_re, void* y_im,
    const void* uslot, const void* ucount, const void* abase,
    const void* items, const void* cta_start, int nctas, int ntiles, int rlm,
    int lm, int nr, int c, int ln, int nt, int ksteps, int bm, int bn,
    int kc, int mode, void* stream, void* count) {
  if (ntiles <= 0 || nr <= 0 || c <= 0 || nctas <= 0) return cudaSuccess;
  if (!mask || !maps) return cudaErrorInvalidValue;
  const pmma::Args p{
      static_cast<float*>(y_re), static_cast<float*>(y_im),
      static_cast<const unsigned char*>(mask),
      static_cast<const int*>(uslot), static_cast<const int*>(ucount),
      static_cast<const int*>(abase), static_cast<const int4*>(items),
      static_cast<const int*>(cta_start), c, ntiles, rlm, lm,
      lm < 16 ? 16 : lm, c, ln, nr, nt, ksteps,
      static_cast<unsigned long long*>(count)};
  return static_cast<int>(pmma::dispatch<RowTileBf16>(
      maps, p, mode, bm, bn, kc, nctas, static_cast<cudaStream_t>(stream),
      nullptr));
}

// The CTAs of this kernel the card holds at once for the shape (bm, bn),
// block size lm, c columns and mode, or minus the cudaError_t.
extern "C" int tfq_rowtile_spmm_bf16_slots(int bm, int bn, int lm, int c,
                                           int mode) {
  pmma::Args p{};
  p.ldy = p.c = c;
  p.rlm = p.lm = lm;
  p.klm = lm < 16 ? 16 : lm;
  p.nt = p.ksteps = 1;
  int slots = 0;
  const cudaError_t err = pmma::dispatch<RowTileBf16>(
      nullptr, p, mode, bm, bn, pmma::stage_rows(lm), 0, nullptr,
      &slots);
  return err == cudaSuccess ? slots : -static_cast<int>(err);
}
