// Packed pair-plan product on the BF16 tensor cores of Hopper (sm_90a): K2
// in the JAX package's bf16 split modes ('bf16', 'bf16x3', 'bf16x4',
// 'bf16x6').  It computes what pairpanel_tiles.cu computes,
//
//   Y[t*rlm + i, :] = [P1 - Q2 | P2 + Q1],  P | Q = A[t] @ X[union rows of t]
//
// with every product taken as the mode's sum of bf16 plane products, as the
// TPU kernel tfqmrgpu_tpu/ops/pairpanel.py::_make_call.kernel_tile_pipe does
// in these modes (its dots, :1663-1693).  The TPU kernel took X's splits
// from an X window pre-split in device memory and split A in the kernel
// ('bf16x6') or shipped it pre-split; here A is split once per upload into
// the product's staged bf16 slabs (paneltiles.bf16_planes) and X once a
// multiply by the split pass (split_x_bf16.cu), as the TPU's X windows
// were.
//
// What bounds it on the H100, at the golden-class plan grouped by G = 8:
// the mode's bf16 products, 1 to 6 passes of 12.96 GFlop at 989 TFlop/s,
// against the A planes (27.6 MB a plane) and X and Y (36.8 MB each).
//
// Design: the warpgroup product of panel_mma.cuh, which K3's split modes
// (rowtile_spmm_bf16.cu) run too, over union tables and a work list of the
// same kind as pairpanel_tiles.cu's; Y is the two lane halves of one fused
// panel (row stride 2c), rows past n_rows are cut, there is no mask.

#include "panel_mma.cuh"

namespace {

template <int LANES, int MODE, int KB>
__global__ void __launch_bounds__(pmma::THREADS, 1)
pairpanel_tiles_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                            const __grid_constant__ CUtensorMap tma_x,
                            const pmma::Args p) {
  pmma::run<LANES, MODE, KB>(&tma_a, &tma_x, p);
}

struct PairTilesBf16 {
  template <int LANES, int MODE, int KB>
  static auto get() { return pairpanel_tiles_bf16_kernel<LANES, MODE, KB>; }
};

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  maps holds the tensor maps of the A slabs and the X
// planes (tfq_panel_mma_maps); c is the lane count of one plane (G*LN); y
// holds 2*c lanes per row and n_rows rows; the unit tables, the groups'
// first slabs (abase) and the work list are those of ops/paneltiles.py for
// CTAs of bm rows by bn lanes; stages hold kc rows
// (paneltiles.mma_stage_rows); mode is 1, 3, 4 or 6 (the products of
// 'bf16', 'bf16x3', 'bf16x4', 'bf16x6').
extern "C" int tfq_pairpanel_tiles_bf16(
    const void* maps, void* y, const void* uslot, const void* ucount,
    const void* abase, const void* items, const void* cta_start, int nctas,
    int ntiles, int rlm, int lm, int c, int n_rows, int nt, int ksteps,
    int bm, int bn, int kc, int mode, void* stream, void* count) {
  if (ntiles <= 0 || n_rows <= 0 || c <= 0 || nctas <= 0) return cudaSuccess;
  if (!maps) return cudaErrorInvalidValue;
  auto* yf = static_cast<float*>(y);
  const pmma::Args p{
      yf, yf + c, nullptr, static_cast<const int*>(uslot),
      static_cast<const int*>(ucount), static_cast<const int*>(abase),
      static_cast<const int4*>(items), static_cast<const int*>(cta_start),
      2LL * c, ntiles, rlm, lm, lm < 16 ? 16 : lm, c, 1, n_rows, nt, ksteps,
      static_cast<unsigned long long*>(count)};
  return static_cast<int>(pmma::dispatch<PairTilesBf16>(
      maps, p, mode, bm, bn, kc, nctas, static_cast<cudaStream_t>(stream),
      nullptr));
}

// The CTAs of this kernel the card holds at once for the shape (bm, bn),
// block size lm, c lanes a plane and mode, or minus the cudaError_t.
extern "C" int tfq_pairpanel_tiles_bf16_slots(int bm, int bn, int lm, int c,
                                              int mode) {
  pmma::Args p{};
  p.ldy = 2LL * c;
  p.c = c;
  p.rlm = p.lm = lm;
  p.klm = lm < 16 ? 16 : lm;
  p.nt = p.ksteps = 1;
  int slots = 0;
  const cudaError_t err = pmma::dispatch<PairTilesBf16>(
      nullptr, p, mode, bm, bn, pmma::stage_rows(lm), 0, nullptr,
      &slots);
  return err == cudaSuccess ? slots : -static_cast<int>(err);
}
