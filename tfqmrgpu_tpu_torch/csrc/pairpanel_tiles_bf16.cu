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
// bf16 planes (paneltiles.bf16_planes) and X is split inside the kernel from
// the float32 rows it loads.
//
// What bounds it on the H100, at the golden-class plan grouped by G = 8:
// the mode's bf16 products, 1 to 6 passes of 12.96 GFlop at 989 TFlop/s,
// against the A planes (27.6 MB a plane) and X and Y (36.8 MB each).
//
// Design: the staged tensor-core product of panel_mma.cuh, which K3's split
// modes (rowtile_spmm_bf16.cu) run too, over the same union tables and work
// list as pairpanel_tiles.cu; X and Y are the two lane halves of one fused
// panel (row stride 2c), rows past n_rows are cut, there is no mask.

#include "panel_mma.cuh"

namespace {

template <class Tl, int MODE>
__global__ void __launch_bounds__(Tl::THREADS, 2)
pairpanel_tiles_bf16_kernel(const pmma::Args p) {
  pmma::run<Tl, MODE>(p);
}

struct PairTilesBf16 {
  template <class Tl, int MODE>
  static auto get() { return pairpanel_tiles_bf16_kernel<Tl, MODE>; }
};

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  a_planes holds the bf16 planes [planes, ntiles,
// ku*lm/2, 2*rlm] (pairs of depth rows in one 32-bit word); c is the lane
// count of one plane (G*LN); x and y hold 2*c lanes per row and n_rows
// rows; the unit tables and the work list are those of ops/paneltiles.py
// for CTAs of bm rows by bn lanes; mode is 1, 3, 4 or 6 (the products of
// 'bf16', 'bf16x3', 'bf16x4', 'bf16x6').
extern "C" int tfq_pairpanel_tiles_bf16(
    const void* a_planes, const void* x, void* y, const void* uslot,
    const void* ukidx, const void* ucount, const void* items,
    const void* cta_start, int nctas, int ntiles, int rlm, int ku, int lm,
    int c, int n_rows, int nt, int ksteps, int bm, int bn, int mode,
    void* stream) {
  if (ntiles <= 0 || n_rows <= 0 || c <= 0 || nctas <= 0) return cudaSuccess;
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  const pmma::Args p{
      static_cast<const uint32_t*>(a_planes), xf, xf + c, yf, yf + c,
      nullptr, static_cast<const int*>(uslot), static_cast<const int*>(ukidx),
      static_cast<const int*>(ucount), static_cast<const int4*>(items),
      static_cast<const int*>(cta_start), 2LL * c, 2LL * c,
      static_cast<long long>(ntiles) * ku * lm * rlm, ntiles, rlm, ku, lm, c,
      1, n_rows, nt, ksteps};
  return static_cast<int>(pmma::dispatch<PairTilesBf16>(
      p, mode, bm, bn, nctas, static_cast<cudaStream_t>(stream), nullptr));
}

// The CTAs of this kernel the card holds at once for the shape (bm, bn),
// block size lm, c lanes a plane and mode, or minus the cudaError_t.
extern "C" int tfq_pairpanel_tiles_bf16_slots(int bm, int bn, int lm, int c,
                                              int mode) {
  pmma::Args p{};
  p.ldx = p.ldy = 2LL * c;
  p.c = c;
  p.rlm = p.lm = lm;
  p.ku = p.nt = p.ksteps = 1;
  p.a = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(16));
  int slots = 0;
  const cudaError_t err =
      pmma::dispatch<PairTilesBf16>(p, mode, bm, bn, 0, nullptr, &slots);
  return err == cudaSuccess ? slots : -static_cast<int>(err);
}
