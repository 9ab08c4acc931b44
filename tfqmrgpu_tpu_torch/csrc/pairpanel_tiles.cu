// Packed pair-plan product on Hopper (sm_90a), FP32 (K2):
//
//   for every tile t and union slot k < ku (ascending):
//     xs = X[xloc[t, k]*LM : +LM, :]              (re lanes and im lanes)
//     acc += A[t][:, k*LM : +LM] @ xs              ([2*rlm, 2*c])
//   Y[t*rlm + i, :] = [P1 - Q2 | P2 + Q1],  P = acc[:rlm], Q = acc[rlm:]
//
// with A[t] the fused panel of tile t (re rows over im rows, rlm =
// r_tile*LM rows each, ku*LM deep), X and Y the fused permuted panels
// [n_slots*LM, 2*c] (re in lanes [0, c), im in lanes [c, 2c)), index 1 the
// re lanes and 2 the im lanes, and rows at or past n_rows = n_slots*LM cut.
// It replaces the TPU kernel
// tfqmrgpu_tpu/ops/pairpanel.py::_make_call.kernel_tile_pipe in its
// exact-FP32 ('highest') mode.  The TPU kernel held the whole X panel in
// VMEM, ran copy-code programs on the scalar core to gather tile j+1's
// union blocks into one of two per-tile buffers while the MXU multiplied
// tile j, and carried its state along a sequential grid.
//
// What bounds it on the H100: the FP32 pipe.  At the golden-class plan
// grouped by G = 8 (LM = 32, r_tile = 1, ku = 12, c = 256, 562 tiles) the
// work is 12.96 GFlop needed over 55 MB of A panels and 36.8 MB each of X
// and Y: 0.19 ms at 67 TFlop/s against 0.04 ms of device memory.
//
// Design: the staged complex product of panel_stage.cuh, which K3
// (rowtile_spmm.cu) runs too: depth-major A panels, 16-byte cp.async copies
// into a ring of stages with one barrier a stage, persistent CTAs over the
// host's work list, 4 x 4 complex micro-tiles.  What is K2's own is here
// and in the tables ops/paneltiles.py builds for it: tiles narrower than a
// CTA (rlm = 32 at the golden class) sit side by side in a unit, whose X
// rows are the ascending union of the tiles' xloc slots, each staged once;
// X and Y are the two lane halves of one fused panel (row stride 2c); rows
// past n_rows are cut; there is no mask (the grouped lane mask is applied
// by the caller).  No atomics; every output is written once; repeated
// launches give the same bits.

#include "panel_stage.cuh"

namespace {

template <class Tl, bool VX4>
__global__ void __launch_bounds__(Tl::THREADS, 2)
pairpanel_tiles_kernel(const panel::Args p) {
  panel::run<Tl, VX4>(p);
}

struct PairTiles {
  template <class Tl, bool VX4>
  static auto get() { return pairpanel_tiles_kernel<Tl, VX4>; }
};

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  a_dm holds the depth-major panels [ntiles, ku*lm, 2*rlm];
// c is the lane count of one plane (G*LN); x and y hold 2*c lanes per row
// and n_rows = n_slots*lm rows; uslot, ukidx and ucount are the unit tables
// and items, cta_start the work list of ops/paneltiles.py for CTAs of bm
// rows by bn lanes.
extern "C" int tfq_pairpanel_tiles_f32(
    const void* a_dm, const void* x, void* y, const void* uslot,
    const void* ukidx, const void* ucount, const void* items,
    const void* cta_start, int nctas, int ntiles, int rlm, int ku, int lm,
    int c, int n_rows, int nt, int ksteps, int bm, int bn, void* stream) {
  if (ntiles <= 0 || n_rows <= 0 || c <= 0 || nctas <= 0) return cudaSuccess;
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  const panel::Args p{
      static_cast<const float*>(a_dm), xf, xf + c, yf, yf + c, nullptr,
      static_cast<const int*>(uslot), static_cast<const int*>(ukidx),
      static_cast<const int*>(ucount), static_cast<const int4*>(items),
      static_cast<const int*>(cta_start), 2LL * c, 2LL * c, ntiles, rlm, ku,
      lm, c, 1, n_rows, nt, ksteps};
  return static_cast<int>(panel::dispatch<PairTiles>(
      p, bm, bn, nctas, static_cast<cudaStream_t>(stream), nullptr));
}

// The CTAs of this kernel the card holds at once (CTAs an SM times SMs) for
// the shape (bm, bn), block size lm and c lanes a plane, or minus the
// cudaError_t.
extern "C" int tfq_pairpanel_tiles_slots(int bm, int bn, int lm, int c) {
  panel::Args p{};
  p.ldx = p.ldy = 2LL * c;
  p.c = c;
  p.rlm = p.lm = lm;
  p.ku = p.nt = p.ksteps = 1;
  int slots = 0;
  const cudaError_t err =
      panel::dispatch<PairTiles>(p, bm, bn, 0, nullptr, &slots);
  return err == cudaSuccess ? slots : -static_cast<int>(err);
}
