// Row-tile union-ELL block-sparse product on Hopper (sm_90a), FP32 (K3):
//
//   for every tile t and union block k (ascending):
//     xs = X[xcols[t, k]*LM : +LM, :]            (re and im, [LM, c])
//     d_r += A[t][:, k*LM : +LM] @ xs_re,  d_i += A[t][:, k*LM : +LM] @ xs_im
//   y_re = d_r[:rlm] - d_i[rlm:],  y_im = d_i[:rlm] + d_r[rlm:]
//
// with A[t] the fused panel of tile t (re rows, then im rows; rlm =
// r_tile*LM rows each, ku*LM deep), X and Y the separate re and im planes
// [nr, c] (c = ncc*LN columns of right-hand sides), and Y masked to X's
// block pattern.  It replaces the TPU kernel K3,
// tfqmrgpu_tpu/ops/pallas_spmm.py::_make_call.kernel, in its exact-FP32
// ('highest') mode.  The TPU kernel kept the whole X panel in VMEM and
// gathered a tile's union rows into scratch; on the H100 the panel lives
// in device memory and L2, and a CTA gathers the rows it needs into shared
// memory, one depth chunk at a time.
//
// What bounds it on the H100: the FP32 pipe.  At the golden-class 'c' shape
// (LM = 32, r_tile = 2, ku = 12, c = 512, 141 tiles) the useful work is
// 12.96 GFlop over about 99 MB, some 130 flop per byte: 0.19 ms at 67
// TFlop/s against 0.03 ms of device memory.
//
// Design: the staged complex product of panel_stage.cuh, which K2
// (pairpanel_tiles.cu) runs too: depth-major A panels made once per upload
// so that a stage's A slice is KC contiguous rows, 16-byte cp.async copies
// into a ring of stages with one barrier a stage, persistent CTAs over the
// host's work list, 4 x 4 complex micro-tiles.  What is K3's own is here:
// X and Y as two separate planes with row stride c, xcols as the tiles'
// block lists, and X's block mask applied in the epilogue.  No atomics;
// every output is written once; repeated launches give the same bits.

#include "panel_stage.cuh"

namespace {

template <class Tl, bool VX4>
__global__ void __launch_bounds__(Tl::THREADS, 2)
rowtile_spmm_kernel(const panel::Args p) {
  panel::run<Tl, VX4>(p);
}

struct RowTile {
  template <class Tl, bool VX4>
  static auto get() { return rowtile_spmm_kernel<Tl, VX4>; }
};

}  // namespace

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 on success).  a_dm holds the depth-major panels [ntiles, ku*lm, 2*rlm];
// mask is the [nr/lm, c/ln] byte table of X's pattern; uslot, ukidx and
// ucount are the unit tables and items, cta_start the work list of
// ops/paneltiles.py for CTAs of bm rows by bn columns.
extern "C" int tfq_rowtile_spmm_f32(
    const void* a_dm, const void* x_re, const void* x_im, const void* mask,
    void* y_re, void* y_im, const void* uslot, const void* ukidx,
    const void* ucount, const void* items, const void* cta_start, int nctas,
    int ntiles, int rlm, int ku, int lm, int nr, int c, int ln, int nt,
    int ksteps, int bm, int bn, void* stream, void* count) {
  if (ntiles <= 0 || nr <= 0 || c <= 0 || nctas <= 0) return cudaSuccess;
  if (!mask) return cudaErrorInvalidValue;
  const panel::Args p{
      static_cast<const float*>(a_dm), static_cast<const float*>(x_re),
      static_cast<const float*>(x_im), static_cast<float*>(y_re),
      static_cast<float*>(y_im), static_cast<const unsigned char*>(mask),
      static_cast<const int*>(uslot), static_cast<const int*>(ukidx),
      static_cast<const int*>(ucount), static_cast<const int4*>(items),
      static_cast<const int*>(cta_start), c, c, ntiles, rlm, ku, lm, c, ln,
      nr, nt, ksteps, static_cast<unsigned long long*>(count)};
  return static_cast<int>(panel::dispatch<RowTile>(
      p, bm, bn, nctas, static_cast<cudaStream_t>(stream), nullptr));
}

// The CTAs of this kernel the card holds at once (CTAs an SM times SMs) for
// the shape (bm, bn), block size lm and c columns, or minus the cudaError_t.
extern "C" int tfq_rowtile_spmm_slots(int bm, int bn, int lm, int c) {
  panel::Args p{};
  p.ldx = p.ldy = p.c = c;
  p.rlm = p.lm = lm;
  p.ku = p.nt = p.ksteps = 1;
  int slots = 0;
  const cudaError_t err =
      panel::dispatch<RowTile>(p, bm, bn, 0, nullptr, &slots);
  return err == cudaSuccess ? slots : -static_cast<int>(err);
}
