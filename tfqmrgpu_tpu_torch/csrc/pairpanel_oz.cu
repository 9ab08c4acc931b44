// K1's Ozaki modes on the tensor cores of Hopper (sm_90a): the oz kernel of
// the packed 'z' route (ops/pairpanel.py, OzPairPanelMultiply).  It computes
// what the Ozaki branches of the TPU kernel
// tfqmrgpu_tpu/ops/pairpanel.py::_make_call.kernel compute (its dots(),
// :1527-1647, and finish(), :1487-1506), for every tile t of a packed plan:
//
//   D_st = A_s[t] @ X_t[union rows of t]     s + t <= p - 1
//
// A_s[t] is slice s of the tile's fused panel [2M, K] (P rows over Q rows,
// M = r_tile*LM, K = ku*LM); X_t is slice t of the fused X panel [rows,
// p*2LN] (re lanes, then im lanes, a slice after another), gathered by the
// tile's union slots (xloc).  Every D_st is an exact sum: the slicer bounds
// each product (and in 'oz' and 'xi8' each diagonal's sum) within 2^24
// (float32) or 2^31 (int32) units of its grid, so the order of the sums
// inside a dot, and the split of the depth between stages, do not matter:
// the tensor cores give the bits of any exact evaluation.  The bodies keep
// the JAX reduction's order exactly:
//
//   body  operands, MMA                        reduction, output
//   ozc   A and X bf16 (int8 A slices are      one accumulator a product;
//         re-scaled into bf16 values once,     the products folded in
//         by the wrapper); wgmma m64nNk16      diagonal order, TwoSum for
//         BF16 into FP32                       d <= 4, a plain tail beyond;
//                                              then finish(): [M, 4LN] =
//                                              re_acc|im_acc|re_err|im_err
//   xi8   A and X int8; wgmma m64nNk32 S8      int32 diagonal sums, split
//         into S32                             at 2^12 (hi, then lo) and
//                                              TwoSum-folded, d ascending;
//                                              then finish()
//   oz    A and X bf16 (as ozc); wgmma         float32 diagonal sums, raw:
//         m64nNk16 BF16 into FP32              [2M, p*2LN]
//
// The float32 arithmetic of the folds uses __fadd_rn / __fsub_rn /
// __fmul_rn, which the compiler neither contracts nor reorders.
//
// What bounds it on the H100: at the golden class (12.96 GFlop by the
// reference's count) the slice products, p(p+1)/2 of them, at the data
// sheet's 1979 TOPS INT8 ('xi8') or 989 TFlop/s BF16.  The design:
//
// - A CTA owns one block of 32 rows of P and the same 32 rows of Q (all
//   2M rows of the tile where M <= 32; rows past M are zero) by LB lanes
//   of re and the same LB lanes of im: 64 rows, one wgmma M.  Its two
//   warpgroups own the re and the im lanes and share the staged A; a warp
//   of a warpgroup owns 16 rows.  LB is what the accumulators leave room
//   for: 8 in 'ozc' (a set of LB/2 registers a product), 32 in 'xi8' and
//   'oz' (a set a diagonal), 16 in 'oz' above p 9.  Two warpgroups and no
//   more, so that a thread may hold 255 registers.
// - The warps take A from registers: the fragment of slice s is loaded
//   once a stage (ldmatrix) and serves its p - s products.  In 'ozc' they
//   have sets of their own, numbered slice by slice, and the 8-lane X
//   slices of a half are 8-row groups a fixed stride apart in shared
//   memory, so one wgmma of width (p-s)*8 takes them all (p wgmmas a
//   stage, not p(p+1)/2 of 8 lanes).
//   In 'oz' and 'xi8' each product goes onto its diagonal's set, one
//   wgmma a product: wgmmas in flight on one set run in order only where
//   they name the very same registers.  Slices go in pairs (s, p-1-s), a
//   commit group a pair, the fragments in two register sets in turn, so
//   that the tensor cores run one group while the next one's load.
// - Each CTA loads the A stages of its row block and the X stages of its
//   lanes.  A last lane block that reaches past LN gets zeros for those
//   lanes from TMA and stores nothing there.
// - A stage is 64 bytes of depth (32 bf16 entries, two wgmma depths) in
//   'ozc' and in 'oz' to p 9 where LM is a multiple of 32, else 32 bytes
//   (16 bf16 or 32 int8 entries, one wgmma depth), of all p slices, and
//   two TMA copies: X as one 4-D box ({depth, LB lanes,
//   re|im, p slices} of the lane-major X slices [p, 2, LN, rows], swizzled
//   by the depth's bytes), A as one 2-D box: A is built once a solve, and
//   lies in device memory as its stages are staged (the wrapper's
//   ``kernel_planes``: [tile, row block, stage, slice, P|Q, 32 rows,
//   depth], rows past M zero, the swizzle applied), so that a stage of it
//   is one box of rows of 256 entries.  At these sizes a copy costs the
//   copy engine more by its count than by its bytes, so a stage takes as
//   few copies, and is as deep, as the union's slots allow: a stage lies
//   in one slot of the tile's union, and the stages of a tile are exactly
//   its union's depth (kcount): depth past it is never loaded.
// - A ring of 5-6 stages with full and empty mbarriers.  Thread 0 keeps it
//   NST - 1 stages ahead of the products (every thread walks the schedule,
//   thread 0 alone issues); each warp releases a stage with one arrival on
//   its empty barrier, so a stage is refilled only when every warp is done
//   with it.  Nothing between
//   the first wgmma and the last wait branches on the thread: ptxas would
//   wait for every wgmma in flight before such a branch.
// - The CTAs are persistent: a CTA walks work items (tile, row block,
//   lane block) with a stride of the grid, and the ring holds
//   the next item's first stages while the warps fold the last one.
//
// The fold of 'ozc' and 'xi8' runs in each thread's registers; finish()
// reads the two warpgroups' (acc, err) planes from shared memory.  'oz'
// writes its diagonal sums from registers in 16-byte rows (lane pairs
// exchange halves by a shuffle).  No atomics: every output is written once
// and repeated launches give the same bits.

#include <cuda.h>   // CUtensorMap and its enums (types only: libcuda is
                    // reached through cudaGetDriverEntryPoint, not linked)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BODY_OZ = 0, BODY_OZC = 1, BODY_XI8 = 2;
constexpr int THREADS = 256;              // two warpgroups: re and im lanes
constexpr int HROWS = 32;                 // rows of P (and of Q) in a CTA
constexpr int TWOSUM_D = 4;               // ozc: TwoSum for diagonals d <= 4
constexpr int SMEM_LIMIT = 232448;        // a block's shared memory on H100

// KB: the bytes of a stage's depth, 32 (one wgmma depth, 32-byte swizzle)
// or 64 (two, 64-byte swizzle); ozc and oz to p 9 take 64 where a slot of
// the union holds it (LM a multiple of 32), the others 32
template <int BODY, int P, int KB>
struct Cfg {
  static_assert(KB == 32 || (KB == 64 && BODY != BODY_XI8), "stage depth");
  static constexpr bool INT = BODY == BODY_XI8;
  static constexpr int NACC = BODY == BODY_OZC ? P * (P + 1) / 2 : P;
  static constexpr int LB = BODY == BODY_OZC ? 8 : (BODY == BODY_OZ && P > 9)
                                                      ? 16 : 32;
  static constexpr int NR = LB / 2;                 // registers of a set
  static constexpr int KC = INT ? KB : KB / 2;      // depth of a stage
  static constexpr int KS = KB / 32;                // wgmma depths of it
  static constexpr int SLICE = 2 * HROWS * KB;      // A bytes of a slice
  static constexpr int A_ROW = INT ? 256 : 512;     // bytes of an A box row
  static constexpr int A_BYTES = P * SLICE;
  static constexpr int X_BYTES = P * 2 * LB * KB;
  static constexpr int STAGE = (A_BYTES + X_BYTES + 1023) / 1024 * 1024;
  // ozc, xi8: the (acc, err) planes [P|Q][re|im][acc|err][HROWS][LB]
  static constexpr int SR_BYTES = BODY == BODY_OZ ? 0 : 8 * HROWS * LB * 4;
  static constexpr int FREE = SMEM_LIMIT - 1024 - SR_BYTES - 256;
  static constexpr int NST = FREE / STAGE < 6 ? FREE / STAGE : 6;
  static constexpr int SMEM = NST * STAGE + SR_BYTES + 256 + 1024;
  static_assert(NST >= 3, "a ring of three stages or more");
};

struct OzArgs {
  float* y;             // oz: [ntiles, 2m, p*2c]; ozc, xi8: [ntiles, m, 4c]
  const int* xloc;      // [ntiles, ku]: the union's X slots
  const int* kcount;    // [ntiles]: the union's size
  int m, ku, lm, c, q;
  int nrb, nlb, nitems;   // row blocks, lane blocks, work items
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// The instructions that only some threads execute take a predicate inside
// the asm: a branch on the thread index while products are in flight
// makes ptxas serialize every wgmma of the kernel.

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes,
                                               bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::
          "r"(bar), "r"(bytes), "r"(static_cast<int>(on)) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed.
// The poll loop lies inside the asm, so that ptxas sees no branch of the
// program's own between wgmma issue and wait.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(on)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(static_cast<int>(on)) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %7, 0;\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(static_cast<int>(on)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of v across a wgmma wait
template <class T>
__device__ __forceinline__ void pin(T& v) {
  if constexpr (std::is_same<T, float>::value)
    asm volatile("" : "+f"(v)::"memory");
  else
    asm volatile("" : "+r"(v)::"memory");
}

// The descriptor of a K-major wgmma operand in shared memory with KB-byte
// swizzle (KB 32 or 64): rows of KB bytes, 8-row groups `group` bytes apart
// (8*KB where they follow one another; the leading offset is unused at
// these swizzles).  The second wgmma depth of a 64-byte row starts 32
// bytes on.
template <int KB>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t group) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(group >> 4) << 32) |
         (static_cast<uint64_t>(KB == 32 ? 3 : 2) << 62);
}

// 2^e as a float32, for e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((127 + e) << 23);
}

// One Knuth TwoSum step, the JAX body's order:
//   tot = acc + b; av = tot - b; bv = tot - av;
//   err = err + ((acc - av) + (b - bv)); acc = tot
__device__ __forceinline__ void two_sum(float& acc, float& err, float b) {
  const float tot = __fadd_rn(acc, b);
  const float av = __fsub_rn(tot, b);
  const float bv = __fsub_rn(tot, av);
  err = __fadd_rn(err, __fadd_rn(__fsub_rn(acc, av), __fsub_rn(b, bv)));
  acc = tot;
}

// The accumulator set of product (s, t): in 'ozc' one a product, numbered
// slice by slice (the sets of s's products t = 0..p-1-s side by side), in
// 'oz' and 'xi8' one a diagonal d = s + t.
template <int BODY, int P>
__host__ __device__ constexpr int acc_of(int s, int t) {
  return BODY == BODY_OZC ? s * P - s * (s - 1) / 2 + t : s + t;
}

// f(integral_constant<int, I>) for I = 0..N-1, each I a constant
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D[64 x N] += A[64 x depth] (registers: the m16 fragment of each warp's 16
// rows) . B[depth x N] (shared memory, K-major, swizzled), for the widths
// the kernel issues (bf16: 8 lanes times 1-9 products, 16, 32; int8: 32);
// register 4j + f of a thread's D holds row 16w + g + 8(f/2), column 8j +
// 2(lane%4) + f%2 (w the warp, g = lane/4).  bf16 products of depth 16 sum into
// float32, int8 ones of depth 32 into int32 (no saturation).
template <bool INT, int N>
struct Wgmma;

template <>
struct Wgmma<false, 8> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 16> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 24> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 32> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 40> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %25, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 48> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 56> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %33, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 64> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 72> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %41, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
        "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<true, 32> {
  __device__ __forceinline__ static void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int BODY, int P, int KB>
__global__ void __launch_bounds__(THREADS, 1)
pairpanel_oz_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_x,
                    const OzArgs p) {
  using C = Cfg<BODY, P, KB>;
  constexpr int LB = C::LB, NR = C::NR, NST = C::NST;
  constexpr int NPAIR = (P + 1) / 2;  // slice pairs (s, P-1-s)
  constexpr int NG = NPAIR * C::KS;   // commit groups a stage
  using Acc = typename std::conditional<C::INT, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  // the ring's stages on 1024-byte boundaries (the swizzle's period)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* s_r = reinterpret_cast<float*>(smem + NST * C::STAGE);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(smem + NST * C::STAGE + C::SR_BYTES);
  const uint32_t empty = full + 8 * NST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_tile = p.nrb * p.nlb;
  const int stages_of_slot = p.lm / C::KC;
  const int stages_of_tile = p.ku * stages_of_slot;
  constexpr int A_BOX_ROWS = C::A_BYTES / C::A_ROW;

  if (tid == 0) {
    for (int b = 0; b < NST; ++b) {
      mbar_init(full + 8 * b, 1);
      // every warp releases every stage
      mbar_init(empty + 8 * b, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the producer: every thread walks the CTA's items and their
  // stages, the sequence the warps consume, and keeps NST - 1 stages ahead;
  // thread 0 issues the copies
  int p_item = blockIdx.x, p_st = 0, p_b = 0, issued = 0;
  uint32_t p_ph = 0;
  auto stages_of = [&](int item) {
    return __ldg(p.kcount + item / per_tile) * stages_of_slot;
  };
  int p_nst = p_item < p.nitems ? stages_of(p_item) : 0;
  // issue the stages before global stage `limit`: the buffer of stage
  // `limit` - 1 - NST is released once every warp has waited for the
  // products of stage `limit` - NST
  auto produce = [&](int limit) {
    while (issued < limit && p_item < p.nitems) {
      if (p_st == p_nst) {
        p_item += gridDim.x;
        p_st = 0;
        if (p_item < p.nitems) p_nst = stages_of(p_item);
        continue;
      }
      const int t = p_item / per_tile, rem = p_item % per_tile;
      const int rb = rem / p.nlb, lb = rem % p.nlb;
      mbar_wait(empty + 8 * p_b, p_ph ^ 1);
      const uint32_t bar = full + 8 * p_b;
      mbar_expect_tx(bar, C::A_BYTES + C::X_BYTES, tid == 0);
      const uint32_t stage = ring + p_b * C::STAGE;
      const int slot = __ldg(p.xloc + static_cast<size_t>(t) * p.ku +
                             p_st / stages_of_slot);
      const int row0 = slot * p.lm + (p_st % stages_of_slot) * C::KC;
      // X: this CTA's lanes, one box; A: the stage's slices, one box (a
      // copy's cost goes by the copies more than by their bytes)
      tma_load_4d(stage + C::A_BYTES, &tma_x, bar, row0, lb * LB, 0, 0,
                  tid == 0);
      const int a_row =
          ((t * p.nrb + rb) * stages_of_tile + p_st) * A_BOX_ROWS;
      tma_load_2d(stage, &tma_a, bar, 0, a_row, tid == 0);
      ++p_st;
      ++issued;
      if (++p_b == NST) {
        p_b = 0;
        p_ph ^= 1;
      }
    }
  };

  // ---- the products: warpgroup hl takes the re (0) or im (1) lanes; warp
  // w of it rows 16(w&1).. of P (w < 2) or Q (w >= 2)
  const int hl = warp >> 2, w = warp & 3, h = w >> 1;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's ldmatrix row: matrices (rows 0-7 | 8-15) x (depth bytes
  // 0-15 | 16-31 of wgmma depth kk) of the warp's 16 rows; the KB-byte
  // swizzle moves 16-byte chunk c of row r to c ^ (r*KB/128 mod KB/16)
  const int mi = lane >> 3;
  const int lrow = (w & 1) * 16 + (mi & 1) * 8 + (lane & 7);
  const int lxor = (lrow * KB / 128) & (KB / 16 - 1);
  auto a_off = [&](int kk) {
    return static_cast<uint32_t>((h * HROWS + lrow) * KB +
                                 (((2 * kk + (mi >> 1)) ^ lxor) << 4));
  };
  // a warp's release of buffer bb: one arrival, by its lane 0
  auto release = [&](int bb) { mbar_arrive(empty + 8 * bb, lane == 0); };
  int b = 0, consumed = 0;
  uint32_t ph = 0;
  Acc acc[C::NACC * NR];
  uint32_t ar[2][8];

  for (int item = blockIdx.x; item < p.nitems; item += gridDim.x) {
    const int t = item / per_tile, rem = item % per_tile;
    const int i0 = (rem / p.nlb) * HROWS;
    const int j0 = (rem % p.nlb) * LB;
    const int nst = __ldg(p.kcount + t) * stages_of_slot;
#pragma unroll
    for (int i = 0; i < C::NACC * NR; ++i) acc[i] = 0;
    int pending = -1;   // the stage whose products may still be running

    // the products of the stage in buffer b, a commit group a pair of
    // slices (s, P-1-s): the A fragment of slice s, loaded once, serves its
    // P - s products; the groups' fragments alternate between two register
    // sets (SP: the set of the stage's first group), so that the tensor
    // cores run one group while the next one's fragments are loaded
    auto stage = [&](auto sp) {
      constexpr int SP = decltype(sp)::value;
      const uint32_t a_s = ring + b * C::STAGE;
      static_for<0, NG>([&](auto gic) {
        constexpr int gi = decltype(gic)::value;
        // wgmma depth kk of the pair (s1, s2)
        constexpr int kk = gi / NPAIR, s1 = gi % NPAIR, s2 = P - 1 - s1;
        // X slice t of half hl: rows (2t + hl)*LB.. of the stage's X; in
        // 'ozc' one operand over the half's slices, 8-row groups 2*LB rows
        // apart
        const uint64_t xd = desc_sw<KB>(
            a_s + C::A_BYTES + hl * LB * KB + 32 * kk,
            BODY == BODY_OZC ? 2 * LB * KB : 8 * KB);
        uint32_t* r = ar[(gi + SP) & 1];
        wgmma_wait<1>();   // the group before last, which read this set
        if (gi == 1 && pending >= 0) {
          release(pending);   // every group of the stage before is done
          pending = -1;
        }
        ldsm_x4(r, a_s + s1 * C::SLICE + a_off(kk));
        if constexpr (s2 != s1)
          ldsm_x4(r + 4, a_s + s2 * C::SLICE + a_off(kk));
        wgmma_fence();
        if constexpr (BODY == BODY_OZC) {
          // a slice's products, one wgmma of their width
          Wgmma<false, (P - s1) * LB>::run(acc + acc_of<BODY, P>(s1, 0) * NR,
                                           r, xd);
          if constexpr (s2 != s1)
            Wgmma<false, (P - s2) * LB>::run(
                acc + acc_of<BODY, P>(s2, 0) * NR, r + 4, xd);
        } else {
#pragma unroll
          for (int tt = 0; tt + s1 < P; ++tt)
            Wgmma<C::INT, LB>::run(acc + acc_of<BODY, P>(s1, tt) * NR, r,
                                   xd + ((tt * 2 * LB * KB) >> 4));
          if constexpr (s2 != s1) {
#pragma unroll
            for (int tt = 0; tt + s2 < P; ++tt)
              Wgmma<C::INT, LB>::run(acc + acc_of<BODY, P>(s2, tt) * NR,
                                     r + 4, xd + ((tt * 2 * LB * KB) >> 4));
          }
        }
        wgmma_commit();
      });
    };

    for (int st = 0; st < nst; ++st, ++consumed) {
      produce(consumed + NST - 1);
      mbar_wait(full + 8 * b, ph);
      // an odd group count alternates the register sets' roles stage by
      // stage
      if (NG % 2 == 0 || (st & 1) == 0)
        stage(std::integral_constant<int, 0>{});
      else if constexpr (NG % 2 == 1)
        stage(std::integral_constant<int, 1>{});
      pending = b;
      if (++b == NST) {
        b = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < C::NACC * NR; ++i) pin(acc[i]);
    if (pending >= 0) release(pending);

    // ---- the reductions; register 4nb + f of a set: row g + 8(f/2) of the
    // warp's 16, lane 8nb + 2tq + f%2 of the warpgroup's LB
    const int rbase = (w & 1) * 16 + g;
    if constexpr (BODY == BODY_OZ) {
      const size_t yld = 2 * static_cast<size_t>(P) * p.c;
      const bool odd = tq & 1;
#pragma unroll
      for (int d = 0; d < P; ++d)
#pragma unroll
        for (int nb = 0; nb < LB / 8; ++nb) {
          const float* v = acc + d * NR + 4 * nb;
          // lane pairs swap halves: an even tq gets row g, lanes 2tq..+3;
          // an odd one row g+8, lanes 2tq-2..+1
          const float o0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? v[0] : v[2],
                                           1);
          const float o1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? v[1] : v[3],
                                           1);
          const int i = i0 + rbase + (odd ? 8 : 0);
          const int j = j0 + nb * 8 + 2 * (tq & 2);
          if (i >= p.m || j >= p.c) continue;
          float* yrow = p.y + (static_cast<size_t>(t) * 2 * p.m + h * p.m +
                               i) * yld + static_cast<size_t>(d) * 2 * p.c +
                        hl * p.c;
          const float4 q4 = odd ? make_float4(o0, o1, v[2], v[3])
                                : make_float4(v[0], v[1], o0, o1);
          if ((p.c & 3) == 0) {
            *reinterpret_cast<float4*>(yrow + j) = q4;
          } else {
            yrow[j] = q4.x;
            if (j + 1 < p.c) yrow[j + 1] = q4.y;
            if (j + 2 < p.c) yrow[j + 2] = q4.z;
            if (j + 3 < p.c) yrow[j + 3] = q4.w;
          }
        }
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int nb = k / 4, f = k % 4;
        float sum, err;
        if constexpr (BODY == BODY_OZC) {
          sum = acc[acc_of<BODY, P>(0, 0) * NR + k];
          err = 0.f;
          float tail = 0.f;
#pragma unroll
          for (int d = 1; d < P; ++d)
#pragma unroll
            for (int s = 0; s <= d; ++s) {
              const float v = acc[acc_of<BODY, P>(s, d - s) * NR + k];
              if (d <= TWOSUM_D)
                two_sum(sum, err, v);
              else
                tail = __fadd_rn(tail, v);
            }
          err = __fadd_rn(err, tail);
        } else {
#pragma unroll
          for (int d = 0; d < P; ++d) {
            const int tot = acc[d * NR + k];
            const int lo = tot % 4096;          // truncated, as lax.rem
            const int hi = tot - lo;
            const float sc = pow2f(-(d + 2) * p.q);
            const float vh = __fmul_rn(__int2float_rn(hi), sc);
            const float vl = __fmul_rn(__int2float_rn(lo), sc);
            if (d == 0) {
              sum = vh;
              err = 0.f;
            } else {
              two_sum(sum, err, vh);
            }
            two_sum(sum, err, vl);
          }
        }
        const int r = rbase + 8 * (f >> 1), jj = nb * 8 + 2 * tq + (f & 1);
        float* base = s_r + ((h * 2 + hl) * 2) * HROWS * LB + r * LB + jj;
        base[0] = sum;
        base[HROWS * LB] = err;
      }
      __syncthreads();
      // ---- finish(): re = P1 - Q2, im = P2 + Q1, each one TwoSum step
      const size_t yld = 4 * static_cast<size_t>(p.c);
      for (int e = tid; e < HROWS * LB; e += THREADS) {
        const int r = e / LB, jj = e % LB;
        const int i = i0 + r, j = j0 + jj;
        if (i >= p.m || j >= p.c) continue;
        auto R = [&](int hh, int hhl, int k) {
          return s_r[((hh * 2 + hhl) * 2 + k) * HROWS * LB + r * LB + jj];
        };
        const float a1 = R(0, 0, 0), b1 = -R(1, 1, 0);
        const float t1 = __fadd_rn(a1, b1);
        const float av = __fsub_rn(t1, b1);
        const float bv = __fsub_rn(t1, av);
        const float e1 =
            __fadd_rn(__fadd_rn(__fsub_rn(a1, av), __fsub_rn(b1, bv)),
                      __fsub_rn(R(0, 0, 1), R(1, 1, 1)));
        const float a2 = R(0, 1, 0), b2 = R(1, 0, 0);
        const float t2 = __fadd_rn(a2, b2);
        const float av2 = __fsub_rn(t2, b2);
        const float bv2 = __fsub_rn(t2, av2);
        const float e2 =
            __fadd_rn(__fadd_rn(__fsub_rn(a2, av2), __fsub_rn(b2, bv2)),
                      __fadd_rn(R(0, 1, 1), R(1, 0, 1)));
        float* yrow = p.y + (static_cast<size_t>(t) * p.m + i) * yld + j;
        yrow[0] = t1;
        yrow[p.c] = t2;
        yrow[2 * p.c] = e1;
        yrow[3 * p.c] = e2;
      }
      // the planes are read before the next item's fold writes them
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query: nothing links to libcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A tiled map of `base` with zero fill: dims innermost first, the strides
// of dims 1.. in bytes
template <int RANK>
CUresult encode(CUtensorMap* map, bool int8, const void* base,
                const cuuint64_t (&dims)[RANK],
                const cuuint64_t (&strides)[RANK - 1],
                const cuuint32_t (&box)[RANK], CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint32_t ones[RANK];
  for (int i = 0; i < RANK; ++i) ones[i] = 1;
  return fn(map,
            int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            RANK, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_FAILED = 1000;   // + the CUresult of the encode

template <int BODY, int P, int KB>
int launch(const void* a, const void* x, float* y, const int* xloc,
           const int* kcount, int ntiles, int m, int ku, int lm, int c,
           int rows, int q, cudaStream_t stream) {
  using C = Cfg<BODY, P, KB>;
  auto kernel = pairpanel_oz_kernel<BODY, P, KB>;
  const cuuint64_t esz = C::INT ? 1 : 2;
  const int nrb = (m + HROWS - 1) / HROWS;
  const cuuint64_t stages = static_cast<cuuint64_t>(ku) * lm / C::KC;
  CUtensorMap ta, tx;
  // A, staged ([tile, row block, stage, slice, P|Q, 32 rows, depth]) as
  // rows of 256 entries; a box is one stage
  CUresult cr = encode<2>(
      &ta, C::INT, a,
      {C::A_ROW / esz, static_cast<cuuint64_t>(ntiles) * nrb * stages *
                           (C::A_BYTES / C::A_ROW)},
      {C::A_ROW},
      {static_cast<cuuint32_t>(C::A_ROW / esz),
       static_cast<cuuint32_t>(C::A_BYTES / C::A_ROW)},
      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (cr != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(cr);
  // X: the lane-major slices [p, 2, c, rows], boxes {depth, LB lanes,
  // re|im, p slices}
  cr = encode<4>(&tx, C::INT, x,
                 {static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(c),
                  2, P},
                 {rows * esz, c * rows * esz, 2 * c * rows * esz},
                 {static_cast<cuuint32_t>(C::KC), C::LB, 2, P},
                 KB == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                          : CU_TENSOR_MAP_SWIZZLE_64B);
  if (cr != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(cr);

  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int nlb = (c + C::LB - 1) / C::LB;
  OzArgs args{y, xloc, kcount, m, ku, lm, c, q, nrb, nlb, 0};
  const long long items = static_cast<long long>(ntiles) * nrb * nlb;
  if (items > 0x7FFFFFFF) return cudaErrorInvalidValue;
  args.nitems = static_cast<int>(items);

  // as many CTAs as the card holds at once, each walking the items
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int grid = sms * per_sm < args.nitems ? sms * per_sm : args.nitems;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(ta, tx, args);
  return cudaGetLastError();
}

}  // namespace

// The bytes of a stage's depth, which the wrapper stages A by (ctypes):
// 64 in 'ozc', and in 'oz' to p 9, where LM is a multiple of 32 (a stage of
// 32 bf16 entries lies in one slot), else 32.
extern "C" int tfq_pairpanel_oz_stage_bytes(int body, int p, int lm) {
  return body != BODY_XI8 && (body == BODY_OZC || p <= 9) && lm % 32 == 0
             ? 64
             : 32;
}

// C interface, loaded with ctypes.  Returns the cudaError_t of the launch (0
// on success), or 1000 + the CUresult where a tensor map could not be made.
// a holds the tiles' A slices staged as the kernel stages them
// (ops/pairpanel.py's oz_kernel_planes: [ntiles, row blocks of 32, ku*lm /
// depth, p, P|Q, 32 rows, depth] with the swizzle, the depth
// tfq_pairpanel_oz_stage_bytes() bytes), in the products' type: int8 for
// body 2 'xi8',
// else bf16 values (where the slices are int8 integers, a_int8, they are
// re-scaled into bf16 values once, when the multiply is built: the exact
// values of the JAX kernel's int8 -> f32 -> * 2^-(s+1)q -> bf16); x the X
// slices lane-major, [p*2c, rows] (the transpose of the [rows, p*2c] slice
// planes; int8 for body 2, else bf16); y the output (body 0 'oz': [ntiles,
// 2m, p*2c]; 1 'ozc' and 2 'xi8': [ntiles, m, 4c]); xloc [ntiles, ku] and
// kcount [ntiles] the tiles' union slots; q the slice width.  LM must be a
// multiple of the depth (the wrapper pads the slots of LM 4 and 8 with zero
// rows to 16).  The kernel is built for the slice counts of
// ops/pairpanel.py's OZ_KERNEL_P.
extern "C" int tfq_pairpanel_oz(const void* a, const void* x, void* y,
                                const void* xloc, const void* kcount,
                                int ntiles, int m, int ku, int lm, int c,
                                int rows, int p, int q, int body, int a_int8,
                                void* stream) {
  if (ntiles <= 0) return cudaSuccess;
  const int kb = tfq_pairpanel_oz_stage_bytes(body, p, lm);
  const int kc = body == BODY_XI8 ? kb : kb / 2;
  if (m <= 0 || ku <= 0 || lm <= 0 || lm % kc != 0 || c <= 0 || rows <= 0 ||
      rows % lm != 0 || q < 2 || q > 8 ||
      (reinterpret_cast<uintptr_t>(a) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(x) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(y) % 16) != 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  auto yf = static_cast<float*>(y);
  auto xl = static_cast<const int*>(xloc);
  auto kn = static_cast<const int*>(kcount);
#define TFQ_OZ_LAUNCH(BODY, P)                                              \
  (kb == 64                                                                  \
       ? launch<BODY, P,                                                     \
                (BODY != BODY_XI8 && (BODY == BODY_OZC || P <= 9)) ? 64      \
                                                                   : 32>(    \
             a, x, yf, xl, kn, ntiles, m, ku, lm, c, rows, q, st)            \
       : launch<BODY, P, 32>(a, x, yf, xl, kn, ntiles, m, ku, lm, c, rows,   \
                             q, st))
  switch (body) {
    case BODY_OZ:
      switch (p) {
        case 7: return TFQ_OZ_LAUNCH(BODY_OZ, 7);
        case 8: return TFQ_OZ_LAUNCH(BODY_OZ, 8);
        case 9: return TFQ_OZ_LAUNCH(BODY_OZ, 9);
        case 11: return TFQ_OZ_LAUNCH(BODY_OZ, 11);
        case 14: return TFQ_OZ_LAUNCH(BODY_OZ, 14);
        default: return cudaErrorInvalidValue;
      }
    case BODY_OZC:
      switch (p) {
        case 7: return TFQ_OZ_LAUNCH(BODY_OZC, 7);
        case 8: return TFQ_OZ_LAUNCH(BODY_OZC, 8);
        case 9: return TFQ_OZ_LAUNCH(BODY_OZC, 9);
        default: return cudaErrorInvalidValue;
      }
    case BODY_XI8:
      if (a_int8 == 0) return cudaErrorInvalidValue;
      switch (p) {
        case 8: return TFQ_OZ_LAUNCH(BODY_XI8, 8);
        case 9: return TFQ_OZ_LAUNCH(BODY_XI8, 9);
        default: return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
#undef TFQ_OZ_LAUNCH
}
