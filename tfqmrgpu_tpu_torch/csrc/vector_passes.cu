// The vector passes of the tfQMR loop (ops/linalg.py's VectorPasses): the
// per-column axpy / xpay, the scatter of B into X's blocks, and the two
// stages of the per-column reductions dotp and nrm2.  They replace no TPU
// kernel: the JAX package leaves these passes to XLA
// (tfqmrgpu_tpu/ops/linalg.py), and the port ran each as about ten PyTorch
// kernels over split (re, im) planes (ops/linalg.py's functions, which stay
// as their plain versions and as the CPU's path).
//
//   vecpass_axpay          y := a[col] * x + y   (axpy, reference
//                          col_axpay<ScaleX=true>) or y := x + a[col] * y
//                          (xpay, col_axpay<ScaleX=false>), in place in y;
//                          the block's column comes from colindx and the
//                          per-(column, lane) scalar is read here
//   vecpass_add_rhs        v[subset[i]] += s * b[i], in place in v
//   vecpass_partials       each block's partial of dotp (x . y, re and im)
//                          or nrm2 (|x|^2) over LM, in the data precision,
//                          to float64 [planes, nnzb, LN]
//   vecpass_column_sums    each column's sum of those partials in float64,
//                          in a fixed order over linalg.columns' table
//
// What bounds them on the H100: bytes.  At the benchmark's FD cell (28,215
// blocks of 8 x 8, complex128) an axpy reads two X-shaped vectors and
// writes one, 86.7 MB, 0.026 ms at 3.35 TB/s; the design moves each byte
// once, 16 bytes a thread (two float64 or four float32 lanes of one row),
// with the column index and the scalars read beside the data (L1-resident:
// [ncols, LN]) rather than gathered into X-shaped planes first.  The column
// sums read only the partials (1/LM of a vector) and are bound by the
// latency of one CTA a column.
//
// The elementwise passes equal ops/linalg.py's torch expressions to the
// bit: every product and sum is one rounded operation in torch's order
// (__dmul_rn / __dadd_rn / __dsub_rn and their float forms, which the
// compiler never contracts into an FMA):
//   axpy  re ((ar x0 - ai x1) + y0)   im ((ai x0 + ar x1) + y1)
//   xpay  re ((x0 + ar y0) - ai y1)   im ((x1 + ai y0) + ar y1)
//   add_rhs  v + s b   (torch's index_add on the card: the product, then
//            the sum; s = +-1 in the loop, where the product is exact)
// The reductions cannot keep torch's internal order.  They keep one of
// their own that never changes from run to run (no atomics): a block's
// partial adds its LM rows in order from 0 in the data precision
// (float64 where x or y is), then, for each column, kChunks threads a lane
// each add a consecutive run of the table's slots from 0.0 in float64, and
// a fixed pairwise tree adds the runs.  VectorPasses.plain_dotp / plain_nrm2
// repeat that order in torch, to the bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 256;
// the column sums: runs a column (linalg.SUM_CHUNKS) and lanes a CTA
constexpr int kChunks = 128;
constexpr int kLanes = 4;

// one rounded operation each, never contracted
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// V consecutive elements of one row, loaded and stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& x) {
  *reinterpret_cast<Vec<T, V>*>(p) = x;
}

// the products' type: float64 where either operand is (torch's promotion)
template <typename A, typename B>
struct Promote {
  using type = double;
};
template <>
struct Promote<float, float> {
  using type = float;
};

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

template <typename T, int V, bool kScaleX>
__global__ void __launch_bounds__(kThreads)
    vecpass_axpay(T* y0, T* y1, const T* x0, const T* x1,
                  const T* __restrict__ a0, const T* __restrict__ a1,
                  const int* __restrict__ colindx, long long nvec, int lmln,
                  int ln, unsigned long long* count) {
  count_launch(count);
  for (long long i = first_index(); i < nvec; i += grid_stride()) {
    const long long e = i * V;
    const long long blk = e / lmln;
    const long long s = static_cast<long long>(__ldg(colindx + blk)) * ln +
                        static_cast<int>(e % ln);
    const Vec<T, V> p0 = load<T, V>(x0 + e), p1 = load<T, V>(x1 + e);
    Vec<T, V> q0 = load<T, V>(y0 + e), q1 = load<T, V>(y1 + e);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T ar = __ldg(a0 + s + v), ai = __ldg(a1 + s + v);
      const T u0 = p0.v[v], u1 = p1.v[v], w0 = q0.v[v], w1 = q1.v[v];
      if (kScaleX) {          // y := a x + y
        q0.v[v] = add(sub(mul(ar, u0), mul(ai, u1)), w0);
        q1.v[v] = add(add(mul(ai, u0), mul(ar, u1)), w1);
      } else {                // y := x + a y
        q0.v[v] = sub(add(u0, mul(ar, w0)), mul(ai, w1));
        q1.v[v] = add(add(u1, mul(ai, w0)), mul(ar, w1));
      }
    }
    store<T, V>(y0 + e, q0);
    store<T, V>(y1 + e, q1);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    vecpass_add_rhs(T* v0, T* v1, const T* __restrict__ b0,
                    const T* __restrict__ b1, const int* __restrict__ subset,
                    long long nvec, int lmln, T s,
                    unsigned long long* count) {
  count_launch(count);
  for (long long i = first_index(); i < nvec; i += grid_stride()) {
    const long long e = i * V;
    const long long blk = e / lmln;
    const long long d =
        static_cast<long long>(__ldg(subset + blk)) * lmln + (e - blk * lmln);
    const Vec<T, V> p0 = load<T, V>(b0 + e), p1 = load<T, V>(b1 + e);
    Vec<T, V> q0 = load<T, V>(v0 + d), q1 = load<T, V>(v1 + d);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      q0.v[v] = add(q0.v[v], mul(s, p0.v[v]));
      q1.v[v] = add(q1.v[v], mul(s, p1.v[v]));
    }
    store<T, V>(v0 + d, q0);
    store<T, V>(v1 + d, q1);
  }
}

// a thread a (block, V lanes): the sum over the block's LM rows, from 0,
// in the products' type; dotp writes re to plane 0 and im to plane 1 of
// part, nrm2 (y unused) |x|^2 to plane 0
template <typename TX, typename TY, int V, bool kDot>
__global__ void __launch_bounds__(kThreads)
    vecpass_partials(const TX* __restrict__ x0, const TX* __restrict__ x1,
                     const TY* __restrict__ y0, const TY* __restrict__ y1,
                     double* __restrict__ part, long long ngroups, int lm,
                     int ln, long long plane, unsigned long long* count) {
  using TC = typename Promote<TX, TY>::type;
  count_launch(count);
  const int per_row = ln / V;
  for (long long g = first_index(); g < ngroups; g += grid_stride()) {
    const long long blk = g / per_row;
    const int n = static_cast<int>(g - blk * per_row) * V;
    const long long base = blk * lm * ln + n;
    TC pr[V], pi[V];
#pragma unroll
    for (int v = 0; v < V; ++v) pr[v] = pi[v] = TC(0);
#pragma unroll 4
    for (int m = 0; m < lm; ++m) {
      const long long o = base + static_cast<long long>(m) * ln;
      const Vec<TX, V> a0 = load<TX, V>(x0 + o), a1 = load<TX, V>(x1 + o);
      if (kDot) {
        const Vec<TY, V> b0 = load<TY, V>(y0 + o), b1 = load<TY, V>(y1 + o);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const TC u0 = a0.v[v], u1 = a1.v[v], w0 = b0.v[v], w1 = b1.v[v];
          pr[v] = add(pr[v], sub(mul(u0, w0), mul(u1, w1)));
          pi[v] = add(pi[v], add(mul(u0, w1), mul(u1, w0)));
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const TC u0 = a0.v[v], u1 = a1.v[v];
          pr[v] = add(pr[v], add(mul(u0, u0), mul(u1, u1)));
        }
      }
    }
    double* out = part + blk * ln + n;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[v] = static_cast<double>(pr[v]);
      if (kDot) out[plane + v] = static_cast<double>(pi[v]);
    }
  }
}

// one CTA a (column, kLanes lanes, plane): run r of kChunks adds the
// table's slots [r k, (r + 1) k) from 0.0 (k = ceil(width / kChunks);
// a padding slot, nnzb, adds nothing), then a pairwise tree adds run
// r + h into run r for h = kChunks / 2, ..., 1
__global__ void __launch_bounds__(kChunks* kLanes)
    vecpass_column_sums(const double* __restrict__ part, long long plane,
                        int nnzb, int ln, const long long* __restrict__ table,
                        int ncols, int width, double* __restrict__ out,
                        unsigned long long* count) {
  __shared__ double acc[kChunks][kLanes];
  count_launch(count);
  const int lane = threadIdx.x % kLanes, run = threadIdx.x / kLanes;
  const int col = blockIdx.x, n = blockIdx.y * kLanes + lane;
  const int k = (width + kChunks - 1) / kChunks;
  double s = 0.0;
  if (n < ln) {
    const double* p = part + blockIdx.z * plane + n;
    const long long* row = table + static_cast<long long>(col) * width;
    const int j1 = min(width, (run + 1) * k);
#pragma unroll 4
    for (int j = run * k; j < j1; ++j) {
      const long long b = __ldg(row + j);
      if (b < nnzb) s = add(s, __ldg(p + b * ln));
    }
  }
  acc[run][lane] = s;
  __syncthreads();
#pragma unroll
  for (int h = kChunks / 2; h > 0; h >>= 1) {
    if (run < h) acc[run][lane] = add(acc[run][lane], acc[run + h][lane]);
    __syncthreads();
  }
  if (run == 0 && n < ln)
    out[(static_cast<long long>(blockIdx.z) * ncols + col) * ln + n] =
        acc[0][lane];
}

unsigned grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(g < (1LL << 20) ? (g > 0 ? g : 1) : (1LL << 20));
}

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int axpay(void* y0, void* y1, const void* x0, const void* x1, const void* a0,
          const void* a1, const int* colindx, long long nnzb, int lm, int ln,
          int scale_x, cudaStream_t stream, unsigned long long* count) {
  constexpr int W = 16 / sizeof(T);
  const long long n = nnzb * lm * ln;
  const bool wide = ln % W == 0 && aligned(y0) && aligned(y1) &&
                    aligned(x0) && aligned(x1);
  const long long nvec = wide ? n / W : n;
  auto args = [&](auto kernel) {
    kernel<<<grid_for(nvec), kThreads, 0, stream>>>(
        static_cast<T*>(y0), static_cast<T*>(y1), static_cast<const T*>(x0),
        static_cast<const T*>(x1), static_cast<const T*>(a0),
        static_cast<const T*>(a1), colindx, nvec, lm * ln, ln, count);
  };
  if (wide)
    scale_x ? args(vecpass_axpay<T, W, true>) : args(vecpass_axpay<T, W, false>);
  else
    scale_x ? args(vecpass_axpay<T, 1, true>) : args(vecpass_axpay<T, 1, false>);
  return cudaGetLastError();
}

template <typename T>
int add_rhs(void* v0, void* v1, const void* b0, const void* b1,
            const int* subset, long long nnzb_b, int lm, int ln, double s,
            cudaStream_t stream, unsigned long long* count) {
  constexpr int W = 16 / sizeof(T);
  const long long n = nnzb_b * lm * ln;
  const bool wide = (lm * ln) % W == 0 && aligned(v0) && aligned(v1) &&
                    aligned(b0) && aligned(b1);
  const long long nvec = wide ? n / W : n;
  auto args = [&](auto kernel) {
    kernel<<<grid_for(nvec), kThreads, 0, stream>>>(
        static_cast<T*>(v0), static_cast<T*>(v1), static_cast<const T*>(b0),
        static_cast<const T*>(b1), subset, nvec, lm * ln, static_cast<T>(s),
        count);
  };
  wide ? args(vecpass_add_rhs<T, W>) : args(vecpass_add_rhs<T, 1>);
  return cudaGetLastError();
}

template <typename TX, typename TY>
int partials(const void* x0, const void* x1, const void* y0, const void* y1,
             double* part, long long nnzb, int lm, int ln, int dot,
             cudaStream_t stream, unsigned long long* count) {
  constexpr int W = 16 / (sizeof(TX) > sizeof(TY) ? sizeof(TX) : sizeof(TY));
  const bool wide = ln % W == 0 && aligned(x0) && aligned(x1) &&
                    (!dot || (aligned(y0) && aligned(y1)));
  const long long ngroups = nnzb * (wide ? ln / W : ln);
  const long long plane = nnzb * ln;
  auto args = [&](auto kernel) {
    kernel<<<grid_for(ngroups), kThreads, 0, stream>>>(
        static_cast<const TX*>(x0), static_cast<const TX*>(x1),
        static_cast<const TY*>(y0), static_cast<const TY*>(y1), part, ngroups,
        lm, ln, plane, count);
  };
  if (wide)
    dot ? args(vecpass_partials<TX, TY, W, true>)
        : args(vecpass_partials<TX, TY, W, false>);
  else
    dot ? args(vecpass_partials<TX, TY, 1, true>)
        : args(vecpass_partials<TX, TY, 1, false>);
  return cudaGetLastError();
}

}  // namespace

// y := a[col] x + y (scale_x 1) or y := x + a[col] y (scale_x 0) over
// [nnzb, lm, ln] planes of float64 (f32 0) or float32 (f32 1); a [ncols, ln]
// in the same type, colindx int32 [nnzb]
extern "C" int tfq_vec_axpay(void* y_re, void* y_im, const void* x_re,
                             const void* x_im, const void* a_re,
                             const void* a_im, const void* colindx, int nnzb,
                             int lm, int ln, int scale_x, int f32,
                             void* stream, void* count) {
  if (nnzb < 0 || lm <= 0 || ln <= 0) return cudaErrorInvalidValue;
  if (nnzb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<unsigned long long*>(count);
  auto ci = static_cast<const int*>(colindx);
  return f32 ? axpay<float>(y_re, y_im, x_re, x_im, a_re, a_im, ci, nnzb, lm,
                            ln, scale_x, s, c)
             : axpay<double>(y_re, y_im, x_re, x_im, a_re, a_im, ci, nnzb, lm,
                             ln, scale_x, s, c);
}

// v[subset[i]] += s b[i] over b's nnzb_b blocks
extern "C" int tfq_vec_add_rhs(void* v_re, void* v_im, const void* b_re,
                               const void* b_im, const void* subset,
                               int nnzb_b, int lm, int ln, double s, int f32,
                               void* stream, void* count) {
  if (nnzb_b < 0 || lm <= 0 || ln <= 0) return cudaErrorInvalidValue;
  if (nnzb_b == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<unsigned long long*>(count);
  auto sub = static_cast<const int*>(subset);
  return f32 ? add_rhs<float>(v_re, v_im, b_re, b_im, sub, nnzb_b, lm, ln, s,
                              st, c)
             : add_rhs<double>(v_re, v_im, b_re, b_im, sub, nnzb_b, lm, ln, s,
                               st, c);
}

// the blocks' partials into part (float64 [2, nnzb, ln] for dotp, [nnzb,
// ln] for nrm2, whose y is null); x_f32 / y_f32 name each operand's type
extern "C" int tfq_vec_partials(const void* x_re, const void* x_im,
                                const void* y_re, const void* y_im,
                                void* part, int nnzb, int lm, int ln, int dot,
                                int x_f32, int y_f32, void* stream,
                                void* count) {
  if (nnzb < 0 || lm <= 0 || ln <= 0) return cudaErrorInvalidValue;
  if (nnzb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<unsigned long long*>(count);
  auto p = static_cast<double*>(part);
  if (!dot) y_f32 = x_f32;
  if (x_f32 && y_f32)
    return partials<float, float>(x_re, x_im, y_re, y_im, p, nnzb, lm, ln,
                                  dot, s, c);
  if (x_f32)
    return partials<float, double>(x_re, x_im, y_re, y_im, p, nnzb, lm, ln,
                                   dot, s, c);
  if (y_f32)
    return partials<double, float>(x_re, x_im, y_re, y_im, p, nnzb, lm, ln,
                                   dot, s, c);
  return partials<double, double>(x_re, x_im, y_re, y_im, p, nnzb, lm, ln,
                                  dot, s, c);
}

// out[plane, col, :] = the column's sum of part[plane, table[col, :], :]
// (float64; a table slot equal to nnzb is padding)
extern "C" int tfq_vec_column_sums(const void* part, int planes, int nnzb,
                                   int ln, const void* table, int ncols,
                                   int width, void* out, void* stream,
                                   void* count) {
  if (planes <= 0 || nnzb < 0 || ln <= 0 || ncols < 0 || width <= 0)
    return cudaErrorInvalidValue;
  if (ncols == 0) return cudaSuccess;
  const dim3 grid(ncols, (ln + kLanes - 1) / kLanes, planes);
  vecpass_column_sums<<<grid, kChunks * kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), static_cast<long long>(nnzb) * ln,
      nnzb, ln, static_cast<const long long*>(table), ncols, width,
      static_cast<double*>(out), static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}
