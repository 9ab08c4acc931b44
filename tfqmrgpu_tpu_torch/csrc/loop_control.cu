// The control of the tfQMR loop on the card, and the graph that runs the
// loop.  It replaces no TPU kernel: the JAX package runs the whole solve as
// one jax.lax.while_loop (tfqmrgpu_tpu/core.py:157-227) whose predicates,
// the convergence bound and the probe under jax.lax.cond (core.py:188-220),
// are plain XLA.  Here the loop is one CUDA graph (graphloop.py): a WHILE
// conditional node around the iteration and an IF conditional node around
// the true-residual probe.  A conditional node's value can only be set from
// device code (cudaGraphSetConditional), so the decisions that the eager
// loop took on the host are kernels, one for each place:
//
//   tfq_loop_decide    after the iteration: the float64 max of
//                      tau * inv_bn2 times (2 it + 1) (the residual bound),
//                      whether every RHS broke down, the probe predicate,
//                      stop_code 2 on breakdown; it sets the IF node
//   tfq_loop_settle    after the probe's residual res2: the max of res2
//                      under the underflow guard, isDone (taken with the
//                      status before the res2 <= 0 update, as the
//                      reference's loop), the status update, the next
//                      target bound, stop_code 1 and iters_needed on
//                      convergence, n_probes + 1
//   tfq_loop_continue  it < maxit and stop_code == 0; it sets the WHILE node
//
// A sharded solve (parallel/) takes each decision from every rank's
// columns, as the JAX package's pmax / pmin over the mesh (core.py:189-206),
// so decide and settle come in two stages with one all_reduce between
// them, which the graph captures inside the WHILE body:
//
//   tfq_loop_decide_local / tfq_loop_settle_local   this rank's partials:
//       [the max, -1 if the flag ("every RHS broke down", isDone) holds
//       here else 0], float64; settle_local also updates the rank's status
//   all_reduce MAX over every rank of the mesh   (NCCL, graphloop.py)
//   tfq_loop_decide_finish / tfq_loop_settle_finish   the scalars and the
//       IF node from the reduced partials: the max over the ranks, and the
//       flag on every rank (-max(-flag) = min(flag))
//
// Every input of a finish stage (the reduced partials, it, maxit, the
// target bound, tol2) is the same on every rank, so every rank takes the
// same branch of each conditional node.  If one did not, its replay would
// run a collective that the others never join, and the graph would hang
// in it.
//
// The max over the ranks follows JAX's pmax on more than one device, where
// a NaN on one shard is dropped against the others' numbers and a NaN on
// every shard gives -inf: the local stage sends -inf for a NaN (and +0 for
// -0, so that the order of the ranks cannot choose the sign), so NCCL's
// MAX never sees a NaN.  On a mesh of one rank pmax is the identity, and
// the local stage sends the max as it is (``keep_nan``).  Within a rank the
// max propagates NaN, as jnp.max does.
//
// They compute what core.decide and core.settle compute in torch, to the
// bit: the same float64 products and quotient (no sum, so nothing to
// contract into an FMA), and a max that propagates NaN as torch.max does
// (fmax would drop it, and a NaN column would read as converged).
//
// What bounds them on the H100: neither bytes nor operations.  They read
// ncols * LN float64s and int32s, a few thousand at the shapes of the
// repository's problems (FD rtb=12.75: 20 KB), and each is one CTA of 256
// threads (the finish stages one thread): a launch of a few microseconds
// inside the graph.  The design is the simplest that is right: a strided
// loop, a warp shuffle reduction, then one thread writes the scalars and
// sets the handle.
//
// tfq_count is the one-thread kernel that counts a collective on the card:
// the sharded layer captures it after each collective, so its counters
// move with every replay (launch_counts.py).
//
// The graph itself is built with the CUDA runtime (tfq_loop_graph_*): the
// port captures the iteration on one stream into the body of the WHILE
// node and the probe into the body of the IF node with
// cudaStreamBeginCaptureToGraph, ending and resuming the capture around
// each conditional node, so that one stream, and one pool of PyTorch's
// allocator, serve the whole capture.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 256;
// -inf, the start of a max
__device__ __forceinline__ double minus_inf() {
  return __longlong_as_double(static_cast<long long>(0xFFF0000000000000ULL));
}
// reference: #define EPSILON 2.5e-308 (tfqmrgpu_linalg.hxx:31); the
// underflow guard of the probe (core.py's decisions.EPSILON)
constexpr double kEpsilon = 2.5e-308;

// the larger of a and b, NaN if either is NaN (torch.max propagates NaN)
__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// the block's max (NaN-propagating) and "all" of every thread's (m, all),
// in thread 0
__device__ __forceinline__ void reduce(double& m, int& all) {
  __shared__ double sm[kThreads / 32];
  __shared__ int sa[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    all &= __shfl_xor_sync(0xFFFFFFFFu, all, o);
  }
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sm[w] = m;
    sa[w] = all;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      m = max_nan(m, sm[i]);
      all &= sa[i];
    }
  }
}

// the max of tau * inv_bn2 and whether every RHS broke down, in thread 0
__device__ __forceinline__ void decide_reduce(const double* __restrict__ tau,
                                              const double* __restrict__ inv,
                                              const int* __restrict__ status,
                                              int n, double& m,
                                              int& all_broke) {
  m = minus_inf();
  all_broke = 1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    m = max_nan(m, tau[i] * inv[i]);
    const int s = status[i];
    all_broke &= (s == -1) | (s == -2);
  }
  reduce(m, all_broke);
}

// the max of res2 and isDone (with the status before the update), in
// thread 0; the status update
__device__ __forceinline__ void settle_reduce(const double* __restrict__ res2,
                                              int* __restrict__ status, int n,
                                              double t, double& m,
                                              int& done) {
  m = minus_inf();
  done = 1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double r = res2[i];
    const int s = status[i];
    m = max_nan(m, r);
    done &= (r <= t) | (s != 0);   // the status before the update
    if (r <= 0.0) status[i] = 1;
  }
  reduce(m, done);
}

__device__ __forceinline__ void decide_scalars(
    double m, int all_broke, const int* it, const int* maxit,
    const double* target_bound2, int* stop_code, double* max_bound2,
    int* probe, cudaGraphConditionalHandle handle, int set_handle) {
  const int k = *it;
  const double bound2 = m * static_cast<double>(2 * k + 1);
  const int p = ((bound2 <= *target_bound2) || (k >= *maxit)) && !all_broke;
  if (all_broke) *stop_code = 2;
  *max_bound2 = bound2;
  *probe = p;
  if (set_handle) cudaGraphSetConditional(handle, p);
}

__device__ __forceinline__ void settle_scalars(
    double m, int done, double t, const double* max_bound2, const int* it,
    double* residual2, double* target_bound2, int* stop_code,
    int* iters_needed, int* n_probes) {
  const double r2 = max_nan(m, kEpsilon);
  *residual2 = r2;
  *target_bound2 = (*max_bound2 / r2) * t;
  if (done) {
    *stop_code = 1;
    *iters_needed = *it;
  }
  *n_probes += 1;
}

// a rank's partials of a max and a flag (see the top of the file)
__device__ __forceinline__ void write_partials(double m, int flag,
                                               int keep_nan, double* part) {
  if (!keep_nan) m = (m != m) ? minus_inf() : m + 0.0;
  part[0] = m;
  part[1] = flag ? -1.0 : 0.0;
}

__global__ void __launch_bounds__(kThreads)
    decide_kernel(const double* __restrict__ tau,
                  const double* __restrict__ inv_bn2,
                  const int* __restrict__ status, int n, const int* it,
                  const int* maxit, const double* target_bound2,
                  int* stop_code, double* max_bound2, int* probe,
                  cudaGraphConditionalHandle handle, int set_handle,
                  unsigned long long* count) {
  count_launch(count);
  double m;
  int all_broke;
  decide_reduce(tau, inv_bn2, status, n, m, all_broke);
  if (threadIdx.x == 0)
    decide_scalars(m, all_broke, it, maxit, target_bound2, stop_code,
                   max_bound2, probe, handle, set_handle);
}

__global__ void __launch_bounds__(kThreads)
    settle_kernel(const double* __restrict__ res2, int* __restrict__ status,
                  int n, const double* tol2, const double* max_bound2,
                  const int* it, double* residual2, double* target_bound2,
                  int* stop_code, int* iters_needed, int* n_probes,
                  unsigned long long* count) {
  count_launch(count);
  const double t = *tol2;
  double m;
  int done;
  settle_reduce(res2, status, n, t, m, done);
  if (threadIdx.x == 0)
    settle_scalars(m, done, t, max_bound2, it, residual2, target_bound2,
                   stop_code, iters_needed, n_probes);
}

__global__ void __launch_bounds__(kThreads)
    decide_local_kernel(const double* __restrict__ tau,
                        const double* __restrict__ inv_bn2,
                        const int* __restrict__ status, int n, int keep_nan,
                        double* part, unsigned long long* count) {
  count_launch(count);
  double m;
  int all_broke;
  decide_reduce(tau, inv_bn2, status, n, m, all_broke);
  if (threadIdx.x == 0) write_partials(m, all_broke, keep_nan, part);
}

__global__ void decide_finish_kernel(const double* part, const int* it,
                                     const int* maxit,
                                     const double* target_bound2,
                                     int* stop_code, double* max_bound2,
                                     int* probe,
                                     cudaGraphConditionalHandle handle,
                                     int set_handle,
                                     unsigned long long* count) {
  count_launch(count);
  decide_scalars(part[0], part[1] < 0.0, it, maxit, target_bound2, stop_code,
                 max_bound2, probe, handle, set_handle);
}

__global__ void __launch_bounds__(kThreads)
    settle_local_kernel(const double* __restrict__ res2,
                        int* __restrict__ status, int n, const double* tol2,
                        int keep_nan, double* part,
                        unsigned long long* count) {
  count_launch(count);
  double m;
  int done;
  settle_reduce(res2, status, n, *tol2, m, done);
  if (threadIdx.x == 0) write_partials(m, done, keep_nan, part);
}

__global__ void settle_finish_kernel(const double* part, const double* tol2,
                                     const double* max_bound2, const int* it,
                                     double* residual2, double* target_bound2,
                                     int* stop_code, int* iters_needed,
                                     int* n_probes,
                                     unsigned long long* count) {
  count_launch(count);
  settle_scalars(part[0], part[1] < 0.0, *tol2, max_bound2, it, residual2,
                 target_bound2, stop_code, iters_needed, n_probes);
}

__global__ void continue_kernel(const int* it, const int* maxit,
                                const int* stop_code, int* go_out,
                                cudaGraphConditionalHandle handle,
                                int set_handle, unsigned long long* count) {
  count_launch(count);
  const int go = (*it < *maxit) && (*stop_code == 0);
  if (go_out) *go_out = go;
  if (set_handle) cudaGraphSetConditional(handle, go);
}

__global__ void count_kernel(unsigned long long* count) {
  count_launch(count);
}

}  // namespace

// ------------------------------------------------------------- the kernels
// Every entry launches one CTA on ``stream`` and returns the launch's
// cudaError_t.  ``set_handle`` 0 leaves ``handle`` alone (a launch outside
// a graph, as the checks against the plain versions make); ``count`` is the
// kernel's launch counter (launch_count.cuh), or null.  ``part`` is a
// rank's partials, float64[2].

extern "C" int tfq_loop_decide(const void* tau, const void* inv_bn2,
                               const void* status, int n, const void* it,
                               const void* maxit, const void* target_bound2,
                               void* stop_code, void* max_bound2, void* probe,
                               unsigned long long handle, int set_handle,
                               void* stream, void* count) {
  if (n <= 0) return cudaErrorInvalidValue;
  decide_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tau), static_cast<const double*>(inv_bn2),
      static_cast<const int*>(status), n, static_cast<const int*>(it),
      static_cast<const int*>(maxit),
      static_cast<const double*>(target_bound2),
      static_cast<int*>(stop_code), static_cast<double*>(max_bound2),
      static_cast<int*>(probe), handle, set_handle,
      static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_loop_settle(const void* res2, void* status, int n,
                               const void* tol2, const void* max_bound2,
                               const void* it, void* residual2,
                               void* target_bound2, void* stop_code,
                               void* iters_needed, void* n_probes,
                               void* stream, void* count) {
  if (n <= 0) return cudaErrorInvalidValue;
  settle_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(res2), static_cast<int*>(status), n,
      static_cast<const double*>(tol2),
      static_cast<const double*>(max_bound2), static_cast<const int*>(it),
      static_cast<double*>(residual2), static_cast<double*>(target_bound2),
      static_cast<int*>(stop_code), static_cast<int*>(iters_needed),
      static_cast<int*>(n_probes), static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_loop_decide_local(const void* tau, const void* inv_bn2,
                                     const void* status, int n, int keep_nan,
                                     void* part, void* stream, void* count) {
  if (n <= 0) return cudaErrorInvalidValue;
  decide_local_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tau), static_cast<const double*>(inv_bn2),
      static_cast<const int*>(status), n, keep_nan,
      static_cast<double*>(part), static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_loop_decide_finish(const void* part, const void* it,
                                      const void* maxit,
                                      const void* target_bound2,
                                      void* stop_code, void* max_bound2,
                                      void* probe, unsigned long long handle,
                                      int set_handle, void* stream,
                                      void* count) {
  decide_finish_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), static_cast<const int*>(it),
      static_cast<const int*>(maxit),
      static_cast<const double*>(target_bound2),
      static_cast<int*>(stop_code), static_cast<double*>(max_bound2),
      static_cast<int*>(probe), handle, set_handle,
      static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_loop_settle_local(const void* res2, void* status, int n,
                                     const void* tol2, int keep_nan,
                                     void* part, void* stream, void* count) {
  if (n <= 0) return cudaErrorInvalidValue;
  settle_local_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(res2), static_cast<int*>(status), n,
      static_cast<const double*>(tol2), keep_nan, static_cast<double*>(part),
      static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_loop_settle_finish(const void* part, const void* tol2,
                                      const void* max_bound2, const void* it,
                                      void* residual2, void* target_bound2,
                                      void* stop_code, void* iters_needed,
                                      void* n_probes, void* stream,
                                      void* count) {
  settle_finish_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), static_cast<const double*>(tol2),
      static_cast<const double*>(max_bound2), static_cast<const int*>(it),
      static_cast<double*>(residual2), static_cast<double*>(target_bound2),
      static_cast<int*>(stop_code), static_cast<int*>(iters_needed),
      static_cast<int*>(n_probes), static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_loop_continue(const void* it, const void* maxit,
                                 const void* stop_code, void* go_out,
                                 unsigned long long handle, int set_handle,
                                 void* stream, void* count) {
  continue_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(it), static_cast<const int*>(maxit),
      static_cast<const int*>(stop_code), static_cast<int*>(go_out), handle,
      set_handle, static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" int tfq_count(void* stream, void* count) {
  count_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

// --------------------------------------------------------------- the graph
// The capture runs on one stream.  tfq_loop_graph_begin makes a graph and
// captures the stream into it; tfq_loop_graph_handle makes a conditional
// handle on the graph being captured; tfq_loop_graph_open ends the capture,
// adds a conditional node (0 IF, 1 WHILE) after what was captured so far
// and captures the stream into the node's body; tfq_loop_graph_close ends
// that capture and resumes the capture of ``graph``, the enclosing one,
// after the node; tfq_loop_graph_end ends the capture and instantiates the
// graph.  A failed step leaves the stream not capturing where it can.

namespace {

constexpr cudaStreamCaptureMode kMode = cudaStreamCaptureModeThreadLocal;

int end_capture(cudaStream_t st) {
  cudaGraph_t g = nullptr;
  return cudaStreamEndCapture(st, &g);
}

}  // namespace

extern "C" int tfq_loop_graph_begin(void* stream, void** graph_out) {
  cudaGraph_t g = nullptr;
  cudaError_t rc = cudaGraphCreate(&g, 0);
  if (rc != cudaSuccess) return rc;
  rc = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(stream), g,
                                     nullptr, nullptr, 0, kMode);
  if (rc != cudaSuccess) {
    cudaGraphDestroy(g);
    return rc;
  }
  *graph_out = g;
  return cudaSuccess;
}

extern "C" int tfq_loop_graph_handle(void* stream,
                                     unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t g = nullptr;
  cudaError_t rc = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream),
                                            &status, nullptr, &g);
  if (rc != cudaSuccess) return rc;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle h;
  rc = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (rc == cudaSuccess) *handle_out = h;
  return rc;
}

extern "C" int tfq_loop_graph_open(void* stream, unsigned long long handle,
                                   int kind, void** node_out,
                                   void** body_out) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t rc = cudaStreamGetCaptureInfo(st, &status, nullptr, &g, &deps,
                                            &ndeps);
  if (rc != cudaSuccess) return rc;
  if (status != cudaStreamCaptureStatusActive) {
    end_capture(st);
    return cudaErrorStreamCaptureInvalidated;
  }
  // the capture's sink nodes, kept before the capture ends
  cudaGraphNode_t sinks[64];
  if (ndeps > 64) {
    end_capture(st);
    return cudaErrorInvalidValue;
  }
  for (size_t i = 0; i < ndeps; ++i) sinks[i] = deps[i];
  rc = static_cast<cudaError_t>(end_capture(st));
  if (rc != cudaSuccess) return rc;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  rc = cudaGraphAddNode(&node, g, ndeps ? sinks : nullptr, ndeps, &params);
  if (rc != cudaSuccess) return rc;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  rc = cudaStreamBeginCaptureToGraph(st, body, nullptr, nullptr, 0, kMode);
  if (rc != cudaSuccess) return rc;
  *node_out = node;
  *body_out = body;
  return cudaSuccess;
}

extern "C" int tfq_loop_graph_close(void* stream, void* graph, void* node) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = static_cast<cudaError_t>(end_capture(st));
  if (rc != cudaSuccess) return rc;
  const auto n = static_cast<cudaGraphNode_t>(node);
  return cudaStreamBeginCaptureToGraph(st, static_cast<cudaGraph_t>(graph), &n,
                                       nullptr, 1, kMode);
}

// ``why_out`` gets, where the instantiation fails, its
// cudaGraphInstantiateResult and the type of the node at fault (or -1)
extern "C" int tfq_loop_graph_end(void* stream, void* graph, void** exec_out,
                                  int* why_out) {
  cudaError_t rc =
      static_cast<cudaError_t>(end_capture(static_cast<cudaStream_t>(stream)));
  if (rc != cudaSuccess) return rc;
  cudaGraphExec_t exec = nullptr;
  cudaGraphInstantiateParams params = {};
  rc = cudaGraphInstantiateWithParams(&exec, static_cast<cudaGraph_t>(graph),
                                      &params);
  why_out[0] = static_cast<int>(params.result_out);
  why_out[1] = -1;
  cudaGraphNodeType type;
  if (params.errNode_out &&
      cudaGraphNodeGetType(params.errNode_out, &type) == cudaSuccess)
    why_out[1] = static_cast<int>(type);
  if (rc == cudaSuccess)
    *exec_out = exec;
  else
    cudaGetLastError();   // not left for the next launch's check
  return rc;
}

// ends whatever capture the stream is in (after a failure); 0 if it was in
// none
extern "C" int tfq_loop_graph_abort(void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  if (cudaStreamIsCapturing(st, &status) != cudaSuccess ||
      status == cudaStreamCaptureStatusNone)
    return 0;
  end_capture(st);
  cudaGetLastError();
  return 1;
}

extern "C" int tfq_loop_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

extern "C" int tfq_loop_graph_destroy(void* exec, void* graph) {
  cudaError_t rc = cudaSuccess;
  if (exec) rc = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t r2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (rc == cudaSuccess) rc = r2;
  }
  return rc;
}
