/* tfqmrgpu_tpu_torch: C API of the block-sparse tfQMR solver ported to
 * PyTorch and CUDA.
 *
 * Function-for-function parity with the reference CUDA library's C surface
 * (reference: tfQMRgpu/include/tfqmrgpu.h:16-156): the same 10-step
 * plan-based workflow, the same status-code vocabulary and packing, the same
 * data layouts.  The declarations are those of native/include/tfqmrgpu_tpu.h,
 * so a program switches between the two libraries by its -I and -l flags
 * alone.  The implementation (capi/src/capi.cpp) embeds CPython and drives
 * the port's solver (tfqmrgpu_tpu_torch/api.py) on the CUDA card, where the
 * block products run in the hand-written Hopper kernels; handles and plans
 * are integer ids handed out by the Python registry.
 *
 * Differences from the reference, by design:
 *   - every handle runs on the CUDA card; without one, tfqmrgpuCreateHandle
 *     and the one-call solvers return TFQMRGPU_NO_IMPLEMENTATION.
 *   - tfqmrgpuSetStream/GetStream store an opaque integer: the solve runs on
 *     PyTorch's current stream.
 *   - tfqmrgpuCreateWorkspace returns an opaque token, not device memory:
 *     PyTorch's caching allocator owns device memory.  Pass the token to
 *     setBuffer unchanged.
 *   - precision 'm' (declared but disabled in the reference, tfqmrgpu.cu:42)
 *     iterates in complex64 and refines against a float64 residual; its
 *     matrices are double arrays, as for 'z'.
 */
#ifndef TFQMRGPU_TPU_TORCH_H
#define TFQMRGPU_TPU_TORCH_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int32_t tfqmrgpuStatus_t;      /* packed status code (0 = success) */
typedef int64_t tfqmrgpuHandle_t;      /* opaque handle id (0 before create) */
typedef int64_t tfqmrgpuBsrsvPlan_t;   /* opaque plan id */
typedef int     tfqmrgpuDataLayout_t;  /* complex-block data layout tag */

/* ------------------------------------------------------------- errors -- */
tfqmrgpuStatus_t tfqmrgpuPrintError(tfqmrgpuStatus_t status);
const char*      tfqmrgpuGetErrorString(tfqmrgpuStatus_t status);

/* ------------------------------------------------------------- handle -- */
tfqmrgpuStatus_t tfqmrgpuCreateHandle(tfqmrgpuHandle_t* handle);
tfqmrgpuStatus_t tfqmrgpuDestroyHandle(tfqmrgpuHandle_t handle);
tfqmrgpuStatus_t tfqmrgpuSetStream(tfqmrgpuHandle_t handle, int64_t streamId);
tfqmrgpuStatus_t tfqmrgpuGetStream(tfqmrgpuHandle_t handle, int64_t* streamId);

/* ---------------------------------------------------------- workspace -- */
tfqmrgpuStatus_t tfqmrgpuCreateWorkspace(void** pBuffer, size_t sizeInBytes,
                                         char memType);
tfqmrgpuStatus_t tfqmrgpuDestroyWorkspace(void* pBuffer);

/* ------------------------------------------------------ introspection -- */
tfqmrgpuStatus_t tfqmrgpu_bsrsv_allowedBlockSizes(int32_t* number,
                                                  int32_t* blockSizes,
                                                  int arrayLength);
tfqmrgpuStatus_t tfqmrgpu_bsrsv_blockSizeMissing(int ldA, int ldB);

/* --------------------------------------------------- bsrsv: A*X == B -- */
tfqmrgpuStatus_t tfqmrgpu_bsrsv_createPlan(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t* plan,
    int mb,
    const int32_t* bsrRowPtrA, int nnzbA, const int32_t* bsrColIndA,
    const int32_t* bsrRowPtrX, int nnzbX, const int32_t* bsrColIndX,
    const int32_t* bsrRowPtrB, int nnzbB, const int32_t* bsrColIndB,
    int indexOffset,  /* 0: C-style, 1: Fortran-style indices */
    int echo);        /* verbosity 0..9 */

tfqmrgpuStatus_t tfqmrgpu_bsrsv_destroyPlan(tfqmrgpuHandle_t handle,
                                            tfqmrgpuBsrsvPlan_t plan);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_bufferSize(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan,
    int ldA, int blockDim, int ldB, int RhsBlockDim,
    char precision,   /* 'c': complex<float>, 'z': complex<double> */
    size_t* pBufferSizeInBytes);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_setBuffer(tfqmrgpuHandle_t handle,
                                          tfqmrgpuBsrsvPlan_t plan,
                                          void* pBuffer);
tfqmrgpuStatus_t tfqmrgpu_bsrsv_getBuffer(tfqmrgpuHandle_t handle,
                                          tfqmrgpuBsrsvPlan_t plan,
                                          void** pBuffer);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_setMatrix(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan,
    char var,         /* 'A', 'X' or 'B' */
    const void* val,  /* double* ('z') or float* ('c') block data */
    char precision, int ld, int d2, char trans,
    tfqmrgpuDataLayout_t layout);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_getMatrix(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan,
    char var,         /* only 'X' supported */
    void* val, char precision, int ld, int d2, char trans,
    tfqmrgpuDataLayout_t layout);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_solve(tfqmrgpuHandle_t handle,
                                      tfqmrgpuBsrsvPlan_t plan,
                                      double threshold, int maxIterations);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_getInfo(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan,
    double* residuum_reached, int32_t* iterations_needed,
    double* flops_performed, double* flops_performed_all);

/* ------------------------------------------------- one-call wrappers -- */
/* Solve A*X == B in one call; data layout: RIRIRIRI-interleaved reals.
 * On entry *iterations holds the iteration cap and *residual the threshold;
 * on exit they hold the achieved values. */
tfqmrgpuStatus_t tfqmrgpu_bsrsv_z(int mb, int ldA, int ldB,
    const int32_t* rowPtrA, int nnzbA, const int32_t* colIndA,
    const double* Amat, char transA,
    const int32_t* rowPtrX, int nnzbX, const int32_t* colIndX,
    double* Xmat, char transX,
    const int32_t* rowPtrB, int nnzbB, const int32_t* colIndB,
    const double* Bmat, char transB,
    int32_t* iterations, float* residual, int indexOffset, int echo);

tfqmrgpuStatus_t tfqmrgpu_bsrsv_c(int mb, int ldA, int ldB,
    const int32_t* rowPtrA, int nnzbA, const int32_t* colIndA,
    const float* Amat, char transA,
    const int32_t* rowPtrX, int nnzbX, const int32_t* colIndX,
    float* Xmat, char transX,
    const int32_t* rowPtrB, int nnzbB, const int32_t* colIndB,
    const float* Bmat, char transB,
    int32_t* iterations, float* residual, int indexOffset, int echo);

/* Mixed precision: complex64 iterations + complex128 refinement; data in
 * double like _z.  (The reference declares 'm' but disables it.) */
tfqmrgpuStatus_t tfqmrgpu_bsrsv_m(int mb, int ldA, int ldB,
    const int32_t* rowPtrA, int nnzbA, const int32_t* colIndA,
    const double* Amat, char transA,
    const int32_t* rowPtrX, int nnzbX, const int32_t* colIndX,
    double* Xmat, char transX,
    const int32_t* rowPtrB, int nnzbB, const int32_t* colIndB,
    const double* Bmat, char transB,
    int32_t* iterations, float* residual, int indexOffset, int echo);

/* ---------------------------------------------------------- constants -- */
#define TFQMRGPU_STATUS_SUCCESS            0
#define TFQMRGPU_STATUS_LAUNCH_FAILED      2
#define TFQMRGPU_STATUS_NO_INFO_PASSED     3
#define TFQMRGPU_STATUS_ALLOCATION_FAILED  4
#define TFQMRGPU_STATUS_RANDOM_GEN_FAILED  5
#define TFQMRGPU_STATUS_BREAKDOWN          6
#define TFQMRGPU_POINTER_INVALID           7
#define TFQMRGPU_STATUS_MAX_ITERATIONS     9
#define TFQMRGPU_B_HAS_A_ZERO_COLUMN      11
#define TFQMRGPU_BLOCKSIZE_MISSING        12
#define TFQMRGPU_B_IS_NOT_SUBSET_OF_X     13
#define TFQMRGPU_UNDOCUMENTED_ERROR       14
#define TFQMRGPU_DATALAYOUT_UNKNOWN       15
#define TFQMRGPU_PRECISION_MISSMATCH      16
#define TFQMRGPU_TANSPOSITION_UNKNOWN     17
#define TFQMRGPU_VARIABLENAME_UNKNOWN     18
#define TFQMRGPU_NO_IMPLEMENTATION        19

/* status packing: code + 1000*sourceLine + 10^7*asciiChar */
#define TFQMRGPU_CODE_LINE              1000
#define TFQMRGPU_CODE_CHAR          10000000

/* complex-block data layouts */
#define TFQMRGPU_LAYOUT_RRRRIIII        0x0f  /* split planes (device-native) */
#define TFQMRGPU_LAYOUT_RRIIRRII        0x33
#define TFQMRGPU_LAYOUT_RIRIRIRI        0x55  /* interleaved (host default) */

#ifdef __cplusplus
}  /* extern "C" */
#endif
#endif  /* TFQMRGPU_TPU_TORCH_H */
