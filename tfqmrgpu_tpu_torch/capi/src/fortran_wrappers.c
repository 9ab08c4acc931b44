/* Fortran-callable wrappers over the tfqmrgpu_tpu_torch C API.
 *
 * Parity with the reference's wrapper layer
 * (reference: tfQMRgpu/source/tfqmrgpu_Fortran_wrappers.c): every API call
 * gets a lowercase+trailing-underscore subroutine form taking all arguments
 * by reference, with the status as a trailing out-argument; handles and
 * plans travel as integer(kind=8); createPlan hardwires the Fortran index
 * offset of 1.  The calls below bind to this library's own C API (the
 * library is linked with -Bsymbolic).
 */
#include <stddef.h>
#include <stdint.h>

#include "tfqmrgpu_tpu_torch.h"

typedef int64_t fint8;   /* Fortran integer(kind=8) */
typedef int32_t fint4;   /* Fortran integer(kind=4) */

void tfqmrgpucreatehandle_(fint8* handle, fint4* status) {
    *handle = 0;
    *status = tfqmrgpuCreateHandle(handle);
}

void tfqmrgpudestroyhandle_(fint8* handle, fint4* status) {
    *status = tfqmrgpuDestroyHandle(*handle);
    *handle = 0;
}

void tfqmrgpusetstream_(fint8* handle, fint8 const* streamId, fint4* status) {
    *status = tfqmrgpuSetStream(*handle, *streamId);
}

void tfqmrgpugetstream_(fint8 const* handle, fint8* streamId, fint4* status) {
    *status = tfqmrgpuGetStream(*handle, streamId);
}

void tfqmrgpucreateworkspace_(fint8* buffer, fint8 const* sizeInBytes,
                              fint4* status) {
    void* p = NULL;
    *status = tfqmrgpuCreateWorkspace(&p, (size_t)*sizeInBytes, 'd');
    *buffer = (fint8)(uintptr_t)p;
}

void tfqmrgpudestroyworkspace_(fint8* buffer, fint4* status) {
    *status = tfqmrgpuDestroyWorkspace((void*)(uintptr_t)*buffer);
    *buffer = 0;
}

void tfqmrgpuprinterror_(fint4 const* status_in, fint4* status) {
    *status = tfqmrgpuPrintError(*status_in);
}

void tfqmrgpu_bsrsv_allowedblocksizes_(fint4* number, fint4* blockSizes,
                                       fint4 const* arrayLength,
                                       fint4* status) {
    *status = tfqmrgpu_bsrsv_allowedBlockSizes(number, blockSizes,
                                               *arrayLength);
}

void tfqmrgpu_bsrsv_blocksizemissing_(fint4 const* ldA, fint4 const* ldB,
                                      fint4* status) {
    *status = tfqmrgpu_bsrsv_blockSizeMissing(*ldA, *ldB);
}

void tfqmrgpu_bsrsv_createplan_(fint8 const* handle, fint8* plan,
    fint4 const* mb,
    fint4 const* bsrRowPtrA, fint4 const* nnzbA, fint4 const* bsrColIndA,
    fint4 const* bsrRowPtrX, fint4 const* nnzbX, fint4 const* bsrColIndX,
    fint4 const* bsrRowPtrB, fint4 const* nnzbB, fint4 const* bsrColIndB,
    fint4 const* echo, fint4* status) {
    int const FortranIndexOffset = 1;
    *plan = 0;
    *status = tfqmrgpu_bsrsv_createPlan(*handle, plan, *mb,
        bsrRowPtrA, *nnzbA, bsrColIndA,
        bsrRowPtrX, *nnzbX, bsrColIndX,
        bsrRowPtrB, *nnzbB, bsrColIndB,
        FortranIndexOffset, *echo);
}

void tfqmrgpu_bsrsv_destroyplan_(fint8 const* handle, fint8* plan,
                                 fint4* status) {
    *status = tfqmrgpu_bsrsv_destroyPlan(*handle, *plan);
    *plan = 0;
}

void tfqmrgpu_bsrsv_buffersize_(fint8 const* handle, fint8 const* plan,
    fint4 const* ldA, fint4 const* blockDim, fint4 const* ldB,
    fint4 const* RhsBlockDim, char const* precision,
    fint8* pBufferSizeInBytes, fint4* status) {
    size_t size = 0;
    *status = tfqmrgpu_bsrsv_bufferSize(*handle, *plan, *ldA, *blockDim,
                                        *ldB, *RhsBlockDim, *precision,
                                        &size);
    *pBufferSizeInBytes = (fint8)size;
}

void tfqmrgpu_bsrsv_setbuffer_(fint8 const* handle, fint8 const* plan,
                               fint8 const* buffer, fint4* status) {
    *status = tfqmrgpu_bsrsv_setBuffer(*handle, *plan,
                                       (void*)(uintptr_t)*buffer);
}

void tfqmrgpu_bsrsv_getbuffer_(fint8 const* handle, fint8 const* plan,
                               fint8* buffer, fint4* status) {
    void* p = NULL;
    *status = tfqmrgpu_bsrsv_getBuffer(*handle, *plan, &p);
    *buffer = (fint8)(uintptr_t)p;
}

/* setMatrix: _c_ (float) and _z_ (double) variants, matching the
 * reference's split (tfqmrgpu_Fortran_wrappers.c:156-174). */
void tfqmrgpu_bsrsv_setmatrix_c_(fint8 const* handle, fint8 const* plan,
    char const* var, float const* val, fint4 const* ld, char const* trans,
    fint4 const* layout, fint4* status) {
    *status = tfqmrgpu_bsrsv_setMatrix(*handle, *plan, *var, val, 'c',
                                       *ld, *ld, *trans, *layout);
}

void tfqmrgpu_bsrsv_setmatrix_z_(fint8 const* handle, fint8 const* plan,
    char const* var, double const* val, fint4 const* ld, char const* trans,
    fint4 const* layout, fint4* status) {
    *status = tfqmrgpu_bsrsv_setMatrix(*handle, *plan, *var, val, 'z',
                                       *ld, *ld, *trans, *layout);
}

void tfqmrgpu_bsrsv_getmatrix_c_(fint8 const* handle, fint8 const* plan,
    char const* var, float* val, fint4 const* ld, char const* trans,
    fint4 const* layout, fint4* status) {
    *status = tfqmrgpu_bsrsv_getMatrix(*handle, *plan, *var, val, 'c',
                                       *ld, *ld, *trans, *layout);
}

void tfqmrgpu_bsrsv_getmatrix_z_(fint8 const* handle, fint8 const* plan,
    char const* var, double* val, fint4 const* ld, char const* trans,
    fint4 const* layout, fint4* status) {
    *status = tfqmrgpu_bsrsv_getMatrix(*handle, *plan, *var, val, 'z',
                                       *ld, *ld, *trans, *layout);
}

void tfqmrgpu_bsrsv_solve_(fint8 const* handle, fint8 const* plan,
    double const* threshold, fint4 const* maxIterations, fint4* status) {
    *status = tfqmrgpu_bsrsv_solve(*handle, *plan, *threshold,
                                   *maxIterations);
}

void tfqmrgpu_bsrsv_getinfo_(fint8 const* handle, fint8 const* plan,
    double* residuum_reached, fint4* iterations_needed,
    double* flops_performed, double* flops_performed_all, fint4* status) {
    *status = tfqmrgpu_bsrsv_getInfo(*handle, *plan, residuum_reached,
                                     iterations_needed, flops_performed,
                                     flops_performed_all);
}

/* one-call solvers; Fortran passes 1-based index arrays */
void tfqmrgpu_bsrsv_z_(fint4 const* mb, fint4 const* ldA, fint4 const* ldB,
    fint4 const* rowPtrA, fint4 const* nnzbA, fint4 const* colIndA,
    double const* Amat, char const* transA,
    fint4 const* rowPtrX, fint4 const* nnzbX, fint4 const* colIndX,
    double* Xmat, char const* transX,
    fint4 const* rowPtrB, fint4 const* nnzbB, fint4 const* colIndB,
    double const* Bmat, char const* transB,
    fint4* iterations, float* residual, fint4 const* echo, fint4* status) {
    *status = tfqmrgpu_bsrsv_z(*mb, *ldA, *ldB,
        rowPtrA, *nnzbA, colIndA, Amat, *transA,
        rowPtrX, *nnzbX, colIndX, Xmat, *transX,
        rowPtrB, *nnzbB, colIndB, Bmat, *transB,
        iterations, residual, 1, *echo);
}

void tfqmrgpu_bsrsv_c_(fint4 const* mb, fint4 const* ldA, fint4 const* ldB,
    fint4 const* rowPtrA, fint4 const* nnzbA, fint4 const* colIndA,
    float const* Amat, char const* transA,
    fint4 const* rowPtrX, fint4 const* nnzbX, fint4 const* colIndX,
    float* Xmat, char const* transX,
    fint4 const* rowPtrB, fint4 const* nnzbB, fint4 const* colIndB,
    float const* Bmat, char const* transB,
    fint4* iterations, float* residual, fint4 const* echo, fint4* status) {
    *status = tfqmrgpu_bsrsv_c(*mb, *ldA, *ldB,
        rowPtrA, *nnzbA, colIndA, Amat, *transA,
        rowPtrX, *nnzbX, colIndX, Xmat, *transX,
        rowPtrB, *nnzbB, colIndB, Bmat, *transB,
        iterations, residual, 1, *echo);
}
