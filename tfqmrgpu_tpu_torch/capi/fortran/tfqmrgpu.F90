!! Fortran(2003) module for the tfqmrgpu_tpu_torch library (the PyTorch/CUDA
!! port; it solves on the CUDA card).
!!
!! Parity with the reference's module (reference:
!! tfQMRgpu/include/tfqmrgpu_Fortran_module.F90): the full plan-based API
!! plus the high-level convenience tfqmrgpu_bsrsv_rectangular (complete
!! 10-step workflow) and the square-block shorthand tfqmrgpu_bsrsv_complete.
!! Uses ISO_C_BINDING interfaces straight onto the C API
!! (tfqmrgpu_tpu_torch/capi/include/tfqmrgpu_tpu_torch.h); Fortran-index
!! (1-based) arrays are passed with indexOffset=1.  F77-style underscore
!! wrappers are also exported by libtfqmrgpu_tpu_torch.so
!! (capi/src/fortran_wrappers.c).
!!
!! Build (gfortran; the library path is what
!! `python -m tfqmrgpu_tpu_torch.native build` prints):
!!   gfortran -c tfqmrgpu_tpu_torch/capi/fortran/tfqmrgpu.F90
!!   gfortran my_app.f90 tfqmrgpu.o -L<libdir> -ltfqmrgpu_tpu_torch
!! The library embeds CPython: the tfqmrgpu_tpu_torch package and PyTorch
!! must be importable (set PYTHONPATH).

module tfqmrgpu
  use iso_c_binding, only: c_int32_t, c_int64_t, c_double, c_float, &
                           c_char, c_size_t, c_ptr, c_null_ptr
  implicit none
  private

  integer, parameter, public :: TFQMRGPU_LAYOUT_RRRRIIII = int(z'0f')
  integer, parameter, public :: TFQMRGPU_LAYOUT_RRIIRRII = int(z'33')
  integer, parameter, public :: TFQMRGPU_LAYOUT_RIRIRIRI = int(z'55')

  public :: tfqmrgpu_createHandle, tfqmrgpu_destroyHandle
  public :: tfqmrgpu_createPlan, tfqmrgpu_destroyPlan
  public :: tfqmrgpu_bufferSize, tfqmrgpu_setBuffer
  public :: tfqmrgpu_setMatrix_z, tfqmrgpu_getMatrix_z
  public :: tfqmrgpu_solve, tfqmrgpu_getInfo
  public :: tfqmrgpu_bsrsv_rectangular, tfqmrgpu_bsrsv_complete

  interface
    function c_createHandle(handle) bind(c, name='tfqmrgpuCreateHandle') &
        result(status)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), intent(inout) :: handle
      integer(c_int32_t) :: status
    end function

    function c_destroyHandle(handle) bind(c, name='tfqmrgpuDestroyHandle') &
        result(status)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: status
    end function

    function c_createPlan(handle, plan, mb, rowPtrA, nnzbA, colIndA, &
        rowPtrX, nnzbX, colIndX, rowPtrB, nnzbB, colIndB, indexOffset, &
        echo) bind(c, name='tfqmrgpu_bsrsv_createPlan') result(status)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int64_t), intent(inout) :: plan
      integer(c_int32_t), value :: mb, nnzbA, nnzbX, nnzbB, indexOffset, echo
      integer(c_int32_t), intent(in) :: rowPtrA(*), colIndA(*)
      integer(c_int32_t), intent(in) :: rowPtrX(*), colIndX(*)
      integer(c_int32_t), intent(in) :: rowPtrB(*), colIndB(*)
      integer(c_int32_t) :: status
    end function

    function c_destroyPlan(handle, plan) &
        bind(c, name='tfqmrgpu_bsrsv_destroyPlan') result(status)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle, plan
      integer(c_int32_t) :: status
    end function

    function c_bufferSize(handle, plan, ldA, blockDim, ldB, RhsBlockDim, &
        precision, sizeInBytes) bind(c, name='tfqmrgpu_bsrsv_bufferSize') &
        result(status)
      import :: c_int32_t, c_int64_t, c_char, c_size_t
      integer(c_int64_t), value :: handle, plan
      integer(c_int32_t), value :: ldA, blockDim, ldB, RhsBlockDim
      character(kind=c_char), value :: precision
      integer(c_size_t), intent(out) :: sizeInBytes
      integer(c_int32_t) :: status
    end function

    function c_setBuffer(handle, plan, buffer) &
        bind(c, name='tfqmrgpu_bsrsv_setBuffer') result(status)
      import :: c_int32_t, c_int64_t, c_ptr
      integer(c_int64_t), value :: handle, plan
      type(c_ptr), value :: buffer
      integer(c_int32_t) :: status
    end function

    function c_setMatrix_z(handle, plan, var, val, precision, ld, d2, &
        trans, layout) bind(c, name='tfqmrgpu_bsrsv_setMatrix') &
        result(status)
      import :: c_int32_t, c_int64_t, c_char, c_double
      integer(c_int64_t), value :: handle, plan
      character(kind=c_char), value :: var, precision, trans
      real(c_double), intent(in) :: val(*)
      integer(c_int32_t), value :: ld, d2, layout
      integer(c_int32_t) :: status
    end function

    function c_getMatrix_z(handle, plan, var, val, precision, ld, d2, &
        trans, layout) bind(c, name='tfqmrgpu_bsrsv_getMatrix') &
        result(status)
      import :: c_int32_t, c_int64_t, c_char, c_double
      integer(c_int64_t), value :: handle, plan
      character(kind=c_char), value :: var, precision, trans
      real(c_double), intent(out) :: val(*)
      integer(c_int32_t), value :: ld, d2, layout
      integer(c_int32_t) :: status
    end function

    function c_solve(handle, plan, threshold, maxIterations) &
        bind(c, name='tfqmrgpu_bsrsv_solve') result(status)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle, plan
      real(c_double), value :: threshold
      integer(c_int32_t), value :: maxIterations
      integer(c_int32_t) :: status
    end function

    function c_getInfo(handle, plan, residuum, iterations, flops, &
        flops_all) bind(c, name='tfqmrgpu_bsrsv_getInfo') result(status)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle, plan
      real(c_double), intent(out) :: residuum, flops, flops_all
      integer(c_int32_t), intent(out) :: iterations
      integer(c_int32_t) :: status
    end function
  end interface

contains

  subroutine tfqmrgpu_createHandle(handle, status)
    integer(c_int64_t), intent(out) :: handle
    integer(c_int32_t), intent(out) :: status
    handle = 0
    status = c_createHandle(handle)
  end subroutine

  subroutine tfqmrgpu_destroyHandle(handle, status)
    integer(c_int64_t), intent(inout) :: handle
    integer(c_int32_t), intent(out) :: status
    status = c_destroyHandle(handle)
    handle = 0
  end subroutine

  subroutine tfqmrgpu_createPlan(handle, plan, mb, rowPtrA, colIndA, &
      rowPtrX, colIndX, rowPtrB, colIndB, echo, status)
    integer(c_int64_t), intent(in) :: handle
    integer(c_int64_t), intent(out) :: plan
    integer(c_int32_t), intent(in) :: mb, echo
    integer(c_int32_t), intent(in) :: rowPtrA(:), colIndA(:)
    integer(c_int32_t), intent(in) :: rowPtrX(:), colIndX(:)
    integer(c_int32_t), intent(in) :: rowPtrB(:), colIndB(:)
    integer(c_int32_t), intent(out) :: status
    plan = 0
    status = c_createPlan(handle, plan, mb, &
        rowPtrA, int(size(colIndA), c_int32_t), colIndA, &
        rowPtrX, int(size(colIndX), c_int32_t), colIndX, &
        rowPtrB, int(size(colIndB), c_int32_t), colIndB, &
        1_c_int32_t, echo)  ! Fortran 1-based indices
  end subroutine

  subroutine tfqmrgpu_destroyPlan(handle, plan, status)
    integer(c_int64_t), intent(in) :: handle
    integer(c_int64_t), intent(inout) :: plan
    integer(c_int32_t), intent(out) :: status
    status = c_destroyPlan(handle, plan)
    plan = 0
  end subroutine

  subroutine tfqmrgpu_bufferSize(handle, plan, ldA, ldB, precision, &
      sizeInBytes, status)
    integer(c_int64_t), intent(in) :: handle, plan
    integer(c_int32_t), intent(in) :: ldA, ldB
    character(kind=c_char), intent(in) :: precision
    integer(c_int64_t), intent(out) :: sizeInBytes
    integer(c_int32_t), intent(out) :: status
    integer(c_size_t) :: sz
    status = c_bufferSize(handle, plan, ldA, ldA, ldB, ldB, precision, sz)
    sizeInBytes = int(sz, c_int64_t)
  end subroutine

  subroutine tfqmrgpu_setBuffer(handle, plan, status)
    integer(c_int64_t), intent(in) :: handle, plan
    integer(c_int32_t), intent(out) :: status
    status = c_setBuffer(handle, plan, c_null_ptr)
  end subroutine

  subroutine tfqmrgpu_setMatrix_z(handle, plan, var, val, ld, d2, status)
    integer(c_int64_t), intent(in) :: handle, plan
    character(kind=c_char), intent(in) :: var
    real(c_double), intent(in) :: val(*)
    integer(c_int32_t), intent(in) :: ld, d2
    integer(c_int32_t), intent(out) :: status
    status = c_setMatrix_z(handle, plan, var, val, 'z', ld, d2, 'n', &
        TFQMRGPU_LAYOUT_RIRIRIRI)
  end subroutine

  subroutine tfqmrgpu_getMatrix_z(handle, plan, var, val, ld, d2, status)
    integer(c_int64_t), intent(in) :: handle, plan
    character(kind=c_char), intent(in) :: var
    real(c_double), intent(out) :: val(*)
    integer(c_int32_t), intent(in) :: ld, d2
    integer(c_int32_t), intent(out) :: status
    status = c_getMatrix_z(handle, plan, var, val, 'z', ld, d2, 'n', &
        TFQMRGPU_LAYOUT_RIRIRIRI)
  end subroutine

  subroutine tfqmrgpu_solve(handle, plan, threshold, maxIterations, status)
    integer(c_int64_t), intent(in) :: handle, plan
    real(c_double), intent(in) :: threshold
    integer(c_int32_t), intent(in) :: maxIterations
    integer(c_int32_t), intent(out) :: status
    status = c_solve(handle, plan, threshold, maxIterations)
  end subroutine

  subroutine tfqmrgpu_getInfo(handle, plan, residuum, iterations, status)
    integer(c_int64_t), intent(in) :: handle, plan
    real(c_double), intent(out) :: residuum
    integer(c_int32_t), intent(out) :: iterations, status
    real(c_double) :: flops, flops_all
    status = c_getInfo(handle, plan, residuum, iterations, flops, flops_all)
  end subroutine

  !! High-level: the full 10-step workflow for rectangular blocks
  !! (reference: tfqmrgpu_Fortran_module.F90:294-429).
  subroutine tfqmrgpu_bsrsv_rectangular(mb, ldA, ldB, rowPtrA, colIndA, &
      Amat, rowPtrX, colIndX, Xmat, rowPtrB, colIndB, Bmat, tolerance, &
      maxIterations, iterations, residuum, echo, status)
    integer(c_int32_t), intent(in) :: mb, ldA, ldB, maxIterations, echo
    integer(c_int32_t), intent(in) :: rowPtrA(:), colIndA(:)
    integer(c_int32_t), intent(in) :: rowPtrX(:), colIndX(:)
    integer(c_int32_t), intent(in) :: rowPtrB(:), colIndB(:)
    real(c_double), intent(in) :: Amat(*), Bmat(*)
    real(c_double), intent(inout) :: Xmat(*)
    real(c_double), intent(in) :: tolerance
    integer(c_int32_t), intent(out) :: iterations, status
    real(c_double), intent(out) :: residuum
    integer(c_int64_t) :: handle, plan, nbytes
    integer(c_int32_t) :: st

    call tfqmrgpu_createHandle(handle, status)
    if (status /= 0) return
    call tfqmrgpu_createPlan(handle, plan, mb, rowPtrA, colIndA, &
        rowPtrX, colIndX, rowPtrB, colIndB, echo, status)
    if (status /= 0) goto 99
    call tfqmrgpu_bufferSize(handle, plan, ldA, ldB, 'z', nbytes, status)
    if (status /= 0) goto 98
    call tfqmrgpu_setBuffer(handle, plan, status)
    if (status /= 0) goto 98
    call tfqmrgpu_setMatrix_z(handle, plan, 'A', Amat, ldA, ldA, status)
    if (status /= 0) goto 98
    call tfqmrgpu_setMatrix_z(handle, plan, 'B', Bmat, ldA, ldB, status)
    if (status /= 0) goto 98
    call tfqmrgpu_solve(handle, plan, tolerance, maxIterations, status)
    if (status /= 0 .and. status /= 9) goto 98
    call tfqmrgpu_getInfo(handle, plan, residuum, iterations, st)
    call tfqmrgpu_getMatrix_z(handle, plan, 'X', Xmat, ldA, ldB, st)
98  call tfqmrgpu_destroyPlan(handle, plan, st)
99  call tfqmrgpu_destroyHandle(handle, st)
  end subroutine

  !! Square-block shorthand (reference: tfqmrgpu_Fortran_module.F90:432-462)
  subroutine tfqmrgpu_bsrsv_complete(mb, ld, rowPtrA, colIndA, Amat, &
      rowPtrX, colIndX, Xmat, rowPtrB, colIndB, Bmat, tolerance, &
      maxIterations, iterations, residuum, echo, status)
    integer(c_int32_t), intent(in) :: mb, ld, maxIterations, echo
    integer(c_int32_t), intent(in) :: rowPtrA(:), colIndA(:)
    integer(c_int32_t), intent(in) :: rowPtrX(:), colIndX(:)
    integer(c_int32_t), intent(in) :: rowPtrB(:), colIndB(:)
    real(c_double), intent(in) :: Amat(*), Bmat(*)
    real(c_double), intent(inout) :: Xmat(*)
    real(c_double), intent(in) :: tolerance
    integer(c_int32_t), intent(out) :: iterations, status
    real(c_double), intent(out) :: residuum
    call tfqmrgpu_bsrsv_rectangular(mb, ld, ld, rowPtrA, colIndA, Amat, &
        rowPtrX, colIndX, Xmat, rowPtrB, colIndB, Bmat, tolerance, &
        maxIterations, iterations, residuum, echo, status)
  end subroutine

end module tfqmrgpu
