!! Fortran example: built-in test cases through the high-level
!! tfqmrgpu_bsrsv_complete workflow of the tfqmrgpu_tpu_torch library (the
!! PyTorch/CUDA port; the solves run on the CUDA card).
!!
!! Behavior parity with the reference's Fortran example
!! (reference: example/tfqmrgpu_Fortran_example.F90): case 1 solves a single
!! dense 8x8 block, case 2 a 4-row dense block matrix.
!!
!! Build + run (<libdir> is what `python -m tfqmrgpu_tpu_torch.native build`
!! prints):
!!   gfortran -o f_example tfqmrgpu_tpu_torch/capi/fortran/tfqmrgpu.F90 \
!!            tfqmrgpu_tpu_torch/examples/tfqmrgpu_fortran_example.F90 \
!!            -L<libdir> -ltfqmrgpu_tpu_torch -Wl,-rpath,<libdir>
!!   PYTHONPATH=$PWD ./f_example

program tfqmrgpu_fortran_example
  use tfqmrgpu
  use iso_c_binding, only: c_int32_t, c_int64_t, c_double
  implicit none

  call run_case(1, 8)   ! one dense 8x8 block
  call run_case(4, 4)   ! 4x4 block-dense, 4x4 blocks
  write(*,'(a)') 'tfqmrgpu_fortran_example: done'

contains

  subroutine run_case(mb, ld)
    integer, intent(in) :: mb, ld
    integer(c_int32_t) :: rowPtr(mb+1), colInd(mb*mb)
    real(c_double), allocatable :: Amat(:), Bmat(:), Xmat(:)
    integer(c_int32_t) :: iterations, status
    real(c_double) :: residuum
    integer :: i, j, k, nnzb, d

    ! dense block pattern, 1-based indices
    nnzb = 0
    do i = 1, mb
      rowPtr(i) = nnzb + 1
      do j = 1, mb
        nnzb = nnzb + 1
        colInd(nnzb) = j
      end do
    end do
    rowPtr(mb+1) = nnzb + 1

    allocate(Amat(nnzb*ld*ld*2), Bmat(nnzb*ld*ld*2), Xmat(nnzb*ld*ld*2))
    call random_number(Amat)
    call random_number(Bmat)
    Amat = 0.1d0 * (Amat - 0.5d0)
    ! diagonal dominance on the block diagonal
    do k = 1, nnzb
      i = (k - 1) / mb + 1
      if (colInd(k) == i) then
        do d = 0, ld - 1
          Amat(((k-1)*ld*ld + d*ld + d)*2 + 1) = &
              Amat(((k-1)*ld*ld + d*ld + d)*2 + 1) + 4.0d0 * ld
        end do
      end if
    end do
    Xmat = 0.0d0

    call tfqmrgpu_bsrsv_complete(int(mb, c_int32_t), int(ld, c_int32_t), &
        rowPtr, colInd(1:nnzb), Amat, &
        rowPtr, colInd(1:nnzb), Xmat, &
        rowPtr, colInd(1:nnzb), Bmat, &
        1.0d-9, 500_c_int32_t, iterations, residuum, 0_c_int32_t, status)

    if (status /= 0) then
      write(*,'(a,i0,a,i0)') '# case mb=', mb, ' FAILED with status ', status
    else
      write(*,'(a,i0,a,i0,a,es10.3)') '# case mb=', mb, &
          ' converged in ', iterations, ' iterations, residuum ', residuum
    end if
    deallocate(Amat, Bmat, Xmat)
  end subroutine

end program tfqmrgpu_fortran_example
