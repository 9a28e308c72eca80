! Fortran example driver over the port — capability analog of the
! reference's FORTRAN/f_pddrive.f90 + f_5x5.f90: solve a small sparse
! system through the handle-based Fortran interface (superlu_mod.f90 ->
! slu_tpu.h C API), on the card unless the first command-line argument
! names another backend ("cpu").
!
! The 5x5 test system is the same shape the reference's f_5x5 example
! uses: an unsymmetric pattern with a known solution of all ones.
!
! Build (needs gfortran):
!   python -m superlu_dist_tpu_torch.bindings.build   # libslu_tpu_torch.so
!   gfortran -o f_pddrive superlu_mod.f90 f_pddrive.f90 \
!       <dir>/libslu_tpu_torch.so $(python3-config --embed --ldflags)
!   PYTHONPATH=<checkout> ./f_pddrive [cpu]

program f_pddrive
  use superlu_tpu
  use iso_c_binding
  implicit none

  integer(c_int64_t), parameter :: n = 5, nnz = 12, nrhs = 1
  integer(c_int64_t) :: indptr(n + 1), indices(nnz)
  real(c_double) :: values(nnz), b(n), x(n)
  real(c_double) :: err
  integer(c_int) :: info
  integer :: i
  character(len=16) :: backend

  ! CSR of the 5x5 example matrix (rows: diagonal plus off-diagonals)
  indptr  = [0_c_int64_t, 3_c_int64_t, 5_c_int64_t, 8_c_int64_t, &
             10_c_int64_t, 12_c_int64_t]
  indices = [0_c_int64_t, 2_c_int64_t, 4_c_int64_t, &
             1_c_int64_t, 3_c_int64_t, &
             0_c_int64_t, 2_c_int64_t, 4_c_int64_t, &
             1_c_int64_t, 3_c_int64_t, &
             0_c_int64_t, 4_c_int64_t]
  values  = [19.0d0, 21.0d0, 21.0d0, &
             12.0d0, 12.0d0, &
             12.0d0, 16.0d0, 12.0d0, &
             5.0d0, 18.0d0, &
             12.0d0, 18.0d0]

  ! b = A * ones  =>  expected x = ones
  b = 0.0d0
  do i = 1, int(n)
     block
       integer :: k
       do k = int(indptr(i)) + 1, int(indptr(i + 1))
          b(i) = b(i) + values(k)
       end do
     end block
  end do

  call get_command_argument(1, backend)
  info = slu_tpu_init(trim(backend) // c_null_char)
  if (info /= 0) stop "slu_tpu_init failed"

  info = slu_tpu_solve(n, nnz, indptr, indices, values, b, x, nrhs)
  if (info /= 0) stop "slu_tpu_solve failed"

  err = maxval(abs(x - 1.0d0))
  print "(a, es10.3)", "f_pddrive: ||x - ones||_inf = ", err
  if (err > 1.0d-10) stop "accuracy check FAILED"

  ! ---- full-surface path: options + factor-once / solve-twice reuse ----
  ! (the reference f_pddrive3-style sequence: FACTORED re-solve, then a
  ! SamePattern_SameRowPerm refactorization with new values)
  call full_surface_sequence()

  print *, "f_pddrive: PASS"
  call slu_tpu_finalize()

contains

  subroutine full_surface_sequence()
    integer(c_int64_t) :: opt, handle
    real(c_double) :: b2(n, 2), x2(n, 2), values2(nnz), stat_val
    character(kind=c_char) :: buf(32)
    integer :: j, k2
    integer(c_int) :: rc

    rc = slu_tpu_options_create(opt)
    if (rc /= 0) stop "options_create failed"
    rc = slu_tpu_options_set(opt, c_char_"ColPerm" // c_null_char, &
                             c_char_"COLAMD" // c_null_char)
    if (rc /= 0) stop "options_set ColPerm failed"
    rc = slu_tpu_options_set(opt, c_char_"IterRefine" // c_null_char, &
                             c_char_"SLU_DOUBLE" // c_null_char)
    if (rc /= 0) stop "options_set IterRefine failed"
    rc = slu_tpu_options_get(opt, c_char_"ColPerm" // c_null_char, buf, &
                             32_c_int64_t)
    if (rc /= 0) stop "options_get failed"

    ! factor once under the options handle
    rc = slu_tpu_factor_opts(opt, n, nnz, indptr, indices, values, handle)
    if (rc /= 0) stop "factor_opts failed"

    ! solve 1: two right-hand sides, FACTORED tier
    do j = 1, 2
       do k2 = 1, int(n)
          b2(k2, j) = real(j, c_double) * b(k2)
       end do
    end do
    rc = slu_tpu_solve_factored_opts(handle, 0_c_int64_t, n, b2, n, &
                                     x2, n, 2_c_int64_t)
    if (rc /= 0) stop "solve_factored_opts failed"
    if (maxval(abs(x2(:, 1) - 1.0d0)) > 1.0d-10) stop "reuse solve 1 FAILED"
    if (maxval(abs(x2(:, 2) - 2.0d0)) > 1.0d-10) stop "reuse solve 2 FAILED"

    ! refactor with scaled values (same pattern, tier 2 =
    ! SamePattern_SameRowPerm), then solve again through the same handle
    values2 = 2.0d0 * values
    rc = slu_tpu_refactor(handle, nnz, values2, 2_c_int64_t)
    if (rc /= 0) stop "refactor failed"
    rc = slu_tpu_solve_factored_opts(handle, 0_c_int64_t, n, b2, n, &
                                     x2, n, 2_c_int64_t)
    if (rc /= 0) stop "post-refactor solve failed"
    if (maxval(abs(x2(:, 1) - 0.5d0)) > 1.0d-10) stop "refactor solve FAILED"

    ! statistics surface
    rc = slu_tpu_stat_get(handle, c_char_"FACT" // c_null_char, stat_val)
    if (rc /= 0 .or. stat_val < 0.0d0) stop "stat_get FACT failed"
    rc = slu_tpu_stat_get(handle, c_char_"NNZ_L" // c_null_char, stat_val)
    if (rc /= 0 .or. stat_val < real(n, c_double)) stop "stat_get NNZ_L failed"

    rc = slu_tpu_free_handle(handle)
    if (rc /= 0) stop "free_handle failed"
    rc = slu_tpu_options_free(opt)
    if (rc /= 0) stop "options_free failed"
    print *, "f_pddrive: full-surface reuse sequence OK"
  end subroutine full_surface_sequence
end program f_pddrive
