! Fortran interface to superlu_dist_tpu_torch, the PyTorch/CUDA port.
!
! Capability analog of the reference's handle-based Fortran-90 wrapper
! (FORTRAN/superlu_mod.f90 + superlu_c2f_dwrap.c): thin ISO_C_BINDING
! interfaces over the C API in slu_tpu.h (the same module as the JAX
! package's: the header's symbols are the same).  Matrices are CSR with
! int64 indices; B/X are column-major n x nrhs, as a Fortran caller lays
! them out naturally.
!
! Usage:
!   use superlu_tpu
!   info = slu_tpu_init(c_null_char)          ! the card ("cpu": the CPU)
!   info = slu_tpu_solve(n, nnz, indptr, indices, values, b, x, nrhs)
! Link against libslu_tpu_torch.so (bindings/build.py) and the embedded-
! python libs: $(python3-config --embed --ldflags).

module superlu_tpu
  use iso_c_binding
  implicit none

  interface
     integer(c_int) function slu_tpu_init(backend) bind(C, name="slu_tpu_init")
       import :: c_int, c_char
       character(kind=c_char), dimension(*) :: backend
     end function slu_tpu_init

     integer(c_int) function slu_tpu_solve(n, nnz, indptr, indices, values, &
          b, x, nrhs) bind(C, name="slu_tpu_solve")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: n, nnz, nrhs
       integer(c_int64_t), dimension(*) :: indptr, indices
       real(c_double), dimension(*) :: values, b
       real(c_double), dimension(*) :: x
     end function slu_tpu_solve

     integer(c_int) function slu_tpu_factor(n, nnz, indptr, indices, values, &
          handle) bind(C, name="slu_tpu_factor")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: n, nnz
       integer(c_int64_t), dimension(*) :: indptr, indices
       real(c_double), dimension(*) :: values
       integer(c_int64_t) :: handle
     end function slu_tpu_factor

     integer(c_int) function slu_tpu_solve_factored(handle, n, b, x, nrhs) &
          bind(C, name="slu_tpu_solve_factored")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: handle, n, nrhs
       real(c_double), dimension(*) :: b
       real(c_double), dimension(*) :: x
     end function slu_tpu_solve_factored

     integer(c_int) function slu_tpu_free_handle(handle) &
          bind(C, name="slu_tpu_free_handle")
       import :: c_int, c_int64_t
       integer(c_int64_t), value :: handle
     end function slu_tpu_free_handle

     ! ---- full-surface API (superlu_c2f_dwrap.c:51-327 analog) --------
     ! Option handles carry the reference options surface: keys like
     ! "ColPerm", "RowPerm", "Fact", "IterRefine", "Trans", "Equil",
     ! "DiagInv"; values are enum names / "YES"/"NO" / numbers.

     integer(c_int) function slu_tpu_options_create(opt) &
          bind(C, name="slu_tpu_options_create")
       import :: c_int, c_int64_t
       integer(c_int64_t) :: opt
     end function slu_tpu_options_create

     integer(c_int) function slu_tpu_options_set(opt, key, val) &
          bind(C, name="slu_tpu_options_set")
       import :: c_int, c_int64_t, c_char
       integer(c_int64_t), value :: opt
       character(kind=c_char), dimension(*) :: key, val
     end function slu_tpu_options_set

     integer(c_int) function slu_tpu_options_get(opt, key, buf, buflen) &
          bind(C, name="slu_tpu_options_get")
       import :: c_int, c_int64_t, c_char
       integer(c_int64_t), value :: opt, buflen
       character(kind=c_char), dimension(*) :: key
       character(kind=c_char), dimension(*) :: buf
     end function slu_tpu_options_get

     integer(c_int) function slu_tpu_options_free(opt) &
          bind(C, name="slu_tpu_options_free")
       import :: c_int, c_int64_t
       integer(c_int64_t), value :: opt
     end function slu_tpu_options_free

     integer(c_int) function slu_tpu_solve_opts(opt, n, nnz, indptr, &
          indices, values, b, ldb, x, ldx, nrhs) &
          bind(C, name="slu_tpu_solve_opts")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: opt, n, nnz, ldb, ldx, nrhs
       integer(c_int64_t), dimension(*) :: indptr, indices
       real(c_double), dimension(*) :: values, b
       real(c_double), dimension(*) :: x
     end function slu_tpu_solve_opts

     integer(c_int) function slu_tpu_factor_opts(opt, n, nnz, indptr, &
          indices, values, handle) bind(C, name="slu_tpu_factor_opts")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: opt, n, nnz
       integer(c_int64_t), dimension(*) :: indptr, indices
       real(c_double), dimension(*) :: values
       integer(c_int64_t) :: handle
     end function slu_tpu_factor_opts

     ! Refactor with new values, same pattern: tier 1 = SamePattern,
     ! tier 2 = SamePattern_SameRowPerm (fact_t reuse tiers)
     integer(c_int) function slu_tpu_refactor(handle, nnz, values, tier) &
          bind(C, name="slu_tpu_refactor")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: handle, nnz, tier
       real(c_double), dimension(*) :: values
     end function slu_tpu_refactor

     integer(c_int) function slu_tpu_solve_factored_opts(handle, opt, n, &
          b, ldb, x, ldx, nrhs) bind(C, name="slu_tpu_solve_factored_opts")
       import :: c_int, c_int64_t, c_double
       integer(c_int64_t), value :: handle, opt, n, ldb, ldx, nrhs
       real(c_double), dimension(*) :: b
       real(c_double), dimension(*) :: x
     end function slu_tpu_solve_factored_opts

     ! Named statistics (PStatPrint analog): "FACT", "SOLVE", "REFINE",
     ! "FACT_FLOPS", "TINY_PIVOTS", "BERR", "NNZ_L", ...
     integer(c_int) function slu_tpu_stat_get(handle, name, val) &
          bind(C, name="slu_tpu_stat_get")
       import :: c_int, c_int64_t, c_char, c_double
       integer(c_int64_t), value :: handle
       character(kind=c_char), dimension(*) :: name
       real(c_double) :: val
     end function slu_tpu_stat_get

     subroutine slu_tpu_finalize() bind(C, name="slu_tpu_finalize")
     end subroutine slu_tpu_finalize
  end interface
end module superlu_tpu
