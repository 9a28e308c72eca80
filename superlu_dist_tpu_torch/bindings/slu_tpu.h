/*
 * C API of superlu_dist_tpu_torch, the PyTorch/CUDA port of the
 * SuperLU_DIST framework for NVIDIA GPUs.
 *
 * The same symbols, signatures and error codes as the JAX package's
 * superlu_dist_tpu/bindings/slu_tpu.h, so a C or Fortran program written
 * against that header relinks against libslu_tpu_torch.so unchanged.
 * Capability analog of the reference's C-callable library API (pdgssvx,
 * SRC/pdgssvx.c:505) and of its handle-based Fortran wrapper layer
 * (FORTRAN/superlu_c2f_dwrap.c:51-327): C and Fortran programs solve
 * sparse A X = B through a solver runtime hosted in an embedded Python
 * interpreter that drives the port on the card.  Factorization handles
 * give the reference's Fact-reuse tiers (FACTORED re-solves).
 *
 * Matrix input: CSR with int64 indices (the XSDK 64-bit index build of the
 * reference), double values.  Right-hand sides and solutions are
 * column-major (Fortran order), n x nrhs.
 *
 * Fortran usage (ISO_C_BINDING): see superlu_mod.f90 next to this header.
 *
 * Link:  cc app.c -lslu_tpu_torch $(python3-config --embed --ldflags)
 *        with libslu_tpu_torch.so built by bindings/build.py (into the
 *        checkout's build/ directory).
 *
 * All functions return 0 on success; > 0 mirrors pdgssvx's info (first
 * zero pivot, 1-based); < 0 is a runtime/usage error.
 */

#ifndef SLU_TPU_H
#define SLU_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Start the embedded solver runtime (idempotent).  backend may be NULL,
 * "", "cuda" or "gpu" (the card: -1 when there is none; nothing falls
 * back to the CPU), or "cpu".  Any other name is -1. */
int slu_tpu_init(const char* backend);

/* One-shot expert solve: equilibrate + row-permute + order + factor +
 * solve + refine (the pdgssvx pipeline). */
int slu_tpu_solve(int64_t n, int64_t nnz, const int64_t* indptr,
                  const int64_t* indices, const double* values,
                  const double* b, double* x, int64_t nrhs);

/* Factor once, keep a handle (the dLUstruct_t analog held by the
 * runtime); returns 0 and sets *handle on success. */
int slu_tpu_factor(int64_t n, int64_t nnz, const int64_t* indptr,
                   const int64_t* indices, const double* values,
                   int64_t* handle);

/* Re-solve with an existing factorization (Fact=FACTORED tier). */
int slu_tpu_solve_factored(int64_t handle, int64_t n, const double* b,
                           double* x, int64_t nrhs);

/* Release a factorization handle. */
int slu_tpu_free_handle(int64_t handle);

/* ---- full-surface API (the superlu_c2f_dwrap.c:51-327 analog) ---------
 * Option handles carry the reference's superlu_dist_options_t surface.
 * Keys accept reference names ("Fact", "Equil", "ColPerm", "RowPerm",
 * "ReplaceTinyPivot", "IterRefine", "Trans", "DiagInv", "PrintStat",
 * "ParSymbFact" — the distributed-analysis tier of the multi-process
 * driver, parallel/panalysis.py) or
 * native field names (e.g. "relax", "max_supernode", "factor_dtype").
 * Values are strings: enum member names ("METIS_AT_PLUS_A", "NOTRANS",
 * "SamePattern", ...), "YES"/"NO" for flags, or numbers.
 * Errors: -3 bad handle, -5 unknown key/stat, -6 bad value. */

int slu_tpu_options_create(int64_t* opt);
int slu_tpu_options_set(int64_t opt, const char* key, const char* value);
int slu_tpu_options_get(int64_t opt, const char* key, char* buf,
                        int64_t buflen);
int slu_tpu_options_free(int64_t opt);

/* One-shot expert solve under an options handle (0 = defaults), with
 * column-major B/X of leading dimensions ldb/ldx >= n (the reference
 * pdgssvx ldb contract; 0 means ldb = n). */
int slu_tpu_solve_opts(int64_t opt, int64_t n, int64_t nnz,
                       const int64_t* indptr, const int64_t* indices,
                       const double* values, const double* b, int64_t ldb,
                       double* x, int64_t ldx, int64_t nrhs);

/* Factor under an options handle; keeps the options with the handle. */
int slu_tpu_factor_opts(int64_t opt, int64_t n, int64_t nnz,
                        const int64_t* indptr, const int64_t* indices,
                        const double* values, int64_t* handle);

/* Refactor the handle with NEW values on the SAME pattern through the
 * reference reuse tiers: tier 1 = SamePattern, 2 = SamePattern_SameRowPerm
 * (fact_t, superlu_defs.h:489-510). */
int slu_tpu_refactor(int64_t handle, int64_t nnz, const double* values,
                     int64_t tier);

/* Re-solve through a factorization (Fact=FACTORED) under an options
 * handle (0 = the handle's own options); trans/refine ride the options. */
int slu_tpu_solve_factored_opts(int64_t handle, int64_t opt, int64_t n,
                                const double* b, int64_t ldb, double* x,
                                int64_t ldx, int64_t nrhs);

/* Named statistic of a factorization (PStatPrint analog, SRC/util.c:
 * 484-534): per-phase seconds ("FACT", "SOLVE", "REFINE", "EQUIL",
 * "ROWPERM", "COLPERM", "SYMBFACT", "DIST", ...), "FACT_FLOPS",
 * "FACT_GFLOPS", "TINY_PIVOTS", "REFINE_STEPS", "BERR", "LU_BYTES",
 * "TOTAL_BYTES", "NNZ_L", "NNZ_U". */
int slu_tpu_stat_get(int64_t handle, const char* name, double* value);

/* Shut the runtime down.  TERMINAL for the process: CPython extension
 * modules do not survive re-initialization, so any API call after this
 * returns -4.  Only call when done with the solver for good. */
void slu_tpu_finalize(void);

#ifdef __cplusplus
}
#endif

#endif /* SLU_TPU_H */
