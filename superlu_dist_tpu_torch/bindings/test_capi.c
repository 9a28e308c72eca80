/* Self-checking C client of the slu_tpu API over the port (the
 * counterpart of the JAX package's bindings/test_capi.c, and an analog of
 * the reference's EXAMPLE/f_5x5-style binding smoke tests).
 *
 *   test_capi BACKEND
 *     a diagonally-dominant tridiagonal system solved through the one-shot
 *     path, the factor/solve-factored handle path and the full surface
 *     (options, TRANS, strided nrhs 2, a tier-1 refactor, statistics),
 *     each against the fabricated solution;
 *   test_capi BACKEND NX OUT [NX_REFACTOR [GOFILE]]
 *     the 7-point poisson3d(NX) built here in the port's gallery order
 *     (models/gallery.poisson3d): DOFACT through slu_tpu_factor_opts,
 *     FACTORED at nrhs 1 and at nrhs 4 with ldb > n, the statistics FACT,
 *     SOLVE, BERR, TINY_PIVOTS and NNZ_L, then a tier-2 refactor
 *     (SamePattern_SameRowPerm) on the values times 1.5 and a solve: of
 *     the same handle, or of a handle of poisson3d(NX_REFACTOR) when that
 *     differs.  Writes n, b and x of the nrhs-1 solve (int64, then
 *     doubles) to OUT and prints the seconds of each step.  With GOFILE
 *     it starts the runtime, then waits for that file to exist before
 *     its first factorization (exit 4 if its parent exits first).
 *
 * BACKEND is slu_tpu_init's argument ("default" passes NULL: the card).
 * Exit code 0 = PASS; 3 when slu_tpu_init fails. */

#include "slu_tpu.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

static int init(const char* backend) {
  int rc = slu_tpu_init(strcmp(backend, "default") == 0 ? NULL : backend);
  if (rc != 0) printf("init rc=%d FAIL\n", rc);
  return rc;
}

static int tridiagonal(const char* backend) {
  const int64_t n = 50;
  int64_t* indptr = malloc((n + 1) * sizeof(int64_t));
  int64_t* indices = malloc(3 * n * sizeof(int64_t));
  double* values = malloc(3 * n * sizeof(double));
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i > 0) { indices[nnz] = i - 1; values[nnz++] = -1.0; }
    indices[nnz] = i; values[nnz++] = 4.0;
    if (i < n - 1) { indices[nnz] = i + 1; values[nnz++] = -1.0; }
    indptr[i + 1] = nnz;
  }
  double* xt = malloc(n * sizeof(double));
  double* b = malloc(n * sizeof(double));
  double* x = malloc(n * sizeof(double));
  for (int64_t i = 0; i < n; ++i) xt[i] = 1.0 + 0.01 * (double)i;
  for (int64_t i = 0; i < n; ++i) {
    b[i] = 4.0 * xt[i];
    if (i > 0) b[i] -= xt[i - 1];
    if (i < n - 1) b[i] -= xt[i + 1];
  }

  if (init(backend) != 0) return 3;


  int info = slu_tpu_solve(n, nnz, indptr, indices, values, b, x, 1);
  if (info != 0) { printf("solve info=%d FAIL\n", info); return 1; }
  double err = 0.0;
  for (int64_t i = 0; i < n; ++i) err = fmax(err, fabs(x[i] - xt[i]));
  if (err > 1e-10) { printf("one-shot err=%g FAIL\n", err); return 1; }

  int64_t h = 0;
  info = slu_tpu_factor(n, nnz, indptr, indices, values, &h);
  if (info != 0) { printf("factor info=%d FAIL\n", info); return 1; }
  for (int64_t i = 0; i < n; ++i) b[i] *= 2.0;   /* new rhs, same A */
  info = slu_tpu_solve_factored(h, n, b, x, 1);
  if (info != 0) { printf("refactored solve info=%d FAIL\n", info); return 1; }
  err = 0.0;
  for (int64_t i = 0; i < n; ++i) err = fmax(err, fabs(x[i] - 2.0 * xt[i]));
  if (err > 1e-10) { printf("factored err=%g FAIL\n", err); return 1; }
  if (slu_tpu_free_handle(h) != 0) { printf("free FAIL\n"); return 1; }
  if (slu_tpu_free_handle(h) != -3) { printf("double-free FAIL\n"); return 1; }

  /* ---- full-surface: options + trans + strided nrhs + refactor + stats */
  int64_t opt = 0;
  if (slu_tpu_options_create(&opt) != 0) { printf("optc FAIL\n"); return 1; }
  if (slu_tpu_options_set(opt, "ColPerm", "MMD_AT_PLUS_A") != 0 ||
      slu_tpu_options_set(opt, "Trans", "TRANS") != 0 ||
      slu_tpu_options_set(opt, "IterRefine", "SLU_DOUBLE") != 0) {
    printf("optset FAIL\n"); return 1;
  }
  if (slu_tpu_options_set(opt, "NoSuchKey", "1") != -5) {
    printf("optset bad-key FAIL\n"); return 1;
  }
  char buf[32];
  if (slu_tpu_options_get(opt, "Trans", buf, sizeof buf) != 0 ||
      buf[0] != 'T') { printf("optget FAIL\n"); return 1; }

  /* A is symmetric here, so the TRANS solve must reproduce xt; use a
   * strided (ldb=n+3) 2-RHS layout to exercise the ld contract */
  const int64_t ld = n + 3;
  double* b2 = calloc(ld * 2, sizeof(double));
  double* x2 = calloc(ld * 2, sizeof(double));
  for (int64_t i = 0; i < n; ++i) {      /* b columns: b, 3b (b was 2x) */
    b2[i] = b[i] / 2.0;
    b2[ld + i] = 3.0 * b[i] / 2.0;
  }
  int64_t h2 = 0;
  info = slu_tpu_factor_opts(opt, n, nnz, indptr, indices, values, &h2);
  if (info != 0) { printf("factor_opts info=%d FAIL\n", info); return 1; }
  info = slu_tpu_solve_factored_opts(h2, opt, n, b2, ld, x2, ld, 2);
  if (info != 0) { printf("sfo info=%d FAIL\n", info); return 1; }
  err = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    err = fmax(err, fabs(x2[i] - xt[i]));
    err = fmax(err, fabs(x2[ld + i] - 3.0 * xt[i]));
  }
  if (err > 1e-10) { printf("strided trans err=%g FAIL\n", err); return 1; }

  /* refactor with scaled values (SamePattern tier), re-solve */
  double* v2 = malloc(nnz * sizeof(double));
  for (int64_t k = 0; k < nnz; ++k) v2[k] = 4.0 * values[k];
  if (slu_tpu_refactor(h2, nnz, v2, 1) != 0) {
    printf("refactor FAIL\n"); return 1;
  }
  info = slu_tpu_solve_factored_opts(h2, opt, n, b2, ld, x2, ld, 2);
  if (info != 0) { printf("post-refactor info=%d FAIL\n", info); return 1; }
  err = 0.0;
  for (int64_t i = 0; i < n; ++i)
    err = fmax(err, fabs(x2[i] - 0.25 * xt[i]));
  if (err > 1e-10) { printf("refactor err=%g FAIL\n", err); return 1; }

  double sv = -1.0;
  if (slu_tpu_stat_get(h2, "FACT", &sv) != 0 || sv < 0.0) {
    printf("stat FACT FAIL\n"); return 1;
  }
  if (slu_tpu_stat_get(h2, "NNZ_L", &sv) != 0 || sv < (double)n) {
    printf("stat NNZ_L FAIL\n"); return 1;
  }
  if (slu_tpu_stat_get(h2, "NoSuchStat", &sv) != -5) {
    printf("stat bad-name FAIL\n"); return 1;
  }
  if (slu_tpu_free_handle(h2) != 0 || slu_tpu_options_free(opt) != 0) {
    printf("free2 FAIL\n"); return 1;
  }

  printf("C API PASS (err one-shot + factored + full-surface <= 1e-10)\n");
  slu_tpu_finalize();
  return 0;
}

/* CSR of the 7-point Laplacian on an nx^3 grid, row i = (x*nx + y)*nx + z,
 * columns increasing (6 on the diagonal, -1 for each grid neighbour): the
 * port's gallery.poisson3d(nx), entry for entry. */
static void poisson3d(int64_t nx, int64_t** indptr, int64_t** indices,
                      double** values, int64_t* n_out, int64_t* nnz_out) {
  const int64_t n = nx * nx * nx;
  int64_t* ip = malloc((n + 1) * sizeof(int64_t));
  int64_t* ix = malloc(7 * n * sizeof(int64_t));
  double* v = malloc(7 * n * sizeof(double));
  int64_t nnz = 0;
  ip[0] = 0;
  for (int64_t x = 0; x < nx; ++x)
    for (int64_t y = 0; y < nx; ++y)
      for (int64_t z = 0; z < nx; ++z) {
        int64_t i = (x * nx + y) * nx + z;
        if (x > 0) { ix[nnz] = i - nx * nx; v[nnz++] = -1.0; }
        if (y > 0) { ix[nnz] = i - nx; v[nnz++] = -1.0; }
        if (z > 0) { ix[nnz] = i - 1; v[nnz++] = -1.0; }
        ix[nnz] = i; v[nnz++] = 6.0;
        if (z < nx - 1) { ix[nnz] = i + 1; v[nnz++] = -1.0; }
        if (y < nx - 1) { ix[nnz] = i + nx; v[nnz++] = -1.0; }
        if (x < nx - 1) { ix[nnz] = i + nx * nx; v[nnz++] = -1.0; }
        ip[i + 1] = nnz;
      }
  *indptr = ip; *indices = ix; *values = v; *n_out = n; *nnz_out = nnz;
}

static void matvec(int64_t n, const int64_t* ip, const int64_t* ix,
                   const double* v, const double* x, double* y) {
  for (int64_t i = 0; i < n; ++i) {
    double s = 0.0;
    for (int64_t k = ip[i]; k < ip[i + 1]; ++k) s += v[k] * x[ix[k]];
    y[i] = s;
  }
}

static double xtrue(int64_t i) { return 1.0 + 0.01 * (double)(i % 101); }

static int poisson3d_mode(const char* backend, int64_t nx, const char* out,
                          int64_t nx_ref, const char* gofile) {
  int64_t *ip, *ix, n, nnz;
  double* v;
  poisson3d(nx, &ip, &ix, &v, &n, &nnz);
  double* xt = malloc(n * sizeof(double));
  double* b = malloc(n * sizeof(double));
  double* x = malloc(n * sizeof(double));
  for (int64_t i = 0; i < n; ++i) xt[i] = xtrue(i);
  matvec(n, ip, ix, v, xt, b);

  pid_t parent = getppid();
  double t0 = now();
  if (init(backend) != 0) return 3;
  double t_init = now() - t0;
  if (gofile)
    while (access(gofile, F_OK) != 0) {
      if (getppid() != parent) { printf("parent gone FAIL\n"); return 4; }
      usleep(20000);
    }

  /* DOFACT: factor without a solve */
  int64_t opt = 0, h = 0;
  if (slu_tpu_options_create(&opt) != 0) { printf("optc FAIL\n"); return 1; }
  t0 = now();
  int info = slu_tpu_factor_opts(opt, n, nnz, ip, ix, v, &h);
  double t_dofact = now() - t0;
  if (info != 0) { printf("factor_opts info=%d FAIL\n", info); return 1; }

  /* FACTORED, nrhs 1 */
  t0 = now();
  info = slu_tpu_solve_factored_opts(h, 0, n, b, n, x, n, 1);
  double t_solve1 = now() - t0;
  if (info != 0) { printf("solve1 info=%d FAIL\n", info); return 1; }
  double err = 0.0;
  for (int64_t i = 0; i < n; ++i) err = fmax(err, fabs(x[i] - xt[i]));
  if (err > 1e-9) { printf("solve1 err=%g FAIL\n", err); return 1; }

  /* FACTORED, nrhs 4, ldb = ldx = n + 5: column k is (k+1) b */
  const int64_t ld = n + 5;
  double* b4 = calloc(ld * 4, sizeof(double));
  double* x4 = calloc(ld * 4, sizeof(double));
  for (int64_t k = 0; k < 4; ++k)
    for (int64_t i = 0; i < n; ++i) b4[k * ld + i] = (double)(k + 1) * b[i];
  t0 = now();
  info = slu_tpu_solve_factored_opts(h, 0, n, b4, ld, x4, ld, 4);
  double t_solve4 = now() - t0;
  if (info != 0) { printf("solve4 info=%d FAIL\n", info); return 1; }
  double err4 = 0.0;
  for (int64_t k = 0; k < 4; ++k)
    for (int64_t i = 0; i < n; ++i)
      err4 = fmax(err4, fabs(x4[k * ld + i] - (double)(k + 1) * xt[i]));
  if (err4 > 4e-9) { printf("solve4 err=%g FAIL\n", err4); return 1; }

  const char* names[] = {"FACT", "SOLVE", "BERR", "TINY_PIVOTS", "NNZ_L"};
  double st[5];
  for (int s = 0; s < 5; ++s)
    if (slu_tpu_stat_get(h, names[s], &st[s]) != 0) {
      printf("stat %s FAIL\n", names[s]); return 1;
    }

  /* tier-2 refactor on the values times 1.5: b times 1.5 gives xt again */
  int64_t *ip2 = ip, *ix2 = ix, n2 = n, nnz2 = nnz, h2 = h;
  double* v2 = v;
  double t_factor2 = 0.0;
  if (nx_ref != nx) {
    poisson3d(nx_ref, &ip2, &ix2, &v2, &n2, &nnz2);
    t0 = now();
    info = slu_tpu_factor_opts(opt, n2, nnz2, ip2, ix2, v2, &h2);
    t_factor2 = now() - t0;
    if (info != 0) { printf("factor_opts(%lld) info=%d FAIL\n",
                            (long long)nx_ref, info); return 1; }
  }
  double* vs = malloc(nnz2 * sizeof(double));
  for (int64_t k = 0; k < nnz2; ++k) vs[k] = 1.5 * v2[k];
  double* xt2 = malloc(n2 * sizeof(double));
  double* bb = malloc(n2 * sizeof(double));
  double* xx = malloc(n2 * sizeof(double));
  for (int64_t i = 0; i < n2; ++i) xt2[i] = xtrue(i);
  matvec(n2, ip2, ix2, vs, xt2, bb);
  t0 = now();
  info = slu_tpu_refactor(h2, nnz2, vs, 2);
  double t_refactor = now() - t0;
  if (info != 0) { printf("refactor info=%d FAIL\n", info); return 1; }
  t0 = now();
  info = slu_tpu_solve_factored_opts(h2, 0, n2, bb, n2, xx, n2, 1);
  double t_refsolve = now() - t0;
  if (info != 0) { printf("refactor solve info=%d FAIL\n", info); return 1; }
  double err2 = 0.0;
  for (int64_t i = 0; i < n2; ++i) err2 = fmax(err2, fabs(xx[i] - xt2[i]));
  if (err2 > 1e-9) { printf("refactor err=%g FAIL\n", err2); return 1; }

  if ((h2 != h && slu_tpu_free_handle(h2) != 0) ||
      slu_tpu_free_handle(h) != 0 || slu_tpu_options_free(opt) != 0) {
    printf("free FAIL\n"); return 1;
  }
  FILE* f = fopen(out, "wb");
  if (!f || fwrite(&n, sizeof n, 1, f) != 1 ||
      fwrite(b, sizeof(double), n, f) != (size_t)n ||
      fwrite(x, sizeof(double), n, f) != (size_t)n || fclose(f) != 0) {
    printf("write %s FAIL\n", out); return 1;
  }
  t0 = now();
  slu_tpu_finalize();
  double t_final = now() - t0;
  printf("CAPI_STATS n=%lld nnz=%lld fact=%.6f solve=%.6f berr=%.6e "
         "tiny_pivots=%.0f nnz_l=%.0f err1=%.3e err4=%.3e err_refactor=%.3e\n",
         (long long)n, (long long)nnz, st[0], st[1], st[2], st[3], st[4],
         err, err4, err2);
  printf("CAPI_TIMES init=%.6f dofact=%.6f solve1=%.6f solve4=%.6f "
         "factor_refactor_handle=%.6f refactor=%.6f refactor_solve=%.6f "
         "finalize=%.6f\n", t_init, t_dofact, t_solve1, t_solve4, t_factor2,
         t_refactor, t_refsolve, t_final);
  printf("C API poisson3d(%lld) PASS\n", (long long)nx);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 2) return tridiagonal(argv[1]);
  if (argc >= 4 && argc <= 6)
    return poisson3d_mode(argv[1], atoll(argv[2]), argv[3],
                          argc >= 5 ? atoll(argv[4]) : atoll(argv[2]),
                          argc == 6 ? argv[5] : NULL);
  fprintf(stderr, "usage: test_capi BACKEND [NX OUT [NX_REFACTOR "
                  "[GOFILE]]]\n");
  return 2;
}
