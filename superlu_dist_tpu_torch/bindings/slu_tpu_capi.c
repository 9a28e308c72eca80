/*
 * Embedded-Python implementation of the slu_tpu C API over the port
 * (see slu_tpu.h), the counterpart of the JAX package's shim.
 *
 * Architecture: like the reference's Fortran wrapper layer
 * (FORTRAN/superlu_c2f_dwrap.c:51-327), this file is a thin marshalling
 * shim over the real solver: there the C library, here the Python package
 * driving PyTorch and its CUDA kernels.  The interpreter is initialized
 * once; init imports superlu_dist_tpu_torch.bindings.capi_impl, which
 * chooses the device (the card unless the caller names "cpu"), views the
 * caller's buffers through ctypes (zero-copy in, one copy out into the
 * caller's x) and keeps handle registries of live factorizations and
 * option structs (the reference's factors[] handle array).
 */

#include "slu_tpu.h"

#include <Python.h>
#include <stdio.h>
#include <string.h>

static int g_ready = 0;
static int g_finalized = 0;

static const char* kImpl = "superlu_dist_tpu_torch.bindings.capi_impl";

int slu_tpu_init(const char* backend) {
  if (g_ready) return 0;
  if (g_finalized) return -4;   /* CPython extension modules (numpy, torch)
                                 * do not survive re-initialization:
                                 * finalize is terminal for this process */
  if (!Py_IsInitialized()) Py_InitializeEx(0);
  PyObject* mod = PyImport_ImportModule(kImpl);
  if (!mod) {
    PyErr_Print();
    return -1;
  }
  PyObject* res = PyObject_CallMethod(mod, "init", "(s)",
                                      backend ? backend : "");
  Py_DECREF(mod);
  if (!res) {
    PyErr_Print();
    return -1;
  }
  long rc = PyLong_AsLong(res);
  Py_DECREF(res);
  if (rc != 0) return -1;       /* unknown backend, or no card */
  g_ready = 1;
  return 0;
}

static int ensure_ready(void) {
  if (g_ready) return 0;
  int rc = slu_tpu_init(NULL);
  return rc == 0 ? 0 : (rc < 0 ? rc : -2);
}

static PyObject* get_fn(const char* name) {
  PyObject* mod = PyImport_ImportModule(kImpl);
  if (!mod) {
    PyErr_Print();
    return NULL;
  }
  PyObject* fn = PyObject_GetAttrString(mod, name);
  Py_DECREF(mod);
  return fn;
}

/* Call an impl function returning a PyObject*, or NULL on failure. */
static PyObject* call_obj(const char* name, const char* fmt, va_list ap) {
  PyObject* fn = get_fn(name);
  if (!fn) return NULL;
  PyObject* args = Py_VaBuildValue(fmt, ap);
  if (!args) {
    Py_DECREF(fn);
    return NULL;
  }
  PyObject* res = PyObject_CallObject(fn, args);
  Py_DECREF(args);
  Py_DECREF(fn);
  if (!res) PyErr_Print();
  return res;
}

static int call_int(const char* name, const char* fmt, ...) {
  int rc = ensure_ready();
  if (rc != 0) return rc;
  va_list ap;
  va_start(ap, fmt);
  PyObject* res = call_obj(name, fmt, ap);
  va_end(ap);
  if (!res) return -2;
  long v = PyLong_AsLong(res);
  Py_DECREF(res);
  return (int)v;
}

/* int status + int64 out-handle, for (info, handle) tuple returns */
static int call_int_handle(const char* name, int64_t* out, const char* fmt,
                           ...) {
  int rc = ensure_ready();
  if (rc != 0) return rc;
  va_list ap;
  va_start(ap, fmt);
  PyObject* res = call_obj(name, fmt, ap);
  va_end(ap);
  if (!res) return -2;
  int info = -2;
  long long h = 0;
  if (PyArg_ParseTuple(res, "iL", &info, &h)) *out = (int64_t)h;
  Py_DECREF(res);
  return info;
}

/* ---- narrow legacy surface (kept ABI-stable) --------------------------- */

int slu_tpu_solve(int64_t n, int64_t nnz, const int64_t* indptr,
                  const int64_t* indices, const double* values,
                  const double* b, double* x, int64_t nrhs) {
  return call_int("solve", "(LLLLLLLL)", (long long)n, (long long)nnz,
                  (long long)(intptr_t)indptr, (long long)(intptr_t)indices,
                  (long long)(intptr_t)values, (long long)(intptr_t)b,
                  (long long)(intptr_t)x, (long long)nrhs);
}

int slu_tpu_factor(int64_t n, int64_t nnz, const int64_t* indptr,
                   const int64_t* indices, const double* values,
                   int64_t* handle) {
  return call_int_handle("factor", handle, "(LLLLL)", (long long)n,
                         (long long)nnz, (long long)(intptr_t)indptr,
                         (long long)(intptr_t)indices,
                         (long long)(intptr_t)values);
}

int slu_tpu_solve_factored(int64_t handle, int64_t n, const double* b,
                           double* x, int64_t nrhs) {
  return call_int("solve_factored", "(LLLLL)", (long long)handle,
                  (long long)n, (long long)(intptr_t)b,
                  (long long)(intptr_t)x, (long long)nrhs);
}

int slu_tpu_free_handle(int64_t handle) {
  return call_int("free", "(L)", (long long)handle);
}

/* ---- options registry (superlu_c2f_dwrap options block analog) ---------- */

int slu_tpu_options_create(int64_t* opt) {
  int rc = ensure_ready();
  if (rc != 0) return rc;
  int h = call_int("opt_create", "()");
  if (h <= 0) return h < 0 ? h : -2;
  *opt = h;
  return 0;
}

int slu_tpu_options_set(int64_t opt, const char* key, const char* value) {
  return call_int("opt_set", "(Lss)", (long long)opt, key, value);
}

int slu_tpu_options_get(int64_t opt, const char* key, char* buf,
                        int64_t buflen) {
  int rc = ensure_ready();
  if (rc != 0) return rc;
  PyObject* fn = get_fn("opt_get");
  if (!fn) return -2;
  PyObject* res = PyObject_CallFunction(fn, "(Ls)", (long long)opt, key);
  Py_DECREF(fn);
  if (!res) {
    PyErr_Print();
    return -2;
  }
  if (PyLong_Check(res)) {       /* int error code: -3 bad handle,
                                  * -5 unknown key */
    int rc2 = (int)PyLong_AsLong(res);
    Py_DECREF(res);
    return rc2;
  }
  const char* s = PyUnicode_AsUTF8(res);
  if (!s || (int64_t)strlen(s) + 1 > buflen) {
    Py_DECREF(res);
    return -6;
  }
  strcpy(buf, s);
  Py_DECREF(res);
  return 0;
}

int slu_tpu_options_free(int64_t opt) {
  return call_int("opt_free", "(L)", (long long)opt);
}

/* ---- full-surface solve/factor ------------------------------------------ */

int slu_tpu_solve_opts(int64_t opt, int64_t n, int64_t nnz,
                       const int64_t* indptr, const int64_t* indices,
                       const double* values, const double* b, int64_t ldb,
                       double* x, int64_t ldx, int64_t nrhs) {
  return call_int("solve_opts", "(LLLLLLLLLLL)", (long long)opt,
                  (long long)n, (long long)nnz, (long long)(intptr_t)indptr,
                  (long long)(intptr_t)indices, (long long)(intptr_t)values,
                  (long long)(intptr_t)b, (long long)ldb,
                  (long long)(intptr_t)x, (long long)ldx, (long long)nrhs);
}

int slu_tpu_factor_opts(int64_t opt, int64_t n, int64_t nnz,
                        const int64_t* indptr, const int64_t* indices,
                        const double* values, int64_t* handle) {
  return call_int_handle("factor_opts", handle, "(LLLLLL)", (long long)opt,
                         (long long)n, (long long)nnz,
                         (long long)(intptr_t)indptr,
                         (long long)(intptr_t)indices,
                         (long long)(intptr_t)values);
}

int slu_tpu_refactor(int64_t handle, int64_t nnz, const double* values,
                     int64_t tier) {
  return call_int("refactor", "(LLLL)", (long long)handle, (long long)nnz,
                  (long long)(intptr_t)values, (long long)tier);
}

int slu_tpu_solve_factored_opts(int64_t handle, int64_t opt, int64_t n,
                                const double* b, int64_t ldb, double* x,
                                int64_t ldx, int64_t nrhs) {
  return call_int("solve_factored_opts", "(LLLLLLLL)", (long long)handle,
                  (long long)opt, (long long)n, (long long)(intptr_t)b,
                  (long long)ldb, (long long)(intptr_t)x, (long long)ldx,
                  (long long)nrhs);
}

/* ---- statistics (PStatPrint-class observability, SRC/util.c:484-534) ---- */

int slu_tpu_stat_get(int64_t handle, const char* name, double* value) {
  int rc = ensure_ready();
  if (rc != 0) return rc;
  PyObject* fn = get_fn("stat_get");
  if (!fn) return -2;
  PyObject* res = PyObject_CallFunction(fn, "(Ls)", (long long)handle, name);
  Py_DECREF(fn);
  if (!res) {
    PyErr_Print();
    return -2;
  }
  if (PyLong_Check(res)) {       /* int error code: -3 bad handle */
    int rc2 = (int)PyLong_AsLong(res);
    Py_DECREF(res);
    return rc2;
  }
  double v = PyFloat_AsDouble(res);
  Py_DECREF(res);
  if (v != v) return -5;         /* NaN: unknown stat name */
  *value = v;
  return 0;
}

void slu_tpu_finalize(void) {
  if (g_ready && Py_IsInitialized()) {
    /* release handles, solve graphs and cached executors, and
     * synchronize the card, while the interpreter still runs */
    PyObject* fn = get_fn("shutdown");
    PyObject* res = fn ? PyObject_CallObject(fn, NULL) : NULL;
    if (!res) PyErr_Print();
    Py_XDECREF(res);
    Py_XDECREF(fn);
  }
  if (Py_IsInitialized()) Py_FinalizeEx();
  g_ready = 0;
  g_finalized = 1;   /* terminal: further init/solve calls return -4 */
}
