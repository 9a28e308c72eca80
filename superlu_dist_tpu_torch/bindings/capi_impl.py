"""Implementation of the slu_tpu C API over the port (slu_tpu.h,
slu_tpu_capi.c beside this file).

The C shim embeds a Python interpreter, imports this module, and calls
these functions with raw pointers (as int64) into the caller's buffers —
the role the reference's handle-based wrapper layer plays for its
Fortran interface (FORTRAN/superlu_c2f_dwrap.c:51-327): a registry of
live factorizations plus option and statistics marshalling.  The port's
counterpart of the JAX package's ``bindings/capi_impl.py``, with the
same registry contract, tiers and statistic names.

Surface map to the reference wrapper:
  opt_create/opt_set/opt_get/opt_free   <-> f_create_options /
      f_set_default_options / set_superlu_options (c2f_dwrap options block)
  factor_opts / refactor                <-> f_pdgssvx with Fact=DOFACT /
      SamePattern / SamePattern_SameRowPerm (fact_t tiers,
      superlu_defs.h:489-510)
  solve_factored_opts                   <-> f_pdgssvx with Fact=FACTORED
      (trans/refine ride the options handle)
  stat_get                              <-> f_PStatPrint-class observability
      (per-phase seconds, flops, tiny pivots, memory; SRC/util.c:484-534)

B/X are column-major (ldb/ldx leading dimensions, n x nrhs) as a Fortran
caller lays them out (the reference pdgssvx's ldb contract).

:func:`init` chooses the device every handle lives on: the card unless
the caller names "cpu"; without a card it fails rather than fall back.
With ``SLU_TPU_METRICS`` on, every factor, refactor and solve adds the
kernel launches it made to ``slu_capi_kernel_launches_total{call=, n=,
kernel=}`` (a separate process's launches, read from the metrics
export).  :func:`shutdown` releases every handle, the solve graphs and
cached executors with them, before the shim finalizes the interpreter.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import math

import numpy as np
import torch

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.drivers.gssvx import analyze, factorize_numeric
from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.sparse.formats import SparseCSR
from superlu_dist_tpu_torch.utils.options import resolve_device

_handles: dict[int, dict] = {}
_options: dict[int, object] = {}
_next = [1]
_device = [None]                 # the torch.device chosen by init()

_BAD_HANDLE = -3
_BAD_KEY = -5
_BAD_VALUE = -6

#: slu_tpu_init's backend names: NULL / "" / "cuda" / "gpu" are the card
_BACKENDS = {"": "cuda", "cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}

# reference-style option names (superlu_dist_options_t fields,
# superlu_defs.h:628-657) -> Options dataclass fields; native field
# names are accepted too
_KEY_ALIAS = {
    "Fact": "fact", "Equil": "equil", "ColPerm": "col_perm",
    "RowPerm": "row_perm", "ReplaceTinyPivot": "replace_tiny_pivot",
    "IterRefine": "iter_refine", "Trans": "trans", "DiagInv": "diag_inv",
    "PrintStat": "print_stat", "ParSymbFact": "par_symb_fact",
}
_ENUM_FIELDS = {
    "fact": slt.Fact, "col_perm": slt.ColPerm, "row_perm": slt.RowPerm,
    "iter_refine": slt.IterRefine, "trans": slt.Trans,
}


def init(backend: str) -> int:
    """Choose the handles' device: "cpu", or the card for "", "cuda" and
    "gpu".  0, or -1 for another name or a card asked for without one
    (the reason printed)."""
    name = _BACKENDS.get((backend or "").strip().lower())
    if name is None:
        print(f"slu_tpu_init: unknown backend {backend!r}; the port runs "
              f"{sorted(k for k in _BACKENDS if k)} (NULL or \"\": the card)")
        return -1
    try:
        dev = resolve_device(name)
    except RuntimeError as e:
        print(f"slu_tpu_init: {e}")
        return -1
    if dev.type == "cuda":
        torch.empty(1, device=dev)       # the CUDA context, now
    _device[0] = dev
    return 0


@contextlib.contextmanager
def _counted(call: str, n: int):
    """Add the kernel launches made inside to the metrics registry
    (``slu_capi_kernel_launches_total{call=, n=, kernel=}``) when it is
    on."""
    m = get_metrics()
    if not m.enabled:
        yield
        return
    before = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        for k, v in kernels.LAUNCHES.items():
            if v != before[k]:
                m.inc("slu_capi_kernel_launches_total", v - before[k],
                      call=call, n=int(n), kernel=k)


def _as(ptr, n, ct):
    return np.ctypeslib.as_array(
        ctypes.cast(int(ptr), ctypes.POINTER(ct)), (int(n),))


def _mat(n, nnz, ip, ix, vp):
    indptr = _as(ip, n + 1, ctypes.c_int64).copy()
    indices = _as(ix, nnz, ctypes.c_int64).copy()
    values = _as(vp, nnz, ctypes.c_double).copy()
    return SparseCSR(n, n, indptr, indices, values)


def _rhs(bp, n, nrhs, ldb=None):
    ldb = n if ldb in (None, 0) else ldb
    if ldb < n:
        return None
    b = _as(bp, ldb * nrhs, ctypes.c_double).copy() \
        .reshape(ldb, nrhs, order="F")[:n]
    return b[:, 0] if nrhs == 1 else b


def _writeback(xp, x, n, nrhs, ldx=None):
    ldx = n if ldx in (None, 0) else ldx
    out = _as(xp, ldx * nrhs, ctypes.c_double).reshape(ldx, nrhs, order="F")
    out[:n] = np.asarray(x).reshape(n, nrhs)


def _opts_for(opt_handle):
    """Options instance for a handle (0 = fresh defaults; None if bad)."""
    if opt_handle == 0:
        return slt.Options()
    return _options.get(opt_handle)


# ---- options registry -------------------------------------------------------

def opt_create():
    h = _next[0]
    _next[0] += 1
    _options[h] = slt.Options()
    return h


def opt_free(h):
    return 0 if _options.pop(h, None) is not None else _BAD_HANDLE


def _coerce(field_type, cur, val):
    """Parse the C caller's string value for an Options field."""
    if field_type is not None:            # enum field
        if val.lstrip("-").isdigit():
            return field_type(int(val))
        for m in field_type:
            if m.name.upper() == val.upper():
                return m
        raise ValueError(val)
    if isinstance(cur, bool):
        u = val.strip().upper()
        if u in ("YES", "TRUE", "1", "ON"):
            return True
        if u in ("NO", "FALSE", "0", "OFF"):
            return False
        raise ValueError(val)
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val                            # str field (factor_dtype, ...)


def opt_set(h, key, val):
    opts = _options.get(h)
    if opts is None:
        return _BAD_HANDLE
    name = _KEY_ALIAS.get(key, key)
    if not hasattr(opts, name):
        return _BAD_KEY
    try:
        setattr(opts, name, _coerce(_ENUM_FIELDS.get(name),
                                    getattr(opts, name), val))
    except (ValueError, TypeError):
        return _BAD_VALUE
    return 0


def opt_get(h, key):
    """Value string, or an int error code (-3 bad handle / -5 bad key —
    the C shim distinguishes PyLong from PyUnicode returns)."""
    opts = _options.get(h)
    if opts is None:
        return _BAD_HANDLE
    name = _KEY_ALIAS.get(key, key)
    if not hasattr(opts, name):
        return _BAD_KEY
    v = getattr(opts, name)
    return v.name if hasattr(v, "name") else \
        ("YES" if v is True else "NO" if v is False else str(v))


# ---- solve / factor ---------------------------------------------------------

def solve_opts(opt, n, nnz, ip, ix, vp, bp, ldb, xp, ldx, nrhs):
    opts = _opts_for(opt)
    b = _rhs(bp, n, nrhs, ldb)
    if opts is None or b is None or (ldx not in (None, 0) and ldx < n):
        return _BAD_HANDLE if opts is None else _BAD_VALUE
    a = _mat(n, nnz, ip, ix, vp)
    with _counted("solve_opts", n):
        x, lu, stats, info = slt.gssvx(opts, a, b, device=_device[0])
    if info == 0:
        _writeback(xp, x, n, nrhs, ldx)
    return int(info)


def factor_opts(opt, n, nnz, ip, ix, vp):
    opts = _opts_for(opt)
    if opts is None:
        return (_BAD_HANDLE, 0)
    a = _mat(n, nnz, ip, ix, vp)
    # factor WITHOUT a solve (the analyze + factorize_numeric split): no
    # wasted zero-RHS triangular solve, and no solve graph captured
    # before a solve is requested
    with _counted("factor_opts", n):
        lu, bvals, stats = analyze(opts, a, device=_device[0])
        info = factorize_numeric(lu, bvals, stats)
    if info != 0:
        return (int(info), 0)
    h = _next[0]
    _next[0] += 1
    # snapshot the options: later opt_set calls on the caller's options
    # handle must not retroactively change this factorization's stored
    # solve/refactor semantics ("the handle's own options", slu_tpu.h)
    _handles[h] = {"a": a, "lu": lu, "stats": stats,
                   "opts": dataclasses.replace(opts)}
    return (0, h)


def refactor(h, nnz, vp, tier):
    """Refactor with NEW numeric values on the SAME pattern, through the
    reference's reuse tiers: tier 1 = SamePattern (column order +
    detected-equal row perms reuse the symbolic/plan), tier 2 =
    SamePattern_SameRowPerm (scalings + row perm + symbolic + plan all
    reused; numeric factorization only)."""
    ent = _handles.get(h)
    if ent is None:
        return _BAD_HANDLE
    a0 = ent["a"]
    if nnz != a0.nnz:
        return _BAD_VALUE
    fact = {1: slt.Fact.SamePattern,
            2: slt.Fact.SamePattern_SameRowPerm}.get(tier)
    if fact is None:
        return _BAD_VALUE
    a = SparseCSR(a0.n_rows, a0.n_cols, a0.indptr, a0.indices,
                  _as(vp, nnz, ctypes.c_double).copy())
    opts = dataclasses.replace(ent["opts"], fact=fact)
    with _counted("refactor", a.n_rows):
        lu, bvals, stats = analyze(opts, a, device=ent["lu"].device,
                                   lu=ent["lu"], stats=ent["stats"])
        info = factorize_numeric(lu, bvals, stats)
    if info != 0:
        return int(info)
    ent.update(a=a, lu=lu, stats=stats)
    return 0


def solve_factored_opts(h, opt, n, bp, ldb, xp, ldx, nrhs):
    ent = _handles.get(h)
    if ent is None:
        return _BAD_HANDLE
    opts = ent["opts"] if opt == 0 else _opts_for(opt)
    b = _rhs(bp, n, nrhs, ldb)
    if opts is None or b is None or (ldx not in (None, 0) and ldx < n):
        return _BAD_HANDLE if opts is None else _BAD_VALUE
    opts = dataclasses.replace(opts, fact=slt.Fact.FACTORED)
    with _counted("solve_factored_opts", n):
        x, lu, stats, info = slt.gssvx(opts, ent["a"], b, lu=ent["lu"],
                                       stats=ent["stats"])
    if info == 0:
        _writeback(xp, x, n, nrhs, ldx)
    return int(info)


def free(h):
    return 0 if _handles.pop(h, None) is not None else _BAD_HANDLE


# ---- statistics (PStatPrint-class observability) ----------------------------

def stat_get(h, name):
    """A named statistic of a factorization handle as float, or an int
    error code (-3 bad handle; unknown names yield NaN, which the C shim
    maps to -5)."""
    ent = _handles.get(h)
    if ent is None:
        return _BAD_HANDLE
    st = ent["stats"]
    lu = ent["lu"]
    name_u = name.upper()
    if name_u in st.utime:
        return float(st.utime[name_u])
    special = {
        "TINY_PIVOTS": float(st.tiny_pivots),
        "REFINE_STEPS": float(st.refine_steps),
        "FACT_FLOPS": float(st.ops.get("FACT", 0.0)),
        "FACT_GFLOPS": float(st.gflops("FACT")),
        "LU_BYTES": float(st.for_lu_bytes),
        "TOTAL_BYTES": float(st.peak_memory_bytes),
        # the delivered backward error of the last solve (the JAX
        # package's max over the refinement history is its first step's)
        "BERR": (float(st.solve_report.berr) if lu.berrs
                 and st.solve_report is not None
                 and st.solve_report.berr is not None else 0.0),
        "NNZ_L": float(lu.sf.nnz_L) if lu.sf is not None else math.nan,
        "NNZ_U": float(lu.sf.nnz_U) if lu.sf is not None else math.nan,
    }
    return special.get(name_u, math.nan)


# ---- legacy narrow surface (kept ABI-stable) --------------------------------

def solve(n, nnz, ip, ix, vp, bp, xp, nrhs):
    return solve_opts(0, n, nnz, ip, ix, vp, bp, n, xp, n, nrhs)


def factor(n, nnz, ip, ix, vp):
    return factor_opts(0, n, nnz, ip, ix, vp)


def solve_factored(h, n, bp, xp, nrhs):
    return solve_factored_opts(h, 0, n, bp, n, xp, n, nrhs)


# ---- finalize ---------------------------------------------------------------

def shutdown() -> int:
    """Release the runtime before the interpreter finalizes: the card
    synchronized, every handle and options struct freed (with them the
    solve graphs, cached executors and device maps their plans hold),
    garbage collected, the allocator's cache emptied and the metrics
    export written.  0."""
    dev = _device[0]
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _handles.clear()
    _options.clear()
    gc.collect()
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    get_metrics().dump_now()
    return 0
