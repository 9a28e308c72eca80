"""ctypes seam to the native host-analysis library (``slu_host.cpp``).

The reference's host analysis is C (SRC/etree.c, symbfact.c,
mc64ad_dist.c, get_perm_c.c); the port's is the C++ of ``slu_host.cpp``,
the same source as the JAX package's library, so both packages analyse a
matrix to the same bits.  The same library holds the shared-memory tree
collectives of the distributed driver (``slu_tree_*``, used by
``parallel/treecomm.py``; not counted in ``CALLS``).  It is compiled at
first use with ``g++ -O3 -std=c++17 -shared -fPIC -pthread ... -lrt`` into
``build/torch_host/<hash of source, compiler and flags>/libslu_host.so``
at the root of the checkout: the build holds a file lock, so concurrent
first uses (test workers, a script beside them) build once, and the
library is written under a per-process name and renamed into place.

Nothing falls back: a failed build or load raises ``RuntimeError`` with the
compiler's output.  The Python twins in ``rowperm/``, ``ordering/``,
``symbolic/`` and ``numeric/plan.py`` run only when the caller asks for
them (``Options(native=False)``).  Each entry point adds one to
``CALLS[name]`` where it calls into the library, so a run can show that it
went through it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from superlu_dist_tpu_torch.obs.compilestats import record_build

SRC = Path(__file__).resolve().with_name("slu_host.cpp")
#: build outputs, keyed by a hash of the source, compiler and flags (kept
#: out of git)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_host"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: the tree collectives' shm_open lives in librt on glibc < 2.34 (a stub
#: on newer glibc, so linking it always is safe)
LD_LIBS = ("-lrt",)
LIB_NAME = "libslu_host.so"

#: calls into the library since the last reset, per entry point
CALLS = {name: 0 for name in (
    "etree", "postorder", "symbolic", "amalgamate", "positions", "mc64",
    "awpm", "mmd", "colamd", "ata_pattern", "mlnd")}

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)
_i64, _f64 = ctypes.c_int64, ctypes.c_double

#: (restype, argtypes) of every entry point the seam calls
_SIGNATURES = {
    "slu_etree": (None, [_i64, _I64, _I64, _I64]),
    "slu_postorder": (None, [_i64, _I64, _I64]),
    "slu_symbolic_mt": (_i64, [_i64, _I64, _I64, _I64, _i64, _i64, _i64,
                               _I64, _I64, _I64, _I64, _I64,
                               ctypes.POINTER(_I64)]),
    "slu_free_i64": (None, [_I64]),
    "slu_amalgamate": (_i64, [_i64, _i64, _I64, _I64, _I64, _f64, _i64,
                              _i64, _f64, _I64, _I64, _I64, _I64, _I64,
                              ctypes.POINTER(_I64)]),
    "slu_positions": (None, [_i64, _I64, _I64, _I64, _I64, _I64, _I64,
                             _I64, _I64]),
    "slu_mc64": (ctypes.c_int, [_i64, _I64, _I64, _F64, _I64, _F64, _F64]),
    "slu_awpm": (ctypes.c_int, [_i64, _I64, _I64, _F64, _I64]),
    "slu_mmd": (None, [_i64, _I64, _I64, _I64]),
    "slu_colamd": (None, [_i64, _i64, _I64, _I64, _I64]),
    "slu_ata_pattern": (_i64, [_i64, _i64, _I64, _I64, _i64, _I64,
                               ctypes.POINTER(_I64)]),
    "slu_mlnd_mt": (None, [_i64, _I64, _I64, _i64, ctypes.c_uint64, _i64,
                           _I64]),
    # the tree collectives (parallel/treecomm.py): the timed legs return
    # 0, or 1 + the rank waited on at the timeout (1 + n_ranks: an
    # unidentified child); post / peek are the wait-free agreement board
    "slu_tree_attach": (ctypes.c_void_p, [ctypes.c_char_p, _i64, _i64, _i64,
                                          _i64]),
    "slu_tree_attach_shared": (ctypes.c_void_p, [ctypes.c_void_p, _i64]),
    "slu_tree_detach": (None, [ctypes.c_void_p, ctypes.c_char_p, _i64]),
    "slu_tree_bcast": (None, [ctypes.c_void_p, _i64, _F64, _i64]),
    "slu_tree_reduce_sum": (None, [ctypes.c_void_p, _i64, _F64, _i64]),
    "slu_tree_bcast_tw": (_i64, [ctypes.c_void_p, _i64, _F64, _i64, _f64]),
    "slu_tree_reduce_sum_tw": (_i64, [ctypes.c_void_p, _i64, _F64, _i64,
                                      _f64]),
    "slu_tree_set_pid": (None, [ctypes.c_void_p, _i64]),
    "slu_tree_get_pid": (_i64, [ctypes.c_void_p, _i64]),
    "slu_tree_heartbeat": (None, [ctypes.c_void_p]),
    "slu_tree_get_heartbeat": (_i64, [ctypes.c_void_p, _i64]),
    "slu_tree_post": (_i64, [ctypes.c_void_p, _F64, _i64]),
    "slu_tree_peek": (_i64, [ctypes.c_void_p, _i64, _F64, _i64]),
}

_lib = None
_load_lock = threading.Lock()


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def build() -> Path:
    """Compile ``SRC`` with ``CXX`` into ``BUILD_ROOT`` unless a library
    for this exact source, compiler and flags exists; return its path.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails.  The build, or the hit, is one record of the build census."""
    t0 = time.perf_counter()
    digest = hashlib.sha256(repr((CXX, CXX_FLAGS, LD_LIBS)).encode())
    digest.update(SRC.read_bytes())
    key = digest.hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / LIB_NAME
    hit = lib.exists()
    if not hit:
        out_dir.mkdir(parents=True, exist_ok=True)
        # the lock is the open file's: it is released when the holder
        # exits, so a build cut short leaves nothing to wait on
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            hit = lib.exists()      # built while this process waited
            if not hit:
                _compile(lib)
    record_build("native.build", key, t0, time.perf_counter() - t0,
                 persistent_hit=hit)
    return lib


def _compile(lib) -> None:
    tmp = lib.parent / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LD_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the native host library: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native host library failed "
            f"({' '.join(cmd)}, exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)


def load():
    """The loaded library, built on first use; raises ``RuntimeError``
    when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    # the build serializes itself on its own file lock, so it runs outside
    # _load_lock: a thread waiting for the load never waits on the compiler
    path = build()
    with _load_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the native host library "
                                   f"{path}: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def _call(name: str):
    """The loaded library, with one call of ``name`` counted."""
    lib = load()
    CALLS[name] += 1
    return lib


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _pattern(n_rows: int, n_cols: int, indptr, indices):
    """A compressed pattern as contiguous int64 arrays, checked before its
    pointers cross the seam: n_rows + 1 monotone row pointers within
    ``indices``, every index in [0, n_cols)."""
    indptr, indices = _as_i64(indptr), _as_i64(indices)
    if (len(indptr) != n_rows + 1 or indptr[0] != 0
            or np.any(np.diff(indptr) < 0) or indptr[-1] > len(indices)):
        raise ValueError(f"indptr of {len(indptr)} entries does not describe "
                         f"{n_rows} rows of {len(indices)} indices")
    if len(indices) and (indices.min() < 0 or indices.max() >= n_cols):
        raise ValueError(f"indices outside [0, {n_cols})")
    return indptr, indices


def _ptr_i64(a: np.ndarray):
    return a.ctypes.data_as(_I64)


def _values(absval, indptr) -> np.ndarray:
    absval = np.ascontiguousarray(absval, dtype=np.float64)
    if len(absval) < indptr[-1]:
        raise ValueError(f"{len(absval)} values for {indptr[-1]} entries")
    return absval


def _ptr_f64(a: np.ndarray):
    return a.ctypes.data_as(_F64)


def _take_i64(lib, buf, total: int) -> np.ndarray:
    """Copy ``total`` int64 values out of a buffer the library malloc'd,
    then free it (``slu_free_i64``), whatever the copy does."""
    try:
        if total <= 0:
            return np.empty(0, dtype=np.int64)
        return np.ctypeslib.as_array(buf, shape=(total,)).copy()
    finally:
        lib.slu_free_i64(buf)


def etree(n: int, indptr, indices) -> np.ndarray:
    """Elimination tree of a symmetric pattern (parent array, -1 roots)."""
    indptr, indices = _pattern(n, n, indptr, indices)
    lib = _call("etree")
    parent = np.empty(n, dtype=np.int64)
    lib.slu_etree(n, _ptr_i64(indptr), _ptr_i64(indices), _ptr_i64(parent))
    return parent


def postorder(parent) -> np.ndarray:
    parent = _as_i64(parent)
    n = len(parent)
    if n and (parent.min() < -1 or parent.max() >= n):
        raise ValueError("parent entries outside [-1, n)")
    lib = _call("postorder")
    post = np.empty(n, dtype=np.int64)
    lib.slu_postorder(n, _ptr_i64(parent), _ptr_i64(post))
    return post


def symbolic(n: int, indptr, indices, parent, relax: int, max_supernode: int,
             nthreads: int = 1):
    """Supernodal symbolic factorization (nthreads > 1: subtrees on
    threads, the symbfact_dist analog).  Returns (sn_start, col_to_sn,
    sn_parent, sn_level, rows_ptr, rows_data)."""
    indptr, indices = _pattern(n, n, indptr, indices)
    parent = _as_i64(parent)
    if len(parent) != n:
        raise ValueError(f"parent has {len(parent)} entries, not {n}")
    lib = _call("symbolic")
    sn_start = np.empty(n + 1, dtype=np.int64)
    col_to_sn = np.empty(n, dtype=np.int64)
    sn_parent = np.empty(n, dtype=np.int64)
    sn_level = np.empty(n, dtype=np.int64)
    rows_ptr = np.empty(n + 1, dtype=np.int64)
    rows_data_p = _I64()
    # slu_symbolic_mt with nthreads=1 is the serial path
    ns = lib.slu_symbolic_mt(n, _ptr_i64(indptr), _ptr_i64(indices),
                             _ptr_i64(parent), relax, max_supernode,
                             max(int(nthreads), 1), _ptr_i64(sn_start),
                             _ptr_i64(col_to_sn), _ptr_i64(sn_parent),
                             _ptr_i64(sn_level), _ptr_i64(rows_ptr),
                             ctypes.byref(rows_data_p))
    if ns < 0:
        raise MemoryError("slu_symbolic_mt could not allocate its row lists")
    rows_data = _take_i64(lib, rows_data_p, int(rows_ptr[ns]))
    return (sn_start[:ns + 1].copy(), col_to_sn, sn_parent[:ns].copy(),
            sn_level[:ns].copy(), rows_ptr[:ns + 1].copy(), rows_data)


def amalgamate(n: int, sn_start, rows_ptr, rows_data, tol: float,
               max_width: int, narrow: int, hard_tol: float):
    """Fill-tolerant supernode amalgamation (twin of
    symbfact.amalgamate_supernodes), in and out in the ``symbolic``
    protocol."""
    lib = _call("amalgamate")
    sn_start, rows_ptr = _as_i64(sn_start), _as_i64(rows_ptr)
    rows_data = _as_i64(rows_data)
    ns = len(sn_start) - 1
    o_sn_start = np.empty(n + 1, dtype=np.int64)
    o_col_to_sn = np.empty(n, dtype=np.int64)
    o_sn_parent = np.empty(max(ns, 1), dtype=np.int64)
    o_sn_level = np.empty(max(ns, 1), dtype=np.int64)
    o_rows_ptr = np.empty(n + 1, dtype=np.int64)
    o_rows_data_p = _I64()
    k = lib.slu_amalgamate(n, ns, _ptr_i64(sn_start), _ptr_i64(rows_ptr),
                           _ptr_i64(rows_data), float(tol), int(max_width),
                           int(narrow), float(hard_tol),
                           _ptr_i64(o_sn_start), _ptr_i64(o_col_to_sn),
                           _ptr_i64(o_sn_parent), _ptr_i64(o_sn_level),
                           _ptr_i64(o_rows_ptr), ctypes.byref(o_rows_data_p))
    if k < 0:
        raise MemoryError("slu_amalgamate could not allocate its row lists")
    out_rows = _take_i64(lib, o_rows_data_p, int(o_rows_ptr[k]))
    return (o_sn_start[:k + 1].copy(), o_col_to_sn, o_sn_parent[:k].copy(),
            o_sn_level[:k].copy(), o_rows_ptr[:k + 1].copy(), out_rows)


def mc64(n: int, indptr, indices, absval):
    """MC64 job=5 on the moduli of a CSC matrix: (col_match, u, v), the
    matching and the column / row duals.  Raises ValueError when A is
    structurally singular."""
    indptr, indices = _pattern(n, n, indptr, indices)
    absval = _values(absval, indptr)
    lib = _call("mc64")
    col_match = np.empty(n, dtype=np.int64)
    u = np.empty(n, dtype=np.float64)
    v = np.empty(n, dtype=np.float64)
    rc = lib.slu_mc64(n, _ptr_i64(indptr), _ptr_i64(indices),
                      _ptr_f64(absval), _ptr_i64(col_match), _ptr_f64(u),
                      _ptr_f64(v))
    if rc != 0:
        raise ValueError("no perfect matching")
    return col_match, u, v


def awpm(n: int, indptr, indices, absval) -> np.ndarray:
    """Approximate-weight perfect matching (the HWPM analog) on the moduli
    of a CSC matrix: col_match.  Raises ValueError when A is structurally
    singular."""
    indptr, indices = _pattern(n, n, indptr, indices)
    absval = _values(absval, indptr)
    lib = _call("awpm")
    col_match = np.empty(n, dtype=np.int64)
    rc = lib.slu_awpm(n, _ptr_i64(indptr), _ptr_i64(indices),
                      _ptr_f64(absval), _ptr_i64(col_match))
    if rc != 0:
        raise ValueError("no perfect matching")
    return col_match


def positions(s_arr, x_arr, first, last, snW, rows_ptr, rows_data):
    """Position of global index x_arr[k] within the front of supernode
    s_arr[k], for every k (plan building)."""
    lib = _call("positions")
    args = [_as_i64(x) for x in (s_arr, x_arr, first, last, snW, rows_ptr,
                                 rows_data)]
    pos = np.empty(len(args[0]), dtype=np.int64)
    lib.slu_positions(len(args[0]), *map(_ptr_i64, args), _ptr_i64(pos))
    return pos


def mmd(n: int, indptr, indices) -> np.ndarray:
    """Exact-external-degree minimum-degree order of a symmetric pattern."""
    indptr, indices = _pattern(n, n, indptr, indices)
    lib = _call("mmd")
    order = np.empty(n, dtype=np.int64)
    lib.slu_mmd(n, _ptr_i64(indptr), _ptr_i64(indices), _ptr_i64(order))
    return order


def colamd(n_rows: int, n_cols: int, indptr, indices) -> np.ndarray:
    """COLAMD-class approximate column minimum-degree order of a CSR
    pattern."""
    indptr, indices = _pattern(n_rows, n_cols, indptr, indices)
    lib = _call("colamd")
    order = np.empty(n_cols, dtype=np.int64)
    lib.slu_colamd(n_rows, n_cols, _ptr_i64(indptr), _ptr_i64(indices),
                   _ptr_i64(order))
    return order


def ata_pattern(n_rows: int, n_cols: int, indptr, indices,
                dense_row: int = 0):
    """Symmetric adjacency of AᵀA without the diagonal (the getata_dist
    analog) as (indptr, indices); dense_row > 0 drops rows longer than
    that."""
    indptr, indices = _pattern(n_rows, n_cols, indptr, indices)
    lib = _call("ata_pattern")
    out_ptr = np.empty(n_cols + 1, dtype=np.int64)
    buf = _I64()
    total = int(lib.slu_ata_pattern(n_rows, n_cols, _ptr_i64(indptr),
                                    _ptr_i64(indices), dense_row,
                                    _ptr_i64(out_ptr), ctypes.byref(buf)))
    return out_ptr, _take_i64(lib, buf, total)


def mlnd(n: int, indptr, indices, leaf_size: int = 96, seed: int = 1,
         nthreads: int = 1) -> np.ndarray:
    """Multilevel nested dissection of a symmetric pattern.  nthreads > 1
    runs independent separator subtrees on threads (the ParMETIS analog,
    SRC/get_perm_c_parmetis.c:104,255); the order depends on (seed,
    leaf_size) only, not on nthreads."""
    indptr, indices = _pattern(n, n, indptr, indices)
    lib = _call("mlnd")
    order = np.empty(n, dtype=np.int64)
    lib.slu_mlnd_mt(n, _ptr_i64(indptr), _ptr_i64(indices), leaf_size, seed,
                    max(int(nthreads), 1), _ptr_i64(order))
    return order
