"""The port's native host-analysis library against the JAX package's.

Both libraries compile the same C++ (``superlu_dist_tpu_torch/native/
slu_host.cpp`` is the analysis part of ``superlu_dist_tpu/native/
slu_host.cpp``), so on the same seeded inputs:

* every native entry point of the port equals the JAX package's bit for
  bit;
* the port's ``analyze`` with the default ``Options()`` (native on) equals
  the JAX ``analyze`` with its native library on, array for array, for
  every column and row ordering the two share, serial and threaded;
* ``Options(native=False)`` runs the Python twins and makes no native call;
* a failed build raises, and concurrent first uses build one library;
* ``gssvx`` with COLAMD, MMD_ATA and AWPM solves to BERR ≤ berr_target and
  agrees with the JAX ``gssvx`` at the device-vs-host gate.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import superlu_dist_tpu as jslu
import superlu_dist_tpu.native as jax_native
from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.utils.options import ColPerm as JaxColPerm
from superlu_dist_tpu.utils.options import Options as JaxOptions
from superlu_dist_tpu.utils.options import RowPerm as JaxRowPerm

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch import native
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.ordering.colamd import dense_row_threshold
from superlu_dist_tpu_torch.sparse.formats import symmetrize_pattern
from superlu_dist_tpu_torch.utils import tols

ROOT = Path(__file__).resolve().parents[1]

#: test_torch_factor.py's matrices and an irregular one with n > 400 (the
#: multilevel ND path of ND_AT_PLUS_A)
MATRICES = {
    "poisson2d_14": lambda g: g.poisson2d(14),
    "poisson3d_6": lambda g: g.poisson3d(6),
    "random_80": lambda g: g.random_sparse(80, density=0.05, seed=3),
    "random_600": lambda g: g.random_sparse(600, density=0.01, seed=5),
}
COL_PERMS = ["METIS_AT_PLUS_A", "MMD_AT_PLUS_A", "COLAMD", "MMD_ATA"]
ROW_PERMS = ["LargeDiag_MC64", "LargeDiag_AWPM"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native_on():
    assert jax_native.available(), "the JAX package's native library"


def _patterns():
    """Seeded symmetric patterns: a grid, a convection stencil, two
    irregular graphs (one past the n > 400 ND threshold)."""
    return [symmetrize_pattern(m) for m in (
        gallery.poisson2d(15), gallery.convection_diffusion_2d(12),
        gallery.random_sparse(150, density=0.04, seed=1),
        gallery.random_sparse(700, density=0.008, seed=7))]


def _same(got, want, what=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{k}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape and np.array_equal(
        got.view(np.uint8), want.view(np.uint8)), what


def _sym_case(sym):
    return sym.n_rows, sym.indptr, sym.indices


def _etree_post(sym):
    n, ip, ix = _sym_case(sym)
    parent = native.etree(n, ip, ix)
    _same(parent, jax_native.etree(n, ip, ix), "etree")
    _same(native.postorder(parent), jax_native.postorder(parent), "postorder")


def _postordered(sym):
    """The pattern relabelled by its etree postorder, with its parent
    array: the input protocol of the native symbolic."""
    n, ip, ix = _sym_case(sym)
    post = native.postorder(native.etree(n, ip, ix))
    b = sym.permute(post, post)
    return n, b.indptr, b.indices, native.etree(n, b.indptr, b.indices)


def _symbolic(sym):
    for relax, maxs in ((1, 8), (8, 32), (20, 256)):
        for nthreads in (1, 2, 4):
            args = _postordered(sym) + (relax, maxs)
            _same(native.symbolic(*args, nthreads=nthreads),
                  jax_native.symbolic(*args, nthreads=nthreads),
                  f"symbolic relax={relax} nthreads={nthreads}")


def _amalgamate(sym):
    n = sym.n_rows
    sn_start, _, _, _, rows_ptr, rows = native.symbolic(*_postordered(sym),
                                                        4, 64)
    for tol, width, narrow, hard in ((1.2, 256, 64, 4.0), (2.0, 32, 8, 1.5)):
        _same(native.amalgamate(n, sn_start, rows_ptr, rows, tol, width,
                                narrow, hard),
              jax_native.amalgamate(n, sn_start, rows_ptr, rows, tol, width,
                                    narrow, hard), f"amalgamate tol={tol}")


def _positions(sym):
    sn_start, _, _, _, rows_ptr, rows = native.symbolic(*_postordered(sym),
                                                        4, 64)
    ns = len(sn_start) - 1
    first, last = sn_start[:-1], sn_start[1:] - 1
    sn_w = np.diff(sn_start) + 3                      # padded widths
    rng = np.random.default_rng(5)
    s = rng.integers(0, ns, 500)
    below = rng.random(500) < 0.5
    x = first[s] + rng.integers(0, 1 << 30, 500) % (last[s] - first[s] + 1)
    nrows = np.diff(rows_ptr)[s]
    has = below & (nrows > 0)
    x[has] = rows[rows_ptr[s[has]] + rng.integers(0, 1 << 30, has.sum())
                  % nrows[has]]
    args = (s, x, first, last, sn_w, rows_ptr, rows)
    _same(native.positions(*args), jax_native.positions(*args), "positions")


def _matching(sym):
    n = sym.n_rows
    a = gallery.random_sparse(n, density=min(8.0 / n, 0.2), seed=n).tocsc()
    absval = np.abs(a.data)
    _same(native.mc64(n, a.indptr, a.indices, absval),
          jax_native.mc64(n, a.indptr, a.indices, absval), "mc64")
    _same(native.awpm(n, a.indptr, a.indices, absval),
          jax_native.awpm(n, a.indptr, a.indices, absval), "awpm")


def _orderings(sym):
    n, ip, ix = _sym_case(sym)
    _same(native.mmd(n, ip, ix), jax_native.mmd(n, ip, ix), "mmd")
    for leaf, seed in ((96, 1), (16, 3)):
        want = jax_native.mlnd(n, ip, ix, leaf_size=leaf, seed=seed,
                               nthreads=1)
        for nthreads in (1, 2, 4):
            _same(native.mlnd(n, ip, ix, leaf_size=leaf, seed=seed,
                              nthreads=nthreads), want,
                  f"mlnd leaf={leaf} nthreads={nthreads}")


def _column_orderings(sym):
    n = sym.n_rows
    a = gallery.random_sparse(n, density=min(6.0 / n, 0.2), seed=n + 1)
    _same(native.colamd(n, n, a.indptr, a.indices),
          jax_native.colamd(n, n, a.indptr, a.indices), "colamd")
    for dense in (0, dense_row_threshold(n), 3):
        _same(native.ata_pattern(n, n, a.indptr, a.indices, dense),
              tuple(jax_native.ata_pattern(n, n, a.indptr, a.indices, dense)),
              f"ata_pattern dense_row={dense}")


FUNCTIONS = {"etree_postorder": _etree_post, "symbolic": _symbolic,
             "amalgamate": _amalgamate, "positions": _positions,
             "mc64_awpm": _matching, "mmd_mlnd": _orderings,
             "colamd_ata_pattern": _column_orderings}


@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
def test_native_function_equals_jax_native(fn):
    for sym in _patterns():
        FUNCTIONS[fn](sym)


def assert_same_analysis(lu, vals, ref_lu, ref_vals):
    """Row order, scalings, column order, every symbolic array and every
    plan map of two analyses, array for array."""
    _same(vals, ref_vals, "permuted values")
    for field in ("row_order", "col_order", "dr", "dc", "r1", "c1",
                  "a_sym_indptr", "a_sym_indices"):
        _same(getattr(lu, field), getattr(ref_lu, field), field)
    assert lu.equed == ref_lu.equed and lu.anorm == ref_lu.anorm
    sf, rsf = lu.sf, ref_lu.sf
    for field in ("perm", "parent", "sn_start", "col_to_sn", "sn_parent",
                  "sn_level", "pattern_indptr", "pattern_indices",
                  "value_perm"):
        _same(getattr(sf, field), getattr(rsf, field), f"sf.{field}")
    assert (sf.nnz_L, sf.nnz_U, sf.flops) == (rsf.nnz_L, rsf.nnz_U, rsf.flops)
    assert len(sf.sn_rows) == len(rsf.sn_rows)
    for r, rr in zip(sf.sn_rows, rsf.sn_rows):
        assert np.array_equal(r, rr)
    plan, rplan = lu.plan, ref_lu.plan
    assert (plan.pool_size, len(plan.groups)) == (rplan.pool_size,
                                                  len(rplan.groups))
    for g, rg in zip(plan.groups, rplan.groups):
        assert (g.level, g.m, g.w, g.u, g.batch) == (rg.level, rg.m, rg.w,
                                                     rg.u, rg.batch)
        for field in ("sns", "ws", "off", "a_slot", "a_flat", "a_src"):
            assert np.array_equal(getattr(g, field), getattr(rg, field)), field
        assert len(g.children) == len(rg.children)
        for cs, rcs in zip(g.children, rg.children):
            assert cs.ub == rcs.ub
            for field in ("child_off", "child_slot", "rel"):
                assert np.array_equal(getattr(cs, field), getattr(rcs, field))


@pytest.mark.parametrize("row_perm", ROW_PERMS)
@pytest.mark.parametrize("col_perm", COL_PERMS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_analysis_equals_jax_native(name, col_perm, row_perm):
    native.reset_calls()
    lu, vals, _ = slt.analyze(
        slt.Options(col_perm=getattr(slt.ColPerm, col_perm),
                    row_perm=getattr(slt.RowPerm, row_perm)),
        MATRICES[name](gallery), device="cpu")
    ref_lu, ref_vals, _ = jax_analyze(
        JaxOptions(col_perm=getattr(JaxColPerm, col_perm),
                   row_perm=getattr(JaxRowPerm, row_perm)),
        MATRICES[name](jgal))
    assert_same_analysis(lu, vals, ref_lu, ref_vals)
    matching = "mc64" if row_perm == "LargeDiag_MC64" else "awpm"
    for fn in (matching, "etree", "postorder", "symbolic", "amalgamate",
               "positions"):
        assert native.CALLS[fn] > 0, fn


@pytest.mark.parametrize("threads", [2, 4])
@pytest.mark.parametrize("name", ["poisson3d_8", "random_600"])
def test_threaded_analysis_equals_jax_native(name, threads, monkeypatch):
    """symb_threads / nd_threads against the JAX package's
    SLU_TPU_SYMB_THREADS / SLU_TPU_ND_THREADS."""
    make = {"poisson3d_8": lambda g: g.poisson3d(8),
            "random_600": MATRICES["random_600"]}[name]
    monkeypatch.setenv("SLU_TPU_SYMB_THREADS", str(threads))
    monkeypatch.setenv("SLU_TPU_ND_THREADS", str(threads))
    ref_lu, ref_vals, _ = jax_analyze(JaxOptions(), make(jgal))
    native.reset_calls()
    lu, vals, _ = slt.analyze(slt.Options(symb_threads=threads,
                                          nd_threads=threads),
                              make(gallery), device="cpu")
    assert native.CALLS["mlnd"] == 1          # n > 400, no grid after MC64
    assert_same_analysis(lu, vals, ref_lu, ref_vals)


@pytest.mark.parametrize("row_perm", ROW_PERMS)
@pytest.mark.parametrize("col_perm", COL_PERMS)
def test_native_off_runs_the_python_twins(col_perm, row_perm, monkeypatch):
    """Options(native=False) equals the JAX package with its native library
    off (the plan the port built before it had the library), and makes no
    native call."""
    a = MATRICES["random_600"]
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    ref_lu, ref_vals, _ = jax_analyze(
        JaxOptions(col_perm=getattr(JaxColPerm, col_perm),
                   row_perm=getattr(JaxRowPerm, row_perm)), a(jgal))
    native.reset_calls()
    lu, vals, _ = slt.analyze(
        slt.Options(col_perm=getattr(slt.ColPerm, col_perm),
                    row_perm=getattr(slt.RowPerm, row_perm), native=False),
        a(gallery), device="cpu")
    assert not any(native.CALLS.values()), native.CALLS
    assert_same_analysis(lu, vals, ref_lu, ref_vals)


@pytest.mark.parametrize("bad", [
    lambda: native.etree(3, [0, 1, 2], [0, 1]),            # short indptr
    lambda: native.mmd(3, [0, 1, 3, 2], [1, 0, 2]),        # not monotone
    lambda: native.mlnd(3, [0, 1, 2, 9], [1, 0, 1]),       # past indices
    lambda: native.colamd(2, 3, [0, 1, 2], [0, 3]),        # column 3 of 3
    lambda: native.postorder([1, 5, -1]),                  # parent >= n
    lambda: native.mc64(2, [0, 1, 2], [0, 1], [1.0]),      # one value short
])
def test_malformed_input_raises_before_the_seam(bad):
    native.reset_calls()
    with pytest.raises(ValueError):
        bad()
    assert not any(native.CALLS.values())


def test_library_is_the_ports_own():
    lib = native.build()
    assert native.SRC.parent == ROOT / "superlu_dist_tpu_torch" / "native"
    assert lib.parent.parent == ROOT / "build" / "torch_host"
    assert native.load()._name == str(lib)


@pytest.mark.parametrize("fault", ["missing_compiler", "compile_error"])
def test_failed_build_raises(fault, tmp_path, monkeypatch):
    """A build that fails raises RuntimeError with the compiler's words,
    through the analysis too: nothing falls back to the Python twins."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    if fault == "missing_compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no" / "g++"))
        words = "cannot build"
    else:
        bad = tmp_path / "slu_host.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC", bad)
        words = "error"
    with pytest.raises(RuntimeError, match=words):
        native.build()
    native.reset_calls()
    with pytest.raises(RuntimeError, match=words):
        slt.analyze(slt.Options(), gallery.poisson2d(6), device="cpu")
    assert native._lib is None and not any(native.CALLS.values())
    assert not list((tmp_path / "build").rglob("*.so"))


_RACE = """
import sys
from pathlib import Path
import superlu_dist_tpu_torch.native as native
native.BUILD_ROOT = Path(sys.argv[1])
print("ready", flush=True)
sys.stdin.readline()
native.load()
print(native.build())
print(",".join(map(str, native.etree(3, [0, 0, 1, 2], [0, 1]))))
"""


def test_concurrent_first_builds_load_one_library(tmp_path):
    """Two processes released together into an empty build directory: one
    builds while the other waits on the lock, and both load that
    library."""
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path)],
                              cwd=ROOT, stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready"
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0] == lines[1]
    lib = Path(lines[0][0])
    assert lib.parent.parent == tmp_path and lib.exists()
    assert sorted(f.name for f in lib.parent.iterdir()) == [native.LIB_NAME,
                                                           "lock"]
    assert lines[0][1] == "1,2,-1"


OPTION_CASES = {
    "COLAMD": dict(col_perm="COLAMD"),
    "MMD_ATA": dict(col_perm="MMD_ATA"),
    "AWPM": dict(row_perm="LargeDiag_AWPM"),
}


def _options(mod, case):
    kw = {k: getattr(mod.ColPerm if k == "col_perm" else mod.RowPerm, v)
          for k, v in OPTION_CASES[case].items()}
    return mod.Options(**kw)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
@pytest.mark.parametrize("name", ["poisson2d_14", "random_80"])
def test_gssvx_with_native_orderings_matches_jax(name, case):
    a = MATRICES[name](gallery)
    b = np.random.default_rng(13).standard_normal(a.n_rows)
    native.reset_calls()
    x, lu, stats, info = slt.gssvx(_options(slt, case), a, b, device="cpu")
    x_ref, _, _, info_ref = jslu.gssvx(_options(jslu, case),
                                       MATRICES[name](jgal), b)
    assert info == info_ref == 0
    assert stats.solve_report.berr <= tols.berr_target(np.float64)
    np.testing.assert_allclose(x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    used = {"COLAMD": "colamd", "MMD_ATA": "ata_pattern", "AWPM": "awpm"}
    assert native.CALLS[used[case]] == 1
