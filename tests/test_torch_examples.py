"""The port's example drivers (superlu_dist_tpu_torch/examples/) on the
CPU, beside the JAX package's examples.

Every driver runs in-process with ``--device cpu`` and must exit 0 after
its own checks and print its residual line.  pddrive, pzdrive and
pddrive_df64 also have their x held against the JAX ``gssvx`` with the
same options on the same matrix, within DEVICE_VS_HOST (df64: the port's
native float64 factors against the JAX package's emulated double).
pddrive4 / pzdrive4 run both ways: as one process (two plain solves) and
with ``--nproc 4`` (four gloo CPU ranks split into two 2×1 sub-grids by
``gridmap``).
"""

import importlib
import json

import numpy as np
import pytest

import superlu_dist_tpu as jslu
from superlu_dist_tpu.sparse.formats import SparseCSR as JCSR

from superlu_dist_tpu_torch.examples import pddrive, pddrive_df64
from superlu_dist_tpu_torch.examples._common import parser
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL

#: every counterpart of the JAX package's 14 example drivers, and the
#: residual line each prints
DRIVERS = {
    "pddrive": "[pddrive] residual",
    "pddrive1": "[pddrive1 (FACTORED reuse)] residual",
    "pddrive2": "[pddrive2 (SamePattern)] residual",
    "pddrive3": "[pddrive3 (SamePattern_SameRowPerm)] residual",
    "pddrive4": "[pddrive4 grid=None seed=1] residual",
    "pzdrive": "[pzdrive] residual",
    "pzdrive1": "[pzdrive1 (FACTORED)] residual",
    "pzdrive2": "[pzdrive2 (SamePattern)] residual",
    "pzdrive3": "[pzdrive3 (SamePattern_SameRowPerm)] residual",
    "pzdrive4": "[pzdrive4 grid=None seed=1] residual",
    "pddrive_ABglobal": "[pddrive_ABglobal] residual",
    "pddrive_dist": "[pddrive_dist (NR_loc input)] residual",
    "pddrive_df64": "[pddrive_df64] df64     raw-factor residual",
    "pddrive_refactor": "[hilbert(24) step 3 (refactor)] residual",
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_example_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(f"superlu_dist_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    assert DRIVERS[name] in capsys.readouterr().out


@pytest.mark.parametrize("name", ["pddrive4", "pzdrive4"])
def test_subgrid_example_on_four_ranks(name, capsys):
    mod = importlib.import_module(f"superlu_dist_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu", "--nproc", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[{name} grid=(2, 1) ranks=[0, 1] seed=0] residual" in out
    assert f"[{name} grid=(2, 1) ranks=[2, 3] seed=1] residual" in out


def test_pddrive_refactor_reuses_the_executors(capsys):
    from superlu_dist_tpu_torch.examples import pddrive_refactor
    assert pddrive_refactor.main(["--device", "cpu"]) == 0
    row = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("BENCH_ROW ")]
    rec = json.loads(row[0][len("BENCH_ROW "):])
    steps = [s for r in rec["rows"] for s in r["steps"]]
    assert len(steps) == 5 + 3
    assert all(s["symbolic_seconds"] == 0.0 and s["new_executors"] == 0
               for s in steps)


def _jax_csr(a):
    return JCSR(a.n_rows, a.n_cols, a.indptr, a.indices, a.data)


@pytest.mark.parametrize("complex_", [False, True])
def test_pddrive_x_matches_the_jax_gssvx(complex_):
    ns = parser("pddrive").parse_args(["--device", "cpu"])
    a, b, x = pddrive.run(ns, complex_, "pddrive")
    jx, _, _, info = jslu.gssvx(jslu.Options(), _jax_csr(a), b)
    assert info == 0
    np.testing.assert_allclose(x, np.asarray(jx), rtol=RTOL, atol=ATOL)


def test_pddrive_df64_x_matches_the_jax_gssvx():
    a, b, results = pddrive_df64.solve_both("cpu")
    opts = dict(equil=False, iter_refine=jslu.IterRefine.NOREFINE,
                recovery=jslu.RecoveryPolicy(enabled=False))
    jx, _, _, info = jslu.gssvx(jslu.Options(factor_dtype="df64", **opts),
                                _jax_csr(a), b)
    assert info == 0
    np.testing.assert_allclose(results["df64"][0], np.asarray(jx),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cplx", [False, True])
def test_df64_is_float64_bit_for_bit(cplx):
    """"df64" keeps the caller's string and factors in float64 (complex128
    for complex values): x bit for bit that of factor_dtype="float64"."""
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models import gallery
    a = gallery.helmholtz_2d(8) if cplx else gallery.poisson2d(10)
    b = a.matvec(np.ones(a.n_rows))
    got = {}
    for dt in ("df64", "float64"):
        x, lu, st, info = slt.gssvx(slt.Options(factor_dtype=dt), a, b,
                                    device="cpu")
        assert info == 0 and lu.options.factor_dtype == dt
        got[dt] = (x, lu.numeric.dtype, st.solve_report.factor_dtype)
    want = "complex128" if cplx else "float64"
    assert str(got["df64"][1]) == f"torch.{want}" == str(got["float64"][1])
    assert got["df64"][2] == want
    np.testing.assert_array_equal(got["df64"][0], got["float64"][0])
