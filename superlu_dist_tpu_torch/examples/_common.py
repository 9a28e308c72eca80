"""Shared helpers of the example drivers.

The port's counterpart of the JAX package's ``examples/_common.py``
(EXAMPLE/dcreate_matrix.c:66,239 in the reference): load a matrix
(Harwell-Boeing / Rutherford-Boeing / MatrixMarket / triples), fabricate
a known solution xtrue, build b = A·xtrue and report ‖x−xtrue‖∞ after
the solve: the reference's examples are self-checking accuracy tests,
and so are these.

Every driver takes an optional matrix file (the reference's fixtures,
e.g. ``EXAMPLE/g20.rua``, by path); without one it solves the gallery
stand-in of the fixture's size, ``poisson2d(20)`` (n = 400), or its
complex counterpart.  ``--device`` chooses where the factors live: the
card (the default; without one it raises) or ``cpu``.  Each driver is
``main(argv=None)`` and runs in-process as well as from the shell:

    python -m superlu_dist_tpu_torch.examples.pddrive [matrix] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


class ExampleCheckError(AssertionError):
    """A driver's self-check failed (raised, so ``python -O`` keeps it)."""


def require(ok, what: str) -> None:
    """Raise :class:`ExampleCheckError` unless ``ok``."""
    if not ok:
        raise ExampleCheckError(what)


def parser(doc: str) -> argparse.ArgumentParser:
    """The drivers' command line: an optional matrix file and
    ``--device cuda|cpu`` (default the card)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("matrix", nargs="?", default=None,
                    help="matrix file (.rua/.rb/.cua/.mtx/.triple); "
                         "default: poisson2d(20)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    return ap


def load_matrix(path: str | None = None, complex_: bool = False):
    """(matrix, its name): the file ``path``, else ``poisson2d(20)``, with
    complex values when ``complex_`` (the z-drivers' stand-in for the
    reference's cg20.cua, as the JAX package makes it)."""
    from superlu_dist_tpu_torch.io import read_matrix
    from superlu_dist_tpu_torch.models.gallery import poisson2d
    if path:
        return read_matrix(path).tocsr(), path
    a = poisson2d(20)
    if complex_:
        a = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                    a.data.astype(np.complex128))
    return a, "poisson2d(20)"


def make_rhs(a, nrhs: int = 1, seed: int = 0):
    """xtrue and b = A·xtrue (dGenXtrue_dist / dFillRHS_dist analogs)."""
    from superlu_dist_tpu_torch.utils.precision import fill_rhs, gen_xtrue
    xtrue = gen_xtrue(a.n_rows, nrhs, dtype=a.data.dtype, seed=seed)
    return xtrue, fill_rhs(a, xtrue)


def report(name, a, b, x, xtrue, stats) -> float:
    """Print the residual and ‖x−xtrue‖∞ line and the Stats; return the
    relative residual ‖b−Ax‖/‖b‖."""
    from superlu_dist_tpu_torch.utils.precision import inf_norm_error
    resid = float(np.linalg.norm(np.ravel(b - a.matvec(x)))
                  / max(float(np.linalg.norm(np.ravel(b))), 1e-300))
    err = inf_norm_error(x, xtrue)
    print(f"[{name}] residual ||b-Ax||/||b|| = {resid:.3e}   "
          f"||x-xtrue||inf/||x||inf = {err:.3e}")
    stats.print()
    return resid
