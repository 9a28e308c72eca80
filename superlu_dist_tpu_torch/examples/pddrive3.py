#!/usr/bin/env python
"""Pattern + row-permutation reuse — analog of EXAMPLE/pddrive3.c
(Fact=SamePattern_SameRowPerm: ordering, symbolic analysis AND the row
permutation/scalings are reused; only the numeric values change).  The
port's counterpart of the JAX package's ``examples/pddrive3.py``.

    python -m superlu_dist_tpu_torch.examples.pddrive3 [matrix] [--device cpu]
"""

import numpy as np

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def run(ns, complex_: bool, name: str) -> int:
    """DOFACT, then SamePattern_SameRowPerm on values perturbed by 0.1 %:
    both permutations are the first factorization's (and, checked for the
    z-driver, its symbolic structure and plan)."""
    import superlu_dist_tpu_torch as slt

    a, src = load_matrix(ns.matrix, complex_=complex_)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz} dtype={a.data.dtype}")
    xtrue, b = make_rhs(a)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device=ns.device)
    require(info == 0, f"info={info}")

    rng = np.random.default_rng(11)
    a2 = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                 a.data * (1.0 + 0.001 * rng.standard_normal(a.nnz)))
    xtrue2, b2 = make_rhs(a2, seed=3)
    x2, lu2, stats2, info2 = slt.gssvx(
        slt.Options(fact=slt.Fact.SamePattern_SameRowPerm), a2, b2, lu=lu)
    require(info2 == 0, f"info={info2}")
    require(np.array_equal(lu2.row_order, lu.row_order), "row perm reused")
    require(np.array_equal(lu2.col_order, lu.col_order), "col order reused")
    if complex_:
        require(lu2.sf is lu.sf and lu2.plan is lu.plan,
                "symbolic+plan reused")
    resid = report(name, a2, b2, x2, xtrue2, stats2)
    require(resid < 1e-10, f"residual {resid}")
    return 0


def main(argv=None):
    return run(parser(__doc__).parse_args(argv), False,
               "pddrive3 (SamePattern_SameRowPerm)")


if __name__ == "__main__":
    raise SystemExit(main())
