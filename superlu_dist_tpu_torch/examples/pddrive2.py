#!/usr/bin/env python
"""Pattern reuse: same sparsity pattern, new values — analog of
EXAMPLE/pddrive2.c (Fact=SamePattern: ordering and symbolic analysis are
reused; the numeric factorization runs on the new values).  The port's
counterpart of the JAX package's ``examples/pddrive2.py``.

    python -m superlu_dist_tpu_torch.examples.pddrive2 [matrix] [--device cpu]
"""

import numpy as np

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def run(ns, complex_: bool, name: str) -> int:
    """DOFACT, then SamePattern on values perturbed by 1 % (and in phase,
    for the z-driver): the column order is reused, and the symbolic
    structure and plan too when the fresh matching reproduces the row
    permutation."""
    import superlu_dist_tpu_torch as slt

    a, src = load_matrix(ns.matrix, complex_=complex_)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz} dtype={a.data.dtype}")
    xtrue, b = make_rhs(a)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device=ns.device)
    require(info == 0, f"info={info}")

    # perturb values, keep the pattern (dcreate_matrix_perturbed analog)
    rng = np.random.default_rng(7)
    vals = a.data * (1.0 + 0.01 * rng.standard_normal(a.nnz))
    if complex_:
        vals = vals * np.exp(0.01j * rng.standard_normal(a.nnz))
    a2 = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices, vals)
    xtrue2, b2 = make_rhs(a2, seed=2)
    x2, lu2, stats2, info2 = slt.gssvx(
        slt.Options(fact=slt.Fact.SamePattern), a2, b2, lu=lu)
    require(info2 == 0, f"info={info2}")
    # SamePattern reuses the column ordering (the reference tier,
    # superlu_defs.h:489-510): the invariant itself, not a timing proxy
    require(np.array_equal(lu2.col_order, lu.col_order), "col order reused")
    if np.array_equal(lu2.row_order, lu.row_order):
        require(lu2.sf is lu.sf and lu2.plan is lu.plan,
                "symbolic/plan must be reused when the row perm is unchanged")
        reuse_s = stats2.utime["SYMBFACT"] + stats2.utime["DIST"]
        if not complex_:
            require(reuse_s < max(0.25 * stats.utime["SYMBFACT"], 0.05),
                    f"reuse not ~free ({reuse_s} s)")
        print(f"{name.split()[0]}: row perm stable -> symbolic+plan reused "
              f"(SYMBFACT+DIST {reuse_s:.4f}s)")
    resid = report(name, a2, b2, x2, xtrue2, stats2)
    require(resid < 1e-10, f"residual {resid}")
    return 0


def main(argv=None):
    return run(parser(__doc__).parse_args(argv), False,
               "pddrive2 (SamePattern)")


if __name__ == "__main__":
    raise SystemExit(main())
