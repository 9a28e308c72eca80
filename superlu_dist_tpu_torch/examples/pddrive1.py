#!/usr/bin/env python
"""Factorization reuse: same A, new right-hand sides — analog of
EXAMPLE/pddrive1.c (Fact=FACTORED: the L,U factors and every permutation
are reused; only the triangular solves and refinement run again).  The
port's counterpart of the JAX package's ``examples/pddrive1.py``.

    python -m superlu_dist_tpu_torch.examples.pddrive1 [matrix] [--device cpu]
"""

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def run(ns, complex_: bool, name: str) -> int:
    """DOFACT, then FACTORED with a new b on the same factors.  The
    z-driver holds FACTORED to no FACT time at all (pzdrive1), the real
    one to under 10 ms (pddrive1)."""
    import superlu_dist_tpu_torch as slt

    a, src = load_matrix(ns.matrix, complex_=complex_)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz} dtype={a.data.dtype}")
    xtrue, b = make_rhs(a, seed=0)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device=ns.device)
    require(info == 0, f"info={info}")

    # second solve: same factors, different b (time-stepping pattern)
    xtrue2, b2 = make_rhs(a, seed=1)
    x2, lu, stats2, info2 = slt.gssvx(
        slt.Options(fact=slt.Fact.FACTORED), a, b2, lu=lu)
    require(info2 == 0, f"info={info2}")
    fact_s = stats2.utime["FACT"]
    require(fact_s == 0.0 if complex_ else fact_s < 0.01,
            f"FACTORED must skip factorization (FACT {fact_s} s)")
    resid = report(name, a, b2, x2, xtrue2, stats2)
    require(resid < 1e-10, f"residual {resid}")
    return 0


def main(argv=None):
    return run(parser(__doc__).parse_args(argv), False,
               "pddrive1 (FACTORED reuse)")


if __name__ == "__main__":
    raise SystemExit(main())
