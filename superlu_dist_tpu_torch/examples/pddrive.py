#!/usr/bin/env python
"""Basic expert-driver example — analog of EXAMPLE/pddrive.c:51.

Solve A·x = b once with default options on the card (float32 factors at
the TF32 tier, refined to float64), then verify against the fabricated
xtrue (the reference example's pdinf_norm_error check, pddrive.c:235).
The port's counterpart of the JAX package's ``examples/pddrive.py``.

    python -m superlu_dist_tpu_torch.examples.pddrive [matrix] [--device cpu]
"""

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def run(ns, complex_: bool, name: str):
    """One default solve of the matrix ``ns.matrix`` (complex values for
    the z-driver) on ``ns.device``, checked; returns (A, b, x)."""
    import superlu_dist_tpu_torch as slt

    a, src = load_matrix(ns.matrix, complex_=complex_)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz} dtype={a.data.dtype}")
    xtrue, b = make_rhs(a)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device=ns.device)
    require(info == 0, f"info={info}")
    resid = report(name, a, b, x, xtrue, stats)
    require(resid < 1e-10, f"residual {resid}")
    return a, b, x


def main(argv=None):
    run(parser(__doc__).parse_args(argv), False, "pddrive")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
