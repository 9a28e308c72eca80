#!/usr/bin/env python
"""Replicated-input driver — analog of EXAMPLE/pddrive_ABglobal.c
(pdgssvx_ABglobal: A and B given replicated rather than distributed).
The port's counterpart of the JAX package's
``examples/pddrive_ABglobal.py``.

    python -m superlu_dist_tpu_torch.examples.pddrive_ABglobal [matrix] [--device cpu]
"""

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def main(argv=None):
    ns = parser(__doc__).parse_args(argv)
    import superlu_dist_tpu_torch as slt

    a, src = load_matrix(ns.matrix)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz}")
    xtrue, b = make_rhs(a)
    x, lu, stats, info = slt.gssvx_ABglobal(slt.Options(), a, b,
                                            device=ns.device)
    require(info == 0, f"info={info}")
    resid = report("pddrive_ABglobal", a, b, x, xtrue, stats)
    require(resid < 1e-10, f"residual {resid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
