#!/usr/bin/env python
"""Distributed-input driver — the NR_loc path of pdgssvx (the reference's
primary input format, SRC/supermatrix.h:175-188): A and B arrive as
block-row pieces (``distribute_rows`` plays the example drivers'
read-and-scatter, EXAMPLE/dcreate_matrix.c:239), and the solver consumes
the distributed form directly through ``gssvx_dist``.  The port's
counterpart of the JAX package's ``examples/pddrive_dist.py``.

For the multi-process version of this flow (one process per block row,
the factors sharded over a process grid) see ``pddrive_grid.py`` beside
this file.

    python -m superlu_dist_tpu_torch.examples.pddrive_dist [matrix] [--device cpu]
"""

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def main(argv=None):
    ns = parser(__doc__).parse_args(argv)
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.parallel.dist import distribute_rows

    a, src = load_matrix(ns.matrix)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz}")
    xtrue, b = make_rhs(a)
    parts = distribute_rows(a, 4)        # four block-row owners
    print("block rows:", [(p.fst_row, p.m_loc, p.nnz_loc) for p in parts])
    x, lu, stats, info = slt.gssvx_dist(slt.Options(), parts, b,
                                        device=ns.device)
    require(info == 0, f"info={info}")
    resid = report("pddrive_dist (NR_loc input)", a, b, x, xtrue, stats)
    require(resid < 1e-10, f"residual {resid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
