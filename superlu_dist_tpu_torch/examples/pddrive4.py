#!/usr/bin/env python
"""Two independent solves on two process sub-grids — analog of
EXAMPLE/pddrive4.c (two sub-grids of the global communicator, made with
superlu_gridmap, each solve their own system).  The port's counterpart
of the JAX package's ``examples/pddrive4.py``, whose sub-grids are two
halves of one process's devices: here ``--nproc N`` spawns N ranks of a
``torch.distributed`` world (gloo when they share a card or run on the
CPU, NCCL when each has its own card), ``parallel/grid.gridmap`` splits
them into a (N/2)×1 and an (N-N/2)×1 sub-grid — every rank makes both
calls, and gets None for the grid it is not in — and each sub-grid
solves its own right-hand side with ``gssvx(grid=)``, the factors sharded
over its ranks.  With one process (the default) both sub-grids
degenerate to plain solves, as the JAX driver's do on one device.

    python -m superlu_dist_tpu_torch.examples.pddrive4 [matrix] [--nproc 4] [--device cpu]
"""

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)


def _halves(nproc: int):
    half = max(nproc // 2, 1)
    return [list(range(half)), list(range(half, nproc))]


def solve_on_subgrid(tc, grid, path, complex_, name):
    """One rank of the spawned world: both gridmap calls, then this rank's
    sub-grid solves its system (seed = the sub-grid's index)."""
    import numpy as np
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.parallel.grid import gridmap
    from superlu_dist_tpu_torch.utils.precision import inf_norm_error
    ranks = _halves(grid.nproc)
    subs = [gridmap(r, len(r), 1, device=grid.device) for r in ranks]
    which = [s is not None for s in subs].index(True)
    sub = subs[which]
    a, _ = load_matrix(path, complex_=complex_)
    xtrue, b = make_rhs(a, seed=which)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, grid=sub)
    resid = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
    return dict(which=which, grid=(sub.nprow, sub.npcol), rank=sub.rank,
                world=ranks[which], info=int(info), resid=resid,
                err=inf_norm_error(x, xtrue), berr=stats.solve_report.berr)


def run(ns, complex_: bool, name: str) -> int:
    """Both sub-grids' solves; 1 when a residual misses 1e-10."""
    import superlu_dist_tpu_torch as slt

    a, src = load_matrix(ns.matrix, complex_=complex_)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz} dtype={a.data.dtype}")
    rc = 0
    if ns.nproc < 2:
        for seed in (0, 1):      # one process: two plain solves
            xtrue, b = make_rhs(a, seed=seed)
            x, lu, stats, info = slt.gssvx(slt.Options(), a, b,
                                           device=ns.device)
            require(info == 0, f"info={info}")
            resid = report(f"{name} grid=None seed={seed}", a, b, x, xtrue,
                           stats)
            rc |= resid > 1e-10
        return int(rc)
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    out = run_mesh_ranks(ns.nproc, solve_on_subgrid, ns.matrix, complex_,
                         name, device=ns.device, timeout=600)
    for r in sorted(out):
        rec = out[r]
        require(rec["info"] == 0, f"rank {r}: info={rec['info']}")
        if rec["rank"] == 0:
            print(f"[{name} grid={rec['grid']} ranks={rec['world']} "
                  f"seed={rec['which']}] residual ||b-Ax||/||b|| = "
                  f"{rec['resid']:.3e}   ||x-xtrue||inf/||x||inf = "
                  f"{rec['err']:.3e}   berr {rec['berr']:.3e}")
        rc |= rec["resid"] > 1e-10
    return int(rc)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks to spawn and split into two sub-grids "
                         "(default 1: two plain solves in this process)")
    return run(ap.parse_args(argv), False, "pddrive4")


if __name__ == "__main__":
    raise SystemExit(main())
