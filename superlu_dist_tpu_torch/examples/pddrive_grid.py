#!/usr/bin/env python
"""Multi-process distributed-factors driver — the reference's canonical
``mpiexec -n 2 pddrive -r 1 -c 2 g20.rua`` flow (EXAMPLE/pddrive.c:29):
every process owns a block of rows of A and b, the factorization and
solves run SPMD over the process grid, and no process ever holds the
whole factor (SRC/pddistribute.c:322).  The port's counterpart of the
JAX package's ``examples/pddrive_grid.py``.

This launcher starts the worker below once per rank (the mpiexec role);
each worker joins the ``torch.distributed`` process group
(``parallel/mhboot.boot``: NCCL when every rank has its own card, gloo
when ranks share one or run on the CPU), attaches the shared-memory tree
domain for the host-side analysis collectives, and calls
``pgssvx(..., grid=...)``.

    python superlu_dist_tpu_torch/examples/pddrive_grid.py [matrix]
        [--nproc 2 | --nprow R --npcol C] [--device cpu|cuda] [--parsymb]
        [--resolve] [--pool-partition]

``--device`` defaults to the card (rank r on card r mod count); pass
``--device cpu`` to run on the CPU.  ``--parsymb`` selects the
distributed analysis (options ParSymbFact: parallel/panalysis.py) — no
rank assembles the full graph or does the full symbolic work.
``--resolve`` appends the reference's pddrive1 time-stepping loop: a
FACTORED re-solve with a new rhs on the SAME sharded factors, then a
SamePattern_SameRowPerm refactorization with new values (pddrive2).
``--nprow`` / ``--npcol`` lay the ranks out as the reference's -r / -c
process grid (default 1 × nproc) and run the 2-D mesh executor
(parallel/mesh_stream.py: each front's columns split over the process
columns, Options(executor="stream")); ``--pool-partition`` keeps each
Schur element only on the rank that extend-adds it
(Options(pool_partition=True)).  Without a matrix file the driver
solves poisson2d(20).
"""

import glob
import os
import socket
import subprocess
import sys

_WORKER = r"""
import dataclasses
import sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
shm = sys.argv[4]; path = sys.argv[5]; device = sys.argv[6]
parsymb = sys.argv[7] == "1"; resolve = sys.argv[8] == "1"
nprow = int(sys.argv[9]); partition = sys.argv[10] == "1"
two_d = sys.argv[11] == "1"
from superlu_dist_tpu_torch.parallel.mhboot import attach_tree, boot
booted = boot(nproc, pid, port, device=None if device == "cuda" else device)
import numpy as np
from superlu_dist_tpu_torch.parallel.dist import distribute_rows
from superlu_dist_tpu_torch.parallel.grid import gridinit
from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
from superlu_dist_tpu_torch.utils.options import Fact, Options

if path == "@poisson2d":
    from superlu_dist_tpu_torch.models.gallery import poisson2d
    a = poisson2d(20)
else:
    from superlu_dist_tpu_torch.io import read_matrix
    a = read_matrix(path).tocsr()
n = a.n_rows
tc = attach_tree(shm, nproc, pid, max_len=1 << 16)
grid = gridinit(nprow, nproc // nprow, device=booted.device, tc=tc)

# this rank's block rows only (the NR_loc shape)
mine = distribute_rows(a, nproc)[pid]
rows = slice(mine.fst_row, mine.fst_row + mine.m_loc)
xt = np.random.default_rng(0).standard_normal(n)
b = a.matvec(xt)
mesh = dict(executor="stream", pool_partition=partition) if two_d else {}
opts = Options(par_symb_fact=parsymb, **mesh)
out = {}
x, info = pgssvx(tc, opts, mine, b[rows], grid=grid, lu_out=out)
assert info == 0, info
resid = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
num = out["lu"].numeric
held = sum(lp.shape[0] for lp, _ in num.fronts)
total = sum(g.batch for g in num.plan.groups)
ex = num.executor
print(f"rank {pid}: residual {resid:.2e}; holds {held} of {total} front "
      f"slots ({booted.backend} on {booted.device})"
      + (" [ParSymbFact analysis]" if parsymb else "")
      + (f" [{grid.nprow}x{grid.npcol} {ex['executor']}, pool "
         f"{ex['pool_bytes']} B, {ex['bcasts']} row broadcasts]"
         if two_d else ""), flush=True)
assert resid < 1e-10, resid
assert nproc == 1 or held < total          # factors span the ranks

if resolve:
    # pddrive1: same factors, new rhs — collective solve only
    lu = out["lu"]
    b2 = a.matvec(xt * 3.0)
    x2, info2 = pgssvx(tc, Options(fact=Fact.FACTORED, **mesh), mine,
                       b2[rows], grid=grid, lu=lu)
    assert info2 == 0
    r2 = float(np.linalg.norm(b2 - a.matvec(x2)) / np.linalg.norm(b2))
    assert r2 < 1e-10, r2
    if parsymb:
        # a panalyze skeleton records no value-gather map, so the
        # SamePattern tiers are serial-analysis-only
        print(f"rank {pid}: FACTORED re-solve {r2:.2e}", flush=True)
    else:
        # pddrive2: same pattern + row perm, NEW VALUES — refactor with
        # the analysis products reused
        mine2 = dataclasses.replace(mine, data=np.asarray(mine.data) * 1.5)
        a2 = a.__class__(n, n, a.indptr, a.indices, a.data * 1.5)
        b3 = a2.matvec(xt)
        out3 = {}
        x3, info3 = pgssvx(tc, Options(fact=Fact.SamePattern_SameRowPerm,
                                       **mesh),
                           mine2, b3[rows], grid=grid, lu=lu, lu_out=out3)
        assert info3 == 0
        r3 = float(np.linalg.norm(b3 - a2.matvec(x3)) / np.linalg.norm(b3))
        st = out3["stats"]
        print(f"rank {pid}: FACTORED re-solve {r2:.2e}; SamePattern refactor "
              f"{r3:.2e} (SYMBFACT {st.utime['SYMBFACT']:.2f}s)", flush=True)
        assert r3 < 1e-10, r3

tc.close(unlink=pid == 0)
from superlu_dist_tpu_torch.parallel.mhboot import shutdown
shutdown()
"""


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matrix", nargs="?", default=None,
                    help="matrix file (HB/RB/MM); default poisson2d(20)")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--nprow", type=int, default=None,
                    help="process rows (with --npcol: the 2-D mesh "
                         "executor on an nprow x npcol grid)")
    ap.add_argument("--npcol", type=int, default=None,
                    help="process columns")
    ap.add_argument("--pool-partition", action="store_true",
                    help="keep each Schur element only on the rank that "
                         "extend-adds it (implies the 2-D executor)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the ranks' devices: the cards (default) or the CPU")
    ap.add_argument("--parsymb", action="store_true",
                    help="distributed analysis (options ParSymbFact)")
    ap.add_argument("--resolve", action="store_true",
                    help="append the pddrive1/2 reuse legs")
    ns = ap.parse_args(argv)
    two_d = (ns.nprow is not None or ns.npcol is not None
             or ns.pool_partition)
    nprow = ns.nprow or 1
    if two_d:
        ns.nproc = nprow * (ns.npcol or 1)
    path = ns.matrix or "@poisson2d"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import tempfile
    shm = f"/slt_exgrid_{os.getpid()}"
    rc = 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as td:
        wf = os.path.join(td, "worker.py")
        with open(wf, "w") as fh:
            fh.write(_WORKER)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        procs = [subprocess.Popen(
            [sys.executable, wf, str(i), str(ns.nproc), str(port), shm, path,
             ns.device, "1" if ns.parsymb else "0",
             "1" if ns.resolve else "0", str(nprow),
             "1" if ns.pool_partition else "0", "1" if two_d else "0"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(ns.nproc)]
        try:
            for i, p in enumerate(procs):
                out, _ = p.communicate(timeout=480)
                txt = out.decode()
                lines = [ln for ln in txt.strip().splitlines()
                         if ln.startswith("rank ")]
                print("\n".join(lines) if lines and p.returncode == 0
                      else f"rank {i}: exit {p.returncode}\n{txt}")
                rc |= p.returncode
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for leftover in glob.glob(f"/dev/shm/*{shm.strip('/')}*"):
                try:
                    os.unlink(leftover)
                except OSError:
                    pass
    if rc:
        print("pddrive_grid FAILED: a rank failed")
        return 1
    print("pddrive_grid OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
