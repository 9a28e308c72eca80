"""Command-line driver — the pddrive / pdtest analog.

Solve A·X = B for a matrix file from the shell with a PStatPrint-style
report (reference EXAMPLE/pddrive.c:51-238), or sweep option combinations
pdtest-style (reference TEST/pdtest.c: fact modes × orderings × nrhs on
one matrix, failures counted and summarized).  A port of the JAX
package's ``__main__.py``; ``--device`` takes the place of its
``--backend`` and defaults to the card.

Examples:
  python -m superlu_dist_tpu_torch -f g20.rua
  python -m superlu_dist_tpu_torch -f big.mtx --nrhs 3 --colperm MMD --dtype float64
  python -m superlu_dist_tpu_torch -f g20.rua --sweep        # pdtest-style matrix
  python -m superlu_dist_tpu_torch -f g20.rua --device cpu --trans

Exit codes: 0 when every solve's scaled residual is below
``tols.RESID_GATE``, 1 otherwise (or on a zero pivot), 2 for a malformed
command line.  ``--dtype df64`` factors in float64 (the card's native
double; the JAX package's df64 is emulated).
Without a card the default ``--device cuda`` raises: only ``--device
cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.options import (FACTOR_DTYPE_ALIASES,
                                                  FACTOR_DTYPES)


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m superlu_dist_tpu_torch",
        description="sparse direct solve on an NVIDIA GPU (pddrive analog)")
    p.add_argument("-f", "--file", required=True,
                   help="matrix file (.rua/.rb/.mtx/.triple/.bin "
                        "auto-detected)")
    p.add_argument("-s", "--nrhs", type=int, default=1,
                   help="number of right-hand sides (pdtest -s)")
    p.add_argument("--colperm", default="METIS_AT_PLUS_A",
                   choices=["NATURAL", "MMD", "MMD_AT_PLUS_A", "MMD_ATA",
                            "COLAMD", "ND", "METIS_AT_PLUS_A"],
                   help="fill-reducing column ordering")
    p.add_argument("--rowperm", default="MC64",
                   choices=["NOROWPERM", "MC64", "LargeDiag_MC64",
                            "AWPM", "LargeDiag_AWPM"],
                   help="numerical row pivoting strategy")
    p.add_argument("--no-equil", action="store_true",
                   help="disable equilibration (pdtest -e)")
    p.add_argument("--no-refine", action="store_true",
                   help="disable iterative refinement")
    p.add_argument("--trans", action="store_true", help="solve A^T X = B")
    p.add_argument("--dtype", default=None,
                   choices=[*FACTOR_DTYPES, *FACTOR_DTYPE_ALIASES],
                   help="factorization dtype (default: float32 on the card, "
                        "float64 on the CPU; complex matrices take the "
                        "complex type of that width; df64 runs float64)")
    p.add_argument("-x", "--relax", type=int, default=None,
                   help="supernode relaxation (sp_ienv(2) / pdtest -x)")
    p.add_argument("--amalg-tol", type=float, default=None,
                   help="fill-tolerant supernode amalgamation tolerance "
                        "(0 disables)")
    p.add_argument("-m", "--maxsuper", type=int, default=None,
                   help="max supernode size (sp_ienv(3) / pdtest -m)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the factorization and the solves run "
                        "(default: the card; without one, cuda raises)")
    p.add_argument("--seed", type=int, default=0, help="xtrue RNG seed")
    p.add_argument("--sweep", action="store_true",
                   help="pdtest-style sweep: Fact tiers x orderings x nrhs")
    p.add_argument("--stats", action="store_true",
                   help="print the full PStatPrint analog after the run: "
                        "Stats.report() plus the SolveReport health "
                        "summary")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the PStatPrint report")
    return p


def _options(args, **overrides):
    from superlu_dist_tpu_torch.utils.options import (ColPerm, IterRefine,
                                                      Options, RowPerm, Trans)
    kw = dict(
        equil=not args.no_equil,
        col_perm={"NATURAL": ColPerm.NATURAL,
                  "MMD": ColPerm.MMD_AT_PLUS_A,
                  "MMD_AT_PLUS_A": ColPerm.MMD_AT_PLUS_A,
                  "MMD_ATA": ColPerm.MMD_ATA,
                  "COLAMD": ColPerm.COLAMD,
                  "ND": ColPerm.ND_AT_PLUS_A,
                  "METIS_AT_PLUS_A": ColPerm.ND_AT_PLUS_A}[args.colperm],
        row_perm={"NOROWPERM": RowPerm.NOROWPERM,
                  "MC64": RowPerm.LargeDiag_MC64,
                  "LargeDiag_MC64": RowPerm.LargeDiag_MC64,
                  "AWPM": RowPerm.LargeDiag_AWPM,
                  "LargeDiag_AWPM": RowPerm.LargeDiag_AWPM}[args.rowperm],
        iter_refine=(IterRefine.NOREFINE if args.no_refine
                     else IterRefine.SLU_DOUBLE),
        trans=Trans.TRANS if args.trans else Trans.NOTRANS,
    )
    if args.dtype:
        kw["factor_dtype"] = args.dtype
    if args.relax is not None:
        kw["relax"] = args.relax
    if args.maxsuper is not None:
        kw["max_supernode"] = args.maxsuper
    if args.amalg_tol is not None:
        kw["amalg_tol"] = args.amalg_tol
    kw.update(overrides)
    return Options(**kw)


def _fabricate(a, nrhs, seed, trans=False):
    """xtrue + b = A·xtrue, like the EXAMPLE drivers
    (dcreate_matrix.c:147-148)."""
    from superlu_dist_tpu_torch.utils.precision import fill_rhs, gen_xtrue
    xtrue = gen_xtrue(a.n_rows, nrhs, a.data.dtype, seed)
    return xtrue, fill_rhs(a, xtrue, trans=trans)


def _resid(a, x, b, trans=False):
    op = a.transpose() if trans else a
    r = b - op.matvec(x)
    return float(np.linalg.norm(np.ravel(r))
                 / max(float(np.linalg.norm(np.ravel(b))), 1e-300))


def run_once(a, args) -> int:
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.utils.precision import inf_norm_error

    opts = _options(args)
    xtrue, b = _fabricate(a, args.nrhs, args.seed, trans=args.trans)
    t0 = time.perf_counter()
    x, lu, stats, info = slt.gssvx(opts, a, b, device=args.device)
    wall = time.perf_counter() - t0
    if info != 0:
        print(f"FAILED: info = {info} (first zero pivot, 1-based)")
        return 1
    res = _resid(a, x, b, trans=args.trans)
    err = inf_norm_error(x, xtrue)
    if not args.quiet or args.stats:
        print(stats.report())
        if args.stats and stats.solve_report is not None:
            # the SolveReport on its own line (report() embeds it in
            # "solve health:"; --stats promises the explicit summary)
            print(f"    solve report: {stats.solve_report.summary()}")
        berr = lu.berrs[-1] if lu.berrs else None
        print(f"    residual ||b-Ax||/||b||  {res:.3e}")
        print(f"    ||x-xtrue||_inf/||x||_inf {err:.3e}"
              f"   (pdinf_norm_error analog)")
        if berr is not None:
            print(f"    backward error (IR)      {berr:.3e}")
        print(f"    total wall time          {wall:.4f} s")
    ok = res < tols.RESID_GATE
    if not ok:
        print(f"RESIDUAL TOO LARGE: {res:.3e}")
    return 0 if ok else 1


def run_sweep(a, args) -> int:
    """pdtest analog: cross Fact tiers x nrhs x equil, then the orderings;
    count failures."""
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.utils.options import ColPerm, Fact, Trans

    n_pass = n_fail = 0
    rows = []

    def attempt(label, opts, nrhs, seed, lu=None):
        """One gssvx of the sweep; a failure is counted and the sweep
        goes on (pdtest's behaviour)."""
        nonlocal n_pass, n_fail
        _, b = _fabricate(a, nrhs, seed)
        try:
            x, lu, _, info = slt.gssvx(opts, a, b, device=args.device, lu=lu)
            res = _resid(a, x, b) if info == 0 else np.inf
            ok = info == 0 and res < tols.RESID_GATE
        except Exception as e:          # robustness: keep sweeping
            res, ok = float("nan"), False
            print(f"  exception in {label}: {type(e).__name__}: {e}")
        n_pass += ok
        n_fail += not ok
        return lu, res, ok

    for equil in (True, False):
        for nrhs in (1, 3):
            lu = None
            for fact in (Fact.DOFACT, Fact.SamePattern,
                         Fact.SamePattern_SameRowPerm, Fact.FACTORED):
                # the sweep fabricates b = A·xtrue and checks the
                # untransposed residual: trans is off whatever the
                # top-level flag (run_once handles --trans)
                opts = _options(args, equil=equil, fact=fact,
                                trans=Trans.NOTRANS)
                lu, res, ok = attempt(fact.name, opts, nrhs,
                                      args.seed + nrhs, lu)
                rows.append((fact.name, "", equil, nrhs, res, ok))
    # the ordering axis (the pdtest parameter family's modern counterpart)
    for cp in (ColPerm.NATURAL, ColPerm.MMD_AT_PLUS_A, ColPerm.MMD_ATA,
               ColPerm.COLAMD, ColPerm.ND_AT_PLUS_A):
        opts = _options(args, equil=True, fact=Fact.DOFACT,
                        trans=Trans.NOTRANS, col_perm=cp)
        _, res, ok = attempt(f"colperm {cp.name}", opts, 1, args.seed)
        rows.append(("DOFACT", cp.name, True, 1, res, ok))
    print(f"{'Fact':<24}{'ColPerm':<16}{'Equil':<7}{'nrhs':<6}"
          f"{'residual':<12}ok")
    for name, cp, equil, nrhs, res, ok in rows:
        print(f"{name:<24}{cp:<16}{str(equil):<7}{nrhs:<6}{res:<12.3e}"
              f"{'PASS' if ok else 'FAIL'}")
    print(f"summary: {n_pass} passed, {n_fail} failed "
          f"(PrintSumm analog, TEST/pdtest.c:84)")
    return 0 if n_fail == 0 else 1


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from superlu_dist_tpu_torch.io import read_matrix
    from superlu_dist_tpu_torch.utils.options import resolve_device
    resolve_device(args.device)
    t0 = time.perf_counter()
    a = read_matrix(args.file).tocsr()
    print(f"matrix {args.file}: {a.n_rows}x{a.n_cols}, nnz={a.nnz}, "
          f"dtype={a.data.dtype}, read in {time.perf_counter() - t0:.3f} s")
    return run_sweep(a, args) if args.sweep else run_once(a, args)


if __name__ == "__main__":
    sys.exit(main())
