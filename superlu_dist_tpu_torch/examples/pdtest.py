#!/usr/bin/env python
"""pdtest — the reference's sweep-test harness as a runner of the port.

The port's counterpart of the JAX package's ``scripts/pdtest.py``
(TEST/pdtest.c + TEST/CMakeLists.txt:9-52 + .travis_tests.sh:13-28 in
the reference): cross grid shapes × nrhs × (equilibration, row
permutation) × the Fact-reuse tiers (DOFACT → FACTORED → SamePattern →
SamePattern_SameRowPerm) over the reference's fixtures (g20.rua,
big.rua, cg20.cua, given with ``-f``; without them the gallery stand-ins
of their sizes, as the JAX package makes them), check every solve
against the reference's residual test

    resid = ||b − A·x||∞ / (||A||∞ · ||x||∞ · ε · m)  <  THRESH = 20
    (TEST/pdcompute_resid.c:18, TEST/pdtest.c:40)

and print a PrintSumm-style per-driver summary (TEST/pdtest.c:84).

A 1×1 grid runs in this process; a larger R×C grid runs as R·C spawned
ranks of a ``torch.distributed`` world (``testing/ranks.run_mesh_ranks``:
gloo when they share a card or run on the CPU), every rank calling
``gssvx(grid=)`` with the factors sharded over the grid — the reference's
mpiexec ranks, where the JAX package uses virtual devices of one process.
``--device`` puts the factors on the card (the default) or the CPU.
The JSON summary is written only to ``--out PATH``.

    python -m superlu_dist_tpu_torch.examples.pdtest --quick [--device cpu]
    python -m superlu_dist_tpu_torch.examples.pdtest -f g20.rua --grids 1x1,2x2 --nrhs 1,3 -x 8 -m 20
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback

import numpy as np

THRESH = 20.0                    # TEST/pdtest.c:40
#: the fixtures' gallery stand-ins: poisson2d of the fixture's size
_STAND_IN = {"g20.rua": 20, "big.rua": 70, "cg20.cua": 20}


def load_fixture(name):
    """(matrix, tag): the gallery stand-in of a reference fixture —
    ``poisson2d(n)``, with random phases for the complex one (seed 1)."""
    from superlu_dist_tpu_torch.models.gallery import poisson2d
    from superlu_dist_tpu_torch.sparse.formats import SparseCSR
    n = _STAND_IN.get(name, 20)
    a = poisson2d(n)
    cplx = name.endswith(".cua")
    if cplx:
        rng = np.random.default_rng(1)
        a = SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                      a.data * np.exp(1j * rng.uniform(0, 2 * np.pi, a.nnz)))
    return a, f"@poisson2d({n}){'c' if cplx else ''}"


def resid_ratio(a, x, b) -> float:
    """pdcompute_resid analog (TEST/pdcompute_resid.c:18)."""
    r = b - a.matvec(x)
    anorm = a.norm_max()
    xnorm = np.max(np.abs(x))
    eps = np.finfo(np.float64).eps
    denom = max(anorm * xnorm * eps * a.n_rows, 1e-300)
    return float(np.max(np.abs(r)) / denom)


def one_config(a, grid, nrhs, relax, maxsuper, equil, rowperm, rows,
               device="cuda"):
    """The pdtest.c inner loop: DOFACT → FACTORED → SamePattern →
    SamePattern_SameRowPerm through one configuration, each solve
    residual-checked (on ``grid``'s ranks when given, else on
    ``device``).  Appends a row per tier to ``rows``; returns (nrun,
    nfail)."""
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.sparse.formats import SparseCSR
    from superlu_dist_tpu_torch.utils.options import Fact, Options, RowPerm

    n = a.n_rows
    rng = np.random.default_rng(0)
    if np.issubdtype(a.data.dtype, np.complexfloating):
        xt = rng.standard_normal((n, nrhs)) + 1j * rng.standard_normal(
            (n, nrhs))
    else:
        xt = rng.standard_normal((n, nrhs))
    if nrhs == 1:
        xt = xt[:, 0]
    b = (np.stack([a.matvec(xt[:, j]) for j in range(nrhs)], axis=1)
         if nrhs > 1 else a.matvec(xt))

    base = Options(relax=relax, max_supernode=maxsuper, equil=equil,
                   row_perm=RowPerm.LargeDiag_MC64 if rowperm else
                   RowPerm.NOROWPERM)
    where = dict(grid=grid) if grid is not None else dict(device=device)
    nrun = nfail = 0

    def check(tag, x, aa, bb):
        nonlocal nrun, nfail
        nrun += 1
        rr = (max(resid_ratio(aa, x[:, j], bb[:, j]) for j in range(nrhs))
              if nrhs > 1 else resid_ratio(aa, x, bb))
        ok = rr < THRESH
        if not ok:
            nfail += 1
        rows.append({"tag": tag, "resid_ratio": round(rr, 3), "pass": ok})

    def failed(tag, info):
        """A tier that errored (info != 0) is a counted failure: it
        reaches nrun/nfail (PrintSumm and the exit code), not only the
        rows."""
        nonlocal nrun, nfail
        nrun += 1
        nfail += 1
        rows.append({"tag": tag, "info": int(info), "pass": False})

    # DOFACT
    x, lu, stats, info = slt.gssvx(base, a, b, **where)
    if info != 0:
        failed("DOFACT", info)
        return nrun, nfail
    check("DOFACT", x, a, b)

    # FACTORED: same factors, new b
    b2 = 2.0 * b
    x, _, _, info = slt.gssvx(
        dataclasses.replace(base, fact=Fact.FACTORED), a, b2, lu=lu)
    check("FACTORED", x, a, b2) if info == 0 else failed("FACTORED", info)

    # SamePattern: new values, same pattern (fresh row perm computed)
    a2 = SparseCSR(n, n, a.indptr, a.indices, a.data * 1.5)
    x, lu2, _, info = slt.gssvx(
        dataclasses.replace(base, fact=Fact.SamePattern), a2, b, lu=lu,
        grid=grid)
    check("SamePattern", x, a2, b) if info == 0 else failed(
        "SamePattern", info)

    # SamePattern_SameRowPerm: scalings + perms + symbolic all reused
    a3 = SparseCSR(n, n, a.indptr, a.indices, a.data * 0.75)
    x, _, _, info = slt.gssvx(
        dataclasses.replace(base, fact=Fact.SamePattern_SameRowPerm),
        a3, b, lu=lu2 if lu2 is not None else lu, grid=grid)
    check("SameRowPerm", x, a3, b) if info == 0 else failed(
        "SameRowPerm", info)
    return nrun, nfail


#: the (equil, rowperm) pairs of the sweep
EQUIL_ROWPERM = ((True, True), (False, True), (True, False))


def configs(a, grid, nrhss, relax, maxsuper, device="cuda"):
    """Every (nrhs, equil, rowperm) configuration on one grid: a list of
    (nrhs, equil, rowperm, nrun, nfail, rows)."""
    out = []
    for nrhs in nrhss:
        for equil, rowperm in EQUIL_ROWPERM:
            rows = []
            n1, f1 = one_config(a, grid, nrhs, relax, maxsuper, equil,
                                rowperm, rows, device=device)
            out.append((nrhs, equil, rowperm, n1, f1, rows))
    return out


def grid_configs(tc, grid, a, nrhss, relax, maxsuper):
    """What every spawned rank of an R×C grid runs: ``configs`` on the
    grid (the ranks' results agree; rank 0's is kept)."""
    return configs(a, grid, nrhss, relax, maxsuper)


def print_summ(typ, nfail, nrun, nerrs):
    """PrintSumm analog (TEST/pdtest.c:84)."""
    if nfail > 0:
        print(f"{typ:>3s} driver: {nfail} out of {nrun} tests failed "
              "to pass the threshold")
    else:
        print(f"All tests for {typ:>3s} driver passed the threshold "
              f"({nrun:6d} tests run)")
    if nerrs > 0:
        print(f"{nerrs:6d} error messages recorded")


#: .travis_tests.sh configs 9-15: the example drivers double as
#: integration tests of the Fact-reuse tiers (each on its default matrix)
TRAVIS = ("pddrive1", "pddrive2", "pddrive3", "pzdrive", "pddrive_ABglobal")


def run_examples(device):
    """The --travis examples in this process: [(name, passed, seconds)]."""
    import importlib
    out = []
    for name in TRAVIS:
        mod = importlib.import_module(
            f"superlu_dist_tpu_torch.examples.{name}")
        t1 = time.perf_counter()
        try:
            ok = mod.main(["--device", device]) == 0
        except Exception:        # a failed example is a counted failure
            traceback.print_exc()
            ok = False
        out.append((name, ok, time.perf_counter() - t1))
        print(f"[pdtest] example {name}: {'ok' if ok else 'FAIL'}",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="pdtest-style sweep harness (TEST/pdtest.c analog)")
    ap.add_argument("-f", "--file", action="append", default=None,
                    help="matrix file(s); default: the fixtures' stand-ins")
    ap.add_argument("--grids", default="1x1,1x3,2x1,2x3",
                    help="comma list of RxC process grids (the travis "
                         "pdtest set by default)")
    ap.add_argument("--nrhs", default="1,3")
    ap.add_argument("-x", "--relax", type=int, default=8)
    ap.add_argument("-m", "--maxsuper", type=int, default=20)
    ap.add_argument("-b", "--fill", type=int, default=2,
                    help="accepted for pdtest CLI parity; fill is "
                         "estimated dynamically here")
    ap.add_argument("--quick", action="store_true",
                    help="g20 only, 1x1 and 1x2 grids")
    ap.add_argument("--travis", action="store_true",
                    help="also run the example drivers of .travis_tests.sh "
                         "configs 9-15")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    ap.add_argument("--out", default=None,
                    help="write the JSON summary to this path")
    ns = ap.parse_args(argv)
    from superlu_dist_tpu_torch.utils.options import resolve_device
    resolve_device(ns.device)

    grids = [tuple(int(v) for v in spec.strip().split("x"))
             for spec in ns.grids.split(",")]
    if ns.quick:
        grids = [(1, 1), (1, 2)]
    nrhss = [int(s) for s in ns.nrhs.split(",")]
    if ns.file:
        from superlu_dist_tpu_torch.io import read_matrix
        fixtures = [(read_matrix(p).tocsr(), p) for p in ns.file]
    else:
        names = ["g20.rua"] if ns.quick else ["g20.rua", "big.rua",
                                              "cg20.cua"]
        fixtures = [load_fixture(n) for n in names]

    t0 = time.perf_counter()
    all_rows = []
    summary = {}
    for a, name in fixtures:
        typ = ("ZGS" if np.issubdtype(a.data.dtype, np.complexfloating)
               else "DGS")
        nrun = nfail = 0
        for (r, c) in grids:
            if r * c == 1:
                res = configs(a, None, nrhss, ns.relax, ns.maxsuper,
                              device=ns.device)
            else:
                from superlu_dist_tpu_torch.testing.ranks import (
                    run_mesh_ranks)
                res = run_mesh_ranks(r * c, grid_configs, a, nrhss, ns.relax,
                                     ns.maxsuper, device=ns.device,
                                     nprow=r, timeout=1200)[0]
            for nrhs, equil, rowperm, n1, f1, rows in res:
                nrun += n1
                nfail += f1
                for row in rows:
                    row.update(matrix=name, grid=f"{r}x{c}", nrhs=nrhs,
                               equil=equil, rowperm=rowperm)
                all_rows.extend(rows)
                mark = "ok" if f1 == 0 else f"FAIL({f1})"
                print(f"[pdtest] {name} {r}x{c} s={nrhs} "
                      f"equil={int(equil)} rowperm={int(rowperm)} "
                      f"x={ns.relax} m={ns.maxsuper}: {n1} runs {mark}",
                      flush=True)
        prev = summary.get(typ, (0, 0))
        summary[typ] = (prev[0] + nfail, prev[1] + nrun)

    examples = []
    if ns.travis:
        for ex, ok, sec in run_examples(ns.device):
            examples.append({"example": ex, "pass": ok,
                             "seconds": round(sec, 1)})
            typ = "ZGS" if ex.startswith("pz") else "DGS"
            f0, r0 = summary.get(typ, (0, 0))
            summary[typ] = (f0 + (not ok), r0 + 1)

    print()
    for typ, (nfail, nrun) in sorted(summary.items()):
        print_summ(typ, nfail, nrun, 0)
    seconds = time.perf_counter() - t0
    out = {"thresh": THRESH, "relax": ns.relax, "maxsuper": ns.maxsuper,
           "grids": [f"{r}x{c}" for r, c in grids], "nrhs": nrhss,
           "device": ns.device, "seconds": seconds,
           "summary": {t: {"nfail": f, "nrun": r}
                       for t, (f, r) in summary.items()},
           "examples": examples, "rows": all_rows}
    if ns.out:
        with open(ns.out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"\nwrote {ns.out} ({seconds:.1f}s)")
    return 1 if any(f for f, _ in summary.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
