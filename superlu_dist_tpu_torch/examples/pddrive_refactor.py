#!/usr/bin/env python
"""Time-stepping gallery driver — the middle rung of the Fact ladder as a
workload: factor ONCE, then ``slt.refactor(lu, values)`` every step of a
drifting-values sequence (the implicit time-integrator pattern: the
Jacobian's sparsity is fixed by the mesh, only its values move with the
state).  The port's counterpart of the JAX package's
``examples/pddrive_refactor.py``.

The driver asserts, as the JAX driver does, ``symbolic_seconds == 0``
and ``compile_fresh_seconds == 0.0`` on every step after the first: the
step's ``Stats.utime["SYMBFACT"]`` is 0, and its ``stats.compile``
(the build census of the refactor's factorization, obs/compilestats.py)
has no fresh seconds — no kernel was built and no executor's graph was
captured again.  It also asserts that the handle keeps its symbolic
structure and plan (object identity) and that the plan's cached factor
executors (``numeric.factor.cached_executors``) are the same objects
before and after the step.  (The solve's CUDA graphs belong to the
solver of the factors, which each new set of factors replaces; they
are captured in the solve, outside the factorization's census.)  One
bench-style JSON row records the per-step numeric cost next to the
one-time analysis cost.

    python -m superlu_dist_tpu_torch.examples.pddrive_refactor [matrix] [--device cpu]
"""

import json
import time

import numpy as np

from superlu_dist_tpu_torch.examples._common import (load_matrix, make_rhs,
                                                     parser, report, require)

N_STEPS = 6


def run_sequence(slt, name, a, device, n_steps=N_STEPS):
    """Factor once, refactor per step over drifting values; returns the
    per-step record of the reuse invariants."""
    from superlu_dist_tpu_torch.numeric.factor import cached_executors

    xtrue, b = make_rhs(a)
    t0 = time.perf_counter()
    x, lu, stats0, info = slt.gssvx(slt.Options(), a, b, device=device)
    factor_s = time.perf_counter() - t0
    require(info == 0, f"info={info}")
    resid = report(f"{name} step 0 (DOFACT)", a, b, x, xtrue, stats0)
    require(resid < 1e-8, f"residual {resid}")

    rng = np.random.default_rng(7)
    steps = []
    for step in range(1, n_steps):
        # drift the values, keep the pattern (a time step of an implicit
        # integrator: same mesh, new state)
        vals = a.data * (1.0 + 0.05 * rng.standard_normal(a.nnz))
        a_k = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices, vals)
        xtrue_k, b_k = make_rhs(a_k, seed=step)
        sf, plan = lu.sf, lu.plan
        executors = cached_executors(plan)
        st = slt.Stats()
        t1 = time.perf_counter()
        slt.refactor(lu, a_k, stats=st)
        refactor_s = time.perf_counter() - t1
        x_k, lu, st2, info = slt.gssvx(
            slt.Options(fact=slt.Fact.FACTORED), a_k, b_k, lu=lu)
        require(info == 0, f"step {step}: info={info}")
        symbolic_s = float(st.utime.get("SYMBFACT", 0.0))
        new_executors = [e for e in cached_executors(lu.plan)
                         if not any(e is f for f in executors)]
        # the reuse invariants, asserted — not a timing proxy
        require(symbolic_s == 0.0, "refactor re-ran symbolic analysis")
        require(lu.sf is sf and lu.plan is plan,
                "refactor replaced the symbolic structure or the plan")
        require(executors and not new_executors,
                f"refactor built {len(new_executors)} new executor(s)")
        fresh_s = float(st.compile["fresh_seconds"])
        require(fresh_s == 0.0, f"refactor built or captured for {fresh_s} s")
        resid = report(f"{name} step {step} (refactor)", a_k, b_k, x_k,
                       xtrue_k, st2)
        require(resid < 1e-8, f"step {step}: residual {resid}")
        steps.append({"step": step, "refactor_seconds": round(refactor_s, 4),
                      "symbolic_seconds": symbolic_s,
                      "new_executors": len(new_executors),
                      "compile_fresh_seconds": fresh_s})
    return {"matrix": name, "n": a.n_rows, "nnz": a.nnz,
            "factor_seconds": round(factor_s, 4), "steps": steps}


def main(argv=None):
    ns = parser(__doc__).parse_args(argv)
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import hilbert

    a, src = load_matrix(ns.matrix)
    print(f"matrix: {src}  n={a.n_rows} nnz={a.nnz}")
    rows = [run_sequence(slt, src, a, ns.device)]
    # a second, dense-pattern sequence: drifting Hilbert-like values
    rows.append(run_sequence(slt, "hilbert(24)", hilbert(24), ns.device,
                             n_steps=4))
    # one bench-style JSON row (a single machine-readable line a sweep
    # harness can collect)
    print("BENCH_ROW " + json.dumps(
        {"workload": "timestep-refactor", "device": ns.device,
         "rows": rows}, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
