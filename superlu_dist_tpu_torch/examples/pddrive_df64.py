#!/usr/bin/env python
"""Double-precision factors on the card — ``factor_dtype="df64"``.

The JAX package's ``examples/pddrive_df64.py`` tells the TPU's story: no
float64 unit, so "df64" factors in double-float (hi/lo float32 pairs,
about 2^-48).  An H100 has float64 in hardware (67 TFLOP/s on its tensor
cores by NVIDIA's data sheet), and an emulated double would cost several
float32 operations per float64 one, so the port runs "df64" as IEEE
float64 (2^-53): the option keeps the caller's string, and the factors,
Stats and the solve report are float64.  Past the float32+IR boundary
(kappa * 2^-24 > 1) those factors still deliver.  This example builds a
kappa ~ 1e7 system and compares raw factor quality (no equilibration, no
refinement, and no recovery ladder: on the card a NOREFINE solve of
float32 factors at the TF32 tier is probed and escalated to float64
factors, which would hide the float32 factors' own residual) between
float32 and "df64".

    python -m superlu_dist_tpu_torch.examples.pddrive_df64 [--device cpu]
"""

import numpy as np

from superlu_dist_tpu_torch.examples._common import parser, require


def solve_both(device):
    """The kappa ~ 1e7 system and x and the raw-factor residual of each
    factor dtype: (A, b, {dtype: (x, residual)})."""
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson2d

    a0 = poisson2d(10)
    s = np.logspace(0, 7, a0.n_rows)          # kappa ~ 1e7
    rows = np.repeat(np.arange(a0.n_rows), np.diff(a0.indptr))
    a = slt.SparseCSR(a0.n_rows, a0.n_cols, a0.indptr, a0.indices,
                      a0.data * s[rows])
    xt = np.random.default_rng(0).standard_normal(a.n_rows)
    b = a.matvec(xt)
    opt = dict(equil=False, iter_refine=slt.IterRefine.NOREFINE,
               recovery=slt.RecoveryPolicy(enabled=False))

    results = {}
    for dt in ("float32", "df64"):
        x, lu, stats, info = slt.gssvx(slt.Options(factor_dtype=dt, **opt),
                                       a, b, device=device)
        require(info == 0, f"{dt}: info={info}")
        resid = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
        results[dt] = (x, resid)
        print(f"[pddrive_df64] {dt:8s} raw-factor residual {resid:.3e} "
              f"(factors {stats.solve_report.factor_dtype})")
    return a, b, results


def main(argv=None):
    ns = parser(__doc__).parse_args(argv)
    _, _, results = solve_both(ns.device)
    r32, r64 = results["float32"][1], results["df64"][1]
    require(r64 < 1e-11, f"df64 residual {r64}")
    require(r64 < r32 / 1e3,
            f"df64 {r64} not 1000x below float32 {r32}")
    print("[pddrive_df64] residual check PASS: df64 runs native float64 "
          "factors")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
