"""Central dtype-aware tolerance model — eps(dtype)×factor with provenance.

Every numerical threshold in the package and its CI gates — BERR
acceptance targets, residual gates, equivalence tolerances, convergence
tests — silently encodes a dtype assumption: ``berr < 1e-6`` is "about
4.5e9 ulps of f64" and "under half an ulp of bf16" at once.  slulint
SLU118 therefore bans ad-hoc float comparison literals in package code
and CI gates; this module is the one place a threshold may be minted.

A :class:`Tolerance` IS a float (drop-in in comparisons and
``assert_allclose`` kwargs) that additionally carries its derivation —
the dtype whose eps it scales, the factor, and a one-line ``why`` — so a
failing gate can render *what the threshold meant*, not just its value.

``eps`` understands the emulated double-float dtypes (``df64``/``zdf64``
are (hi, lo) f32 pairs with a ~48-bit significand, ops/df64.py) and the
16-bit MXU input dtypes alongside everything ``np.finfo`` knows.
"""

from __future__ import annotations

import numpy as np

#: unit roundoffs numpy cannot (or may not) resolve by itself: the
#: double-float pair formats (value = hi + lo, |lo| <= ulp(hi)/2 gives
#: ~2·24 significand bits) and the 16-bit float inputs of the MXU
#: (resolved here so ``eps("bfloat16")`` needs no ml_dtypes import).
_SPECIAL_EPS = {
    "df64": float(2.0 ** -48),
    "zdf64": float(2.0 ** -48),
    "bfloat16": float(2.0 ** -8),
    "float16": float(2.0 ** -10),
}

#: smallest normal of the CARRIER format (underflow guards): the
#: double-float hi word is an f32, so df64 denormalizes where f32 does.
_SPECIAL_TINY = {
    "df64": float(np.finfo(np.float32).tiny),
    "zdf64": float(np.finfo(np.float32).tiny),
}


def _canon(dtype) -> tuple:
    """(name, numpy dtype or None) — complex dtypes resolve to their
    component float (a complex tolerance bounds each component)."""
    if isinstance(dtype, str) and dtype.strip().lower() in _SPECIAL_EPS:
        return dtype.strip().lower(), None
    dt = np.dtype(dtype)
    if dt.kind == "c":
        dt = np.dtype(f"float{dt.itemsize * 4}")
    return dt.name, dt


def eps(dtype) -> float:
    """Unit roundoff of ``dtype``: ``np.finfo(...).eps`` for the float
    and complex dtypes numpy resolves, with ``df64``/``zdf64`` (~2^-48,
    the paired-f32 significand) and the 16-bit floats special-cased."""
    name, dt = _canon(dtype)
    if name in _SPECIAL_EPS:
        return _SPECIAL_EPS[name]
    if dt is None or dt.kind != "f":
        raise TypeError(f"eps() needs a float/complex dtype, got {dtype!r}")
    return float(np.finfo(dt).eps)


def safmin(dtype) -> float:
    """Smallest normal ("safe minimum", the reference's ``dmach('S')``)
    of ``dtype``'s carrier format — the underflow-guard companion of
    :func:`eps` (componentwise-BERR denominators, refine/ir.py)."""
    name, dt = _canon(dtype)
    if name in _SPECIAL_TINY:
        return _SPECIAL_TINY[name]
    if dt is None or dt.kind != "f":
        raise TypeError(
            f"safmin() needs a float/complex dtype, got {dtype!r}")
    return float(np.finfo(dt).tiny)


class Tolerance(float):
    """A float threshold that remembers its derivation.

    Behaves exactly like its value in comparisons and arithmetic;
    ``.dtype``/``.factor``/``.why`` carry the provenance and
    :meth:`describe` renders it for gate diagnostics."""

    __slots__ = ("dtype", "factor", "why")

    def __new__(cls, value, dtype: str, factor: float, why: str = ""):
        self = super().__new__(cls, value)
        self.dtype = str(dtype)
        self.factor = float(factor)
        self.why = str(why)
        return self

    def describe(self) -> str:
        out = f"{float(self):.3e} = {self.factor:g}*eps({self.dtype})"
        if self.why:
            out += f" [{self.why}]"
        return out

    def __repr__(self) -> str:  # failing asserts render the derivation
        return f"Tolerance({self.describe()})"


def tol(dtype, factor: float, why: str = "") -> Tolerance:
    """``factor × eps(dtype)`` as a provenance-carrying float.  Factors
    are the honest part of a threshold — prefer powers of two (an ulp
    budget), and say *why* in ``why``."""
    name, _ = _canon(dtype)
    return Tolerance(eps(dtype) * float(factor), name, factor, why)


def berr_target(dtype, factor: float = 10.0) -> Tolerance:
    """The componentwise-BERR acceptance target of the escalation ladder
    and the serving gate: ``10·eps`` of the residual dtype — the
    classical IR convergence bound (pdgsrfs stops at eps; one order of
    headroom keeps the gate off the stagnation boundary)."""
    return tol(dtype, factor,
               "componentwise-BERR acceptance (IR converges to ~eps of "
               "the residual dtype; 10x is the ladder's headroom)")


# --- named gate tolerances --------------------------------------------------
# The CI gates share these so a gate and the ladder can never disagree
# about what "f64-tight" means.  Factors are powers of two: an explicit
# ulp budget, not a decimal that happens to pass today.

#: cross-schedule solve drift: batch membership reorders lsum
#: scatter-adds, so schedules agree to a small multiple of eps — not
#: bitwise (docs/SERVING.md; was the hand-typed 1e-11/1e-13 pair)
SCHEDULE_DRIFT_RTOL = tol("float64", 2 ** 16,
                          "cross-schedule lsum reassociation budget")
SCHEDULE_DRIFT_ATOL = tol("float64", 2 ** 9,
                          "cross-schedule absolute floor")

#: device batched solve vs the scipy-grade host loop: blocked TRSM +
#: padded batching against sequential host sweeps (was 1e-9/1e-11)
DEVICE_VS_HOST_RTOL = tol("float64", 2 ** 22,
                          "device blocked-TRSM vs host supernodal solve")
DEVICE_VS_HOST_ATOL = tol("float64", 2 ** 16,
                          "device-vs-host absolute floor")

#: residual gate of the smoke drivers/CLI (`‖Ax−b‖/((‖A‖‖x‖+‖b‖)n)`
#: style scaled residuals on well-conditioned gallery matrices; was the
#: hand-typed 1e-8 / 1e-10 pair scattered across scripts)
RESID_GATE = tol("float64", 2 ** 26, "scaled-residual smoke gate")
RESID_GATE_TIGHT = tol("float64", 2 ** 19,
                       "scaled-residual gate, well-conditioned gallery")

#: Hager–Higham subgradient convergence test (refine/condest.onenormest,
#: dlacon.f:130 uses a tiny relative slack; was the hand-typed 1e-12)
ONENORMEST_SLACK = tol("float64", 2 ** 12,
                       "onenormest subgradient convergence slack")
