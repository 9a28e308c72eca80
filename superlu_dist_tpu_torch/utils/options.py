"""Solver options.

Mirrors the reference's runtime option struct ``superlu_dist_options_t``
(SRC/superlu_defs.h:628-657) and its defaults ``set_default_options_dist``
(SRC/util.c:376-401).  The values are the defaults the JAX package
resolves when no environment knob is set; the port has no knob registry.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Fact(enum.Enum):
    """Factorization reuse tiers (reference fact_t, superlu_defs.h:489-510)."""

    DOFACT = 0                      # factor from scratch
    SamePattern = 1                 # reuse column perm + symbolic + plan
    SamePattern_SameRowPerm = 2     # additionally reuse row perm + scalings
    FACTORED = 3                    # reuse the numeric factors (solve only)


class ColPerm(enum.Enum):
    """Fill-reducing column orderings (reference colperm_t; dispatch
    get_perm_c_dist, SRC/get_perm_c.c:463-530)."""

    NATURAL = 0
    MMD_AT_PLUS_A = 1       # minimum degree on pattern of A^T + A
    ND_AT_PLUS_A = 2        # nested dissection (METIS analog)
    METIS_AT_PLUS_A = 2     # alias: the reference default maps to our ND
    MY_PERMC = 3            # user-supplied permutation
    MMD_ATA = 4             # minimum degree on pattern of A^T A
    COLAMD = 5              # approximate column MD directly on A


class RowPerm(enum.Enum):
    """Numerical row pivoting strategy (reference rowperm_t;
    dldperm_dist, SRC/dldperm_dist.c:95)."""

    NOROWPERM = 0
    LargeDiag_MC64 = 1      # maximum-product weighted bipartite matching
    LargeDiag_AWPM = 2      # approximate-weight perfect matching
    MY_PERMR = 3


class IterRefine(enum.Enum):
    """Iterative refinement (reference IterRefine_t; pdgsrfs.c:120)."""

    NOREFINE = 0
    SLU_SINGLE = 1
    SLU_DOUBLE = 2


class Trans(enum.Enum):
    """Which system is solved through the factors of A (reference
    trans_t, superlu_defs.h:628-657): A·X = B, Aᵀ·X = B or Aᴴ·X = B."""

    NOTRANS = 0
    TRANS = 1
    CONJ = 2


@dataclasses.dataclass
class RecoveryPolicy:
    """Solver health and recovery (the pdgscon/pdgsrfs repair loop made
    automatic), with the JAX package's defaults.

    ``enabled`` drives the escalation ladder of drivers/gssvx.py: when
    refinement stagnates above ``berr_target`` (None: 10·eps of the
    residual dtype) the driver escalates the residual precision, the GEMM
    tier, the factor precision, and finally refactors with equilibration
    and MC64 forced on, recording every rung in the SolveReport (at most
    ``max_rungs``).  ``sentinels`` arms the isfinite checks on the factors
    and on the delivered solution.  ``condest`` says when rcond and ferr
    are estimated: "always", "never", or "auto" (when the ladder fired,
    tiny pivots were replaced, or refinement missed its target)."""

    enabled: bool = True
    sentinels: bool = True
    condest: str = "auto"              # "always" | "auto" | "never"
    berr_target: float | None = None   # None => 10·eps(residual dtype)
    max_rungs: int = 3                 # ladder depth cap


@dataclasses.dataclass
class Options:
    """Runtime options (analog of superlu_dist_options_t).

    Defaults follow set_default_options_dist (SRC/util.c:376-401):
    Fact=DOFACT, Equil=YES, ColPerm=METIS_AT_PLUS_A, RowPerm=LargeDiag_MC64,
    ReplaceTinyPivot, IterRefine=DOUBLE, plus the JAX package's blocking
    and scheduling defaults.  ``native``, ``symb_threads`` and
    ``nd_threads`` take the place of the JAX package's SLU_TPU_NO_NATIVE,
    SLU_TPU_SYMB_THREADS and SLU_TPU_ND_THREADS; ``gemm_prec``,
    ``solve_schedule``, ``solve_window`` and ``solve_align`` hold the
    values its SLU_TPU_GEMM_PREC and SLU_TPU_SOLVE_* knobs resolve to when
    unset.
    """

    fact: Fact = Fact.DOFACT
    equil: bool = True
    col_perm: ColPerm = ColPerm.ND_AT_PLUS_A
    row_perm: RowPerm = RowPerm.LargeDiag_MC64
    replace_tiny_pivot: bool = True
    iter_refine: IterRefine = IterRefine.SLU_DOUBLE
    trans: Trans = Trans.NOTRANS
    relax: int = 20                   # NREL: amalgamate subtrees <= relax cols
    max_supernode: int = 256          # NSUP: cap supernode width
    factor_dtype: str | None = None   # None => float32 on cuda, float64 on
                                      # cpu; complex values take the
                                      # complex type of that width
    ir_dtype: str = "float64"         # residual precision for refinement
    amalg_tol: float = 1.2            # fill-tolerant amalgamation flop growth
    bucket_growth: float = 1.5        # geometric padding of front buckets
    min_bucket: int = 8               # smallest padded front dimension
    schedule: str = "dataflow"        # factor-group scheduler
    sched_window: int = 8             # dataflow look-ahead, in levels
    sched_align: float = 1.1          # shape-key coalescing flop tolerance
    gemm_prec: str = "default"        # GEMM ladder tier (ops/dense.gemm):
                                      # bf16 | default (TF32 on the card) |
                                      # f32 | highest
    diag_inv: bool = False            # DiagInv: solve the diagonal blocks
                                      # by GEMMs with their inverses
    solve_schedule: str = "dataflow"  # sweep schedule (solve/plan.py):
                                      # dataflow | level | factor
    solve_window: int = 0             # dataflow look-ahead of the solve
                                      # (levels; 0 = unbounded)
    solve_align: float = 1.25         # solve-side shape-key coalescing
    native: bool = True               # host analysis in the native library
                                      # (native/); False runs the Python
                                      # twins
    symb_threads: int = 1             # threads of the native symbolic
    nd_threads: int = 1               # threads of the native multilevel ND
    recovery: RecoveryPolicy = dataclasses.field(
        default_factory=RecoveryPolicy)
    # user-supplied permutations for MY_PERMC / MY_PERMR
    user_perm_c: object = dataclasses.field(default=None, compare=False)
    user_perm_r: object = dataclasses.field(default=None, compare=False)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  "cuda" without a card raises:
    the port never falls back to the CPU — only a caller that passes
    device="cpu" gets it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def default_factor_dtype(device: torch.device) -> torch.dtype:
    """float32 factors on the card (refined to f64 on the host), float64
    on the CPU — the JAX package's TPU/CPU split."""
    return torch.float32 if device.type == "cuda" else torch.float64


#: factor dtypes the port runs, by name; complex values promote a real
#: name to the complex type of its width (the JAX package's rule,
#: drivers/gssvx.py:415-416)
FACTOR_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "complex64": torch.complex64, "complex128": torch.complex128}
_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def resolve_factor_dtype(name: str | None, device: torch.device,
                         cplx: bool = False) -> torch.dtype:
    """The torch dtype of the factors: ``name`` (an Options.factor_dtype)
    or the device's default, promoted to complex for complex values.
    Raises NotImplementedError for a name the port does not run (df64,
    the JAX package's emulated double, is not ported)."""
    if name is None:
        dt = default_factor_dtype(device)
    elif str(name) in FACTOR_DTYPES:
        dt = FACTOR_DTYPES[str(name)]
    else:
        raise NotImplementedError(
            f"factor_dtype {name!r} is not ported; the port runs "
            f"{sorted(FACTOR_DTYPES)} (ROADMAP.md)")
    return _COMPLEX_OF.get(dt, dt) if cplx else dt
