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
    """Factorization reuse tiers (reference fact_t, superlu_defs.h:489-510).
    The port runs DOFACT only."""

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


@dataclasses.dataclass
class Options:
    """Runtime options (analog of superlu_dist_options_t).

    Defaults follow set_default_options_dist (SRC/util.c:376-401):
    Fact=DOFACT, Equil=YES, ColPerm=METIS_AT_PLUS_A, RowPerm=LargeDiag_MC64,
    ReplaceTinyPivot, IterRefine=DOUBLE, plus the JAX package's blocking
    and scheduling defaults.
    """

    fact: Fact = Fact.DOFACT
    equil: bool = True
    col_perm: ColPerm = ColPerm.ND_AT_PLUS_A
    row_perm: RowPerm = RowPerm.LargeDiag_MC64
    replace_tiny_pivot: bool = True
    iter_refine: IterRefine = IterRefine.SLU_DOUBLE
    relax: int = 20                   # NREL: amalgamate subtrees <= relax cols
    max_supernode: int = 256          # NSUP: cap supernode width
    factor_dtype: str | None = None   # None => float32 on cuda, float64 on cpu
    ir_dtype: str = "float64"         # residual precision for refinement
    amalg_tol: float = 1.2            # fill-tolerant amalgamation flop growth
    bucket_growth: float = 1.5        # geometric padding of front buckets
    min_bucket: int = 8               # smallest padded front dimension
    schedule: str = "dataflow"        # factor-group scheduler
    sched_window: int = 8             # dataflow look-ahead, in levels
    sched_align: float = 1.1          # shape-key coalescing flop tolerance
    gemm_prec: str = "highest"        # Schur GEMM tier (ops/dense.gemm)
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
