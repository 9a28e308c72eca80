"""Error model.

The reference reports errors via ``info`` codes (<0: the -info-th argument
was invalid, via pxerr_dist; >0: U(i,i) is exactly singular, pdgstrf.c:234-241)
or aborts (ABORT, util_dist.h:27-34).  We use exceptions for argument errors
and return ``info`` from drivers for singularity, matching pdgssvx semantics.
"""


class SuperLUError(Exception):
    """Invalid argument / internal error (analog of pxerr_dist + ABORT)."""


class SingularMatrixError(SuperLUError):
    """U(i,i) exactly singular and ReplaceTinyPivot disabled (info > 0)."""

    def __init__(self, k: int):
        self.info = k + 1   # reference convention: 1-based first zero pivot
        super().__init__(f"Factorization failed: U({k},{k}) is exactly zero "
                         f"(info={self.info})")


class NumericBreakdownError(SuperLUError):
    """A non-finite value (NaN/Inf) appeared in the computed factors or the
    solution while ReplaceTinyPivot was active — overflow or NaN input, not
    plain singularity (which SingularMatrixError covers).  Tripped by the
    isfinite sentinels in the numeric layer so a breakdown surfaces at the
    offending supernode (the structured replacement for the reference's
    ABORT, util_dist.h:27-34)."""

    def __init__(self, supernode: int = -1, col: int = -1, where: str = ""):
        self.supernode = int(supernode)   # first contaminated supernode
        self.col = int(col)               # its first global column (0-based)
        self.where = where                # which stage tripped the sentinel
        loc = (f" at supernode {supernode} (column {col})"
               if supernode >= 0 else "")
        stage = f" during {where}" if where else ""
        super().__init__(
            f"non-finite values detected{stage}{loc}; the system is "
            "numerically broken down (overflow or NaN input)")
