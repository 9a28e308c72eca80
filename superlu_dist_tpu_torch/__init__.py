"""superlu_dist_tpu_torch — the PyTorch/CUDA port of the JAX package.

A supernodal multifrontal sparse direct solver (the SuperLU_DIST
capability set) for one NVIDIA Hopper GPU.  The host analysis (scaling,
matching, ordering, symbolic factorization, plan) is numpy; the numeric
factorization and the triangular solves run in PyTorch on the device,
with the front assembly and the refinement's residual SpMV hand-written
in CUDA (``numeric/kernels.py``, ``parallel/dist.py``, ``csrc/``), in real
and complex types.  The JAX package beside it
(``superlu_dist_tpu/``) is the reference this port is held against; this
package imports nothing of it.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from superlu_dist_tpu_torch.drivers.gssvx import (LUFactorization, analyze,
                                                  factorize_numeric, gssvx,
                                                  refactor)
from superlu_dist_tpu_torch.sparse.formats import SparseCSC, SparseCSR
from superlu_dist_tpu_torch.utils.errors import (NumericBreakdownError,
                                                 PatternMismatchError,
                                                 RefactorRollbackError,
                                                 SingularMatrixError,
                                                 SuperLUError)
from superlu_dist_tpu_torch.utils.options import (ColPerm, Fact, IterRefine,
                                                  Options, RecoveryPolicy,
                                                  RowPerm, Trans)
from superlu_dist_tpu_torch.utils.stats import RungRecord, SolveReport, Stats

__all__ = [
    "gssvx", "analyze", "factorize_numeric", "refactor", "LUFactorization",
    "Options", "Fact", "ColPerm", "RowPerm", "IterRefine", "Trans",
    "RecoveryPolicy", "Stats", "SolveReport", "RungRecord",
    "SparseCSR", "SparseCSC",
    "SuperLUError", "SingularMatrixError", "NumericBreakdownError",
    "PatternMismatchError", "RefactorRollbackError",
]
