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
From the shell: ``python -m superlu_dist_tpu_torch -f matrix.mtx`` (the
pddrive analog, ``__main__.py``).  A factored handle serves right-hand
sides through ``serve/`` (``SolveServer``, ``HandleCache``,
``FleetRouter``), observed through ``obs/`` (trace, metrics, flight
recorder, SLO).
"""

from superlu_dist_tpu_torch.drivers.gssvx import (LUFactorization, analyze,
                                                  factorize_numeric, gssvx,
                                                  gssvx_ABglobal, gssvx_dist,
                                                  refactor)
from superlu_dist_tpu_torch.io.readers import read_matrix
from superlu_dist_tpu_torch.persist.serial import load_lu, save_lu
from superlu_dist_tpu_torch.serve import FleetRouter, HandleCache, SolveServer
from superlu_dist_tpu_torch.sparse.formats import SparseCSC, SparseCSR
from superlu_dist_tpu_torch.utils.errors import (CheckpointCorruptError,
                                                 CheckpointError,
                                                 CheckpointMismatchError,
                                                 CheckpointVersionError,
                                                 DeadlineExceededError,
                                                 DeployRollbackError,
                                                 FactorCorruptError,
                                                 LockOrderError,
                                                 NumericBreakdownError,
                                                 PatternMismatchError,
                                                 RefactorRollbackError,
                                                 ReplicaFailureError,
                                                 ServeDeadlineError,
                                                 ServeOverloadError,
                                                 ServePoisonedError,
                                                 ServerClosedError,
                                                 SingularMatrixError,
                                                 SuperLUError)
from superlu_dist_tpu_torch.utils.options import (ColPerm, Fact, IterRefine,
                                                  Options, RecoveryPolicy,
                                                  RowPerm, Trans)
from superlu_dist_tpu_torch.utils.stats import RungRecord, SolveReport, Stats

__all__ = [
    "gssvx", "gssvx_ABglobal", "gssvx_dist", "analyze", "factorize_numeric",
    "refactor", "LUFactorization", "save_lu", "load_lu", "read_matrix",
    "Options", "Fact", "ColPerm", "RowPerm", "IterRefine", "Trans",
    "RecoveryPolicy", "Stats", "SolveReport", "RungRecord",
    "SparseCSR", "SparseCSC",
    "SuperLUError", "SingularMatrixError", "NumericBreakdownError",
    "PatternMismatchError", "RefactorRollbackError", "DeadlineExceededError",
    "CheckpointError", "CheckpointCorruptError", "CheckpointVersionError",
    "CheckpointMismatchError",
    "SolveServer", "HandleCache", "FleetRouter",
    "ServerClosedError", "ServeOverloadError", "ServeDeadlineError",
    "ServePoisonedError", "FactorCorruptError", "ReplicaFailureError",
    "DeployRollbackError", "LockOrderError",
]
