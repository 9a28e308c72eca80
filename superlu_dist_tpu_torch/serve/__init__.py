from superlu_dist_tpu_torch.serve.server import (   # noqa: F401
    SolveServer, SolveTicket)
from superlu_dist_tpu_torch.serve.handlecache import HandleCache  # noqa: F401
from superlu_dist_tpu_torch.serve.fleet import (    # noqa: F401
    FleetRouter, FleetTicket, ProcessReplica, ThreadReplica)
from superlu_dist_tpu_torch.utils.errors import (   # noqa: F401
    DeployRollbackError, FactorCorruptError, PatternMismatchError,
    RefactorRollbackError, ReplicaFailureError, ServeDeadlineError,
    ServeOverloadError, ServePoisonedError, ServerClosedError)
