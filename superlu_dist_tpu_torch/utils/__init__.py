from superlu_dist_tpu_torch.utils.options import (
    Options, Fact, ColPerm, RowPerm, IterRefine, Trans, YesNo,
    set_default_options,
)
from superlu_dist_tpu_torch.utils.stats import Stats
from superlu_dist_tpu_torch.utils.errors import (SuperLUError,
                                                 SingularMatrixError)
