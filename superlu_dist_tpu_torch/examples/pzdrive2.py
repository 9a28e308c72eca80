#!/usr/bin/env python
"""Complex pattern reuse: same sparsity pattern, new values — analog of
EXAMPLE/pzdrive2.c (the z-twin of pddrive2; Fact=SamePattern reuses the
column ordering, and the symbolic/plan too when the fresh matching
reproduces the row permutation).  The port's counterpart of the JAX
package's ``examples/pzdrive2.py``.

    python -m superlu_dist_tpu_torch.examples.pzdrive2 [matrix.cua] [--device cpu]
"""

from superlu_dist_tpu_torch.examples import pddrive2
from superlu_dist_tpu_torch.examples._common import parser


def main(argv=None):
    return pddrive2.run(parser(__doc__).parse_args(argv), True,
                        "pzdrive2 (SamePattern)")


if __name__ == "__main__":
    raise SystemExit(main())
