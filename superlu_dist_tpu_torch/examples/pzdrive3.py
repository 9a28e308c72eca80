#!/usr/bin/env python
"""Complex full-reuse tier: same pattern AND similar values — analog of
EXAMPLE/pzdrive3.c (the z-twin of pddrive3; Fact=SamePattern_SameRowPerm
reuses scalings, both permutations, the symbolic analysis and the plan;
only the numeric factorization runs on the new complex values).  The
port's counterpart of the JAX package's ``examples/pzdrive3.py``.

    python -m superlu_dist_tpu_torch.examples.pzdrive3 [matrix.cua] [--device cpu]
"""

from superlu_dist_tpu_torch.examples import pddrive3
from superlu_dist_tpu_torch.examples._common import parser


def main(argv=None):
    return pddrive3.run(parser(__doc__).parse_args(argv), True,
                        "pzdrive3 (SamePattern_SameRowPerm)")


if __name__ == "__main__":
    raise SystemExit(main())
