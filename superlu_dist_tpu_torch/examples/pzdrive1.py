#!/usr/bin/env python
"""Complex factorization reuse: same A, new right-hand sides — analog of
EXAMPLE/pzdrive1.c (the z-twin of pddrive1; Fact=FACTORED re-solves
through the kept complex factors and spends no FACT time).  The port's
counterpart of the JAX package's ``examples/pzdrive1.py``.

    python -m superlu_dist_tpu_torch.examples.pzdrive1 [matrix.cua] [--device cpu]
"""

from superlu_dist_tpu_torch.examples import pddrive1
from superlu_dist_tpu_torch.examples._common import parser


def main(argv=None):
    return pddrive1.run(parser(__doc__).parse_args(argv), True,
                        "pzdrive1 (FACTORED)")


if __name__ == "__main__":
    raise SystemExit(main())
