#!/usr/bin/env python
"""Complex-valued solve — analog of EXAMPLE/pzdrive.c (the z-twin of
pddrive: complex64 factors on the card, complex128 on the CPU, refined
in complex128).  The port's counterpart of the JAX package's
``examples/pzdrive.py``.

    python -m superlu_dist_tpu_torch.examples.pzdrive [matrix.cua] [--device cpu]
"""

from superlu_dist_tpu_torch.examples import pddrive
from superlu_dist_tpu_torch.examples._common import parser


def main(argv=None):
    pddrive.run(parser(__doc__).parse_args(argv), True, "pzdrive")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
