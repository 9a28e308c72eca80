#!/usr/bin/env python
"""Two independent COMPLEX solves on two process sub-grids — analog of
EXAMPLE/pzdrive4.c (the z-twin of pddrive4: two sub-grids of the global
communicator each solve their own system).  The port's counterpart of
the JAX package's ``examples/pzdrive4.py``; ``--nproc N`` spawns N ranks
and splits them with ``parallel/grid.gridmap`` (see pddrive4.py).

    python -m superlu_dist_tpu_torch.examples.pzdrive4 [matrix.cua] [--nproc 4] [--device cpu]
"""

from superlu_dist_tpu_torch.examples import pddrive4
from superlu_dist_tpu_torch.examples._common import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks to spawn and split into two sub-grids "
                         "(default 1: two plain solves in this process)")
    return pddrive4.run(ap.parse_args(argv), True, "pzdrive4")


if __name__ == "__main__":
    raise SystemExit(main())
