"""Crash-consistent persistence of solver state (the JAX package's
``persist/``, ported).

* :mod:`superlu_dist_tpu_torch.persist.serial` — versioned,
  integrity-checked bundles of a whole :class:`LUFactorization` handle
  (transforms, symbolic fact, plan, the numeric fronts), so a process can
  ``load_lu`` and go straight to solving on the card;
* :mod:`superlu_dist_tpu_torch.persist.checkpoint` — mid-factorization
  checkpoints of the completed-group frontier, written every
  ``Options.ckpt_every`` groups and on deadline, breakdown or SIGTERM,
  from which ``gssvx(resume_from=...)`` restarts with factors bit for bit
  equal to an uninterrupted run.

Both use one bundle format: a directory of ``.npy`` files plus a
``MANIFEST.json`` with a format version and a sha256 digest per
artifact, every file written atomically (tmp + rename, manifest last).
"""

from superlu_dist_tpu_torch.persist.serial import (  # noqa: F401
    FORMAT_VERSION, load_lu, lu_meta, pattern_digest, plan_fingerprint,
    read_bundle, save_lu, values_digest, write_bundle)
from superlu_dist_tpu_torch.persist.checkpoint import (  # noqa: F401
    FactorCheckpointer, ResumeState, flush_active, last_checkpoint,
    load_checkpoint)
