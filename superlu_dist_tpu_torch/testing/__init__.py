"""Test-support harnesses shipped with the package (the TEST/pdtest.c
analog tier): deterministic failure-domain chaos injection lives in
:mod:`superlu_dist_tpu_torch.testing.chaos`."""
