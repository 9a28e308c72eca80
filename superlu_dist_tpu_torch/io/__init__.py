"""Sparse matrix files: the readers and writers of ``io/readers.py``."""

from superlu_dist_tpu_torch.io.readers import (  # noqa: F401
    read_binary, read_harwell_boeing, read_matrix, read_matrix_market,
    read_rutherford_boeing, read_triples, write_binary, write_matrix_market)
