"""The port's batched partial front factorization
(superlu_dist_tpu_torch/ops/dense.py) against the JAX package's
ops.dense.group_partial_factor, in float64, at the cross-schedule drift
gate of utils/tols (the two frameworks order the GEMM and TRSM sums
differently, so agreement is to a small multiple of eps, not bitwise);
the tiny-pivot flags must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superlu_dist_tpu.ops.dense import group_partial_factor as jax_gpf
from superlu_dist_tpu_torch.ops.dense import group_partial_factor
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.SCHEDULE_DRIFT_RTOL, tols.SCHEDULE_DRIFT_ATOL


def _fronts(seed, batch, m, w, tiny_cols=()):
    """Diagonally dominant random fronts; ``tiny_cols`` get a zero pivot
    row/column in the pivot block so GESP replacement fires there."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((batch, m, m))
    f[:, np.arange(m), np.arange(m)] += 2.0 * np.sqrt(m)
    for c in tiny_cols:
        f[0, c, :] = 0.0
        f[0, :, c] = 0.0
    return f


@pytest.mark.parametrize("pivot", ["blocked", "recursive"])
@pytest.mark.parametrize("batch,m,w,tiny_cols", [
    (3, 40, 24, ()),
    (2, 40, 24, (5, 17)),          # tiny pivots replaced
    (2, 24, 24, ()),               # no Schur block (u == 0)
    (1, 170, 136, (140,)),         # two panels; col 140 is no pivot
])
def test_group_partial_factor_matches_jax(batch, m, w, tiny_cols, pivot):
    f = _fronts(1, batch, m, w, tiny_cols)
    thresh = 1e-3
    ref = jax_gpf(jnp.asarray(f), jnp.asarray(thresh), w, pivot=pivot,
                  gemm_prec="highest")
    out = group_partial_factor(torch.from_numpy(f.copy()),
                               torch.tensor(thresh, dtype=torch.float64), w,
                               pivot=pivot)
    for name, r, o in zip(("lpanel", "upanel", "schur"), ref[:3], out[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert np.array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert out[3].numpy().sum() == sum(c < w for c in tiny_cols)


def test_all_pivots_tiny_when_threshold_exceeds_them():
    f = _fronts(2, 2, 32, 16)
    thresh = 1e6
    ref = jax_gpf(jnp.asarray(f), jnp.asarray(thresh), 16)
    out = group_partial_factor(torch.from_numpy(f.copy()),
                               torch.tensor(thresh, dtype=torch.float64), 16)
    assert out[3].numpy().sum() == 2 * 16
    assert np.array_equal(out[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pivot", ["blocked", "recursive"])
def test_multipliers_of_a_large_pivot_are_stored_as_computed(pivot):
    """A float32 front whose first pivot is 1e6: the port writes each
    multiplier col/piv directly, so it is within 1e-6 relative of float64
    truth; the JAX package stores cur + (l − cur), which keeps only
    eps32·|pivot| of it (a fault of the reference, kept there: ROADMAP.md
    Queue 3's deliberate differences)."""
    f = _fronts(3, 2, 40, 24)
    f[:, 0, 0] = 1e6
    f32 = f.astype(np.float32)
    truth = f32[:, 1:, 0].astype(np.float64) / np.float64(f32[0, 0, 0])
    thresh = np.float32(1e-3)
    out = group_partial_factor(torch.from_numpy(f32.copy()),
                               torch.tensor(thresh), 24, pivot=pivot)
    ref = jax_gpf(jnp.asarray(f32), jnp.asarray(thresh), 24, pivot=pivot,
                  gemm_prec="highest")

    def rel(lpanel):
        return float(np.max(np.abs(np.asarray(lpanel)[:, 1:, 0] - truth)
                            / np.abs(truth)))

    assert rel(out[0].numpy()) <= 1e-6
    assert rel(ref[0]) > 1e-3
