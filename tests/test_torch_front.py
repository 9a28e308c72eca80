"""The port's fused front assembly (superlu_dist_tpu_torch/numeric/kernels.py
``front_assemble_plain`` / ``front_assemble_``) held against the JAX
package: on every group of three plans carried across with
``plan_from_reference``, the plain version must equal, bit for bit, the
JAX composition — ``jnp.zeros``, the identity ``.at[].add`` of
numeric/factor.py:group_step, ``assemble_avals_pallas`` and then each
``extend_add_set_pallas`` in set order, both Pallas kernels in interpret
mode.  On CPU tensors the wrapper takes the plain version; the kernel
itself is held against it on a card (tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.pallas_kernels import (assemble_avals_pallas,
                                                     extend_add_set_pallas)
from superlu_dist_tpu.utils.options import Options as JaxOptions

from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.numeric.factor import upload_maps

MATRICES = {
    "poisson2d_14": lambda: jgal.poisson2d(14),
    "poisson3d_6": lambda: jgal.poisson3d(6),
    "random_80": lambda: jgal.random_sparse(80, density=0.05, seed=3),
}


def _jax_fronts(grp, avals, pool):
    """One group's assembled fronts through the JAX package's kernels."""
    batch, m, w = grp.batch, grp.m, grp.w
    dt = pool.dtype
    f = jnp.zeros((batch, m * m), dtype=dt)
    k = jnp.arange(m)
    ws = jnp.asarray(grp.ws)
    diag_mask = (k[None, :] >= ws[:, None]) & (k[None, :] < w)
    f = f.at[:, k * m + k].add(diag_mask.astype(dt))
    if len(grp.a_src):
        f = assemble_avals_pallas(f, avals, jnp.asarray(grp.a_slot),
                                  jnp.asarray(grp.a_flat),
                                  jnp.asarray(grp.a_src), mode="interpret")
    for cs in grp.children:
        f = extend_add_set_pallas(f, pool, m, cs.ub, jnp.asarray(cs.child_off),
                                  jnp.asarray(cs.child_slot),
                                  jnp.asarray(cs.rel), mode="interpret")
    return np.asarray(f)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_front_assemble_plain_equals_jax(name, dtype):
    lu, vals, _ = jax_analyze(JaxOptions(), MATRICES[name]())
    plan = lu.plan
    rng = np.random.default_rng(12)
    avals = rng.standard_normal(len(vals)).astype(dtype)
    pool = rng.standard_normal(plan.pool_size).astype(dtype)
    port = plan_from_reference(plan)
    maps = upload_maps(port, torch.device("cpu"))
    kernels.reset_launches()
    for grp, pgrp, gm in zip(plan.groups, port.groups, maps):
        out = kernels.front_assemble_(torch.from_numpy(avals),
                                      torch.from_numpy(pool), pgrp.m, pgrp.w,
                                      gm).numpy()
        ref = _jax_fronts(grp, jnp.asarray(avals), jnp.asarray(pool))
        assert out.dtype == dtype and out.shape == ref.shape
        assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert not any(kernels.LAUNCHES.values())     # CPU: the plain version


def test_launch_refuses_cpu_tensors():
    """No silent fallback: the kernel's launcher takes only CUDA tensors."""
    maps = kernels.build_front_maps(1, 2, 0, a=([0], [3], [0]), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_(torch.zeros((1, 4)), maps, avals=torch.ones(1))
