"""The drivers on the 2-D mesh tier (parallel/mesh_stream.py) on gloo
CPU ranks, each on spawned ranks (``testing.ranks.run_mesh_ranks``,
functions in tests/torch_mesh_cases.py) with SLU_TPU_VERIFY_COLLECTIVES
on: ``pgssvx(grid=gridinit(2, 2), Options(executor="stream",
pool_partition=True))`` with x within DEVICE_VS_HOST of the JAX
``gssvx(Options(pool_partition=True), grid=gridinit(4, 2))`` on the
8-device virtual CPU mesh (the case of tests/test_parallel.py's
pool-partition option test); FACTORED at nrhs 2 and the
SamePattern_SameRowPerm refactor on the 2-D handles, TRANS, complex
CONJ, the distributed-hiprec rung and ``gssvx(grid=)`` against the JAX
``gssvx`` on one device (one JAX mesh program per file is enough: the
JAX package's own tests mark its partitioned-pool runs slow); FACTORED
refused on every rank when one rank lacks its handle.
"""

import numpy as np
import pytest

import jax

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit

import torch_mesh_cases as cases
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
MESH = {"executor": "stream", "pool_partition": True}


_FLOW = {}
#: tests/test_parallel.py's pool-partition option case: poisson2d(10),
#: x from seed 1
SPEC = ("poisson2d", (10,), 1, None)


def _flow():
    if not _FLOW:
        _FLOW["out"] = run_mesh_ranks(4, cases.pgssvx_flow, SPEC, MESH,
                                      "root", nprow=2, timeout=240,
                                      env=VERIFY)
    return _FLOW["out"]


def _same_everywhere(out, key):
    for r in out:
        np.testing.assert_array_equal(out[r][key], out[0][key])


def _jax_x(spec, trans=None, nrhs=None, seed_shift=0):
    """The JAX gssvx's x for a case spec (name, args, seed, nrhs), on one
    device."""
    name, args, seed, k = spec
    a = getattr(jgal, name)(*args)
    _, b = cases._system((name, args, seed + seed_shift,
                          k if nrhs is None else nrhs))
    opts = jslu.Options() if trans is None else jslu.Options(trans=trans)
    x, _, _, info = jslu.gssvx(opts, a, b)
    assert info == 0
    return np.asarray(x)


def test_pgssvx_2d_grid_equals_jax_partitioned_gssvx():
    """The 2×2 port grid against the JAX gssvx with the partitioned pool
    on gridinit(4, 2) of the 8-device virtual CPU mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    out = _flow()
    _same_everywhere(out, "x")
    a, b = cases._system(SPEC)
    jx, _, _, info = jslu.gssvx(jslu.Options(pool_partition=True),
                                jgal.poisson2d(10), b, grid=jgridinit(4, 2))
    assert info == 0
    for r in range(4):
        rec = out[r]
        assert rec["info"] == 0 and rec["berr"] <= TARGET
        assert rec["sharded"] and rec["route"] == "device"
        assert rec["executor"]["executor"] == "mesh-stream"
        np.testing.assert_allclose(rec["x"], np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)
        t = rec["timings"]
        assert set(t) >= {"pool_bytes", "exchange_bytes", "exchange_s",
                          "bcast_bytes", "bcast_s", "bcasts", "fact_s"}
        assert t["exchanges"] == rec["shard"]["groups"]      # one a group
        assert rec["shard"]["own_slots_only"] and rec["shard"]["own_cols_only"]
    assert len({out[r]["tiny"] for r in range(4)}) == 1


def test_factored_and_refactor_on_the_2d_handles():
    out = _flow()
    _same_everywhere(out, "x_factored")
    _same_everywhere(out, "x_refactor")
    a = cases._system(SPEC)[0]
    b2 = out[0]["b_factored"]
    assert np.linalg.norm(b2 - a.matvec(out[0]["x_factored"])) \
        / np.linalg.norm(b2) < 1e-12
    np.testing.assert_allclose(out[0]["x_factored"],
                               _jax_x(SPEC, nrhs=2, seed_shift=10),
                               rtol=RTOL, atol=ATOL)
    a2 = a.__class__(a.n_rows, a.n_cols, a.indptr, a.indices, a.data * 1.5)
    b3 = a2.matvec(np.ones(a.n_rows))
    assert np.linalg.norm(b3 - a2.matvec(out[0]["x_refactor"])) \
        / np.linalg.norm(b3) < 1e-12
    assert out[0]["refactor_reused"]


@pytest.mark.parametrize("case", ["trans", "conj"])
def test_pgssvx_2d_trans_and_conj(case):
    from superlu_dist_tpu_torch.utils.options import Trans
    if case == "trans":
        spec = ("convection_diffusion_2d", (12,), 3, None)
        trans, jtrans = Trans.TRANS, jslu.Trans.TRANS
    else:
        spec = ("helmholtz_2d", (10,), 4, None)
        trans, jtrans = Trans.CONJ, jslu.Trans.CONJ
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec, dict(MESH, trans=trans),
                         "root", timeout=240, env=VERIFY)
    _same_everywhere(out, "x")
    assert out[0]["berr"] <= TARGET
    assert out[0]["executor"]["executor"] == "mesh-stream"
    np.testing.assert_allclose(out[0]["x"], _jax_x(spec, trans=jtrans),
                               rtol=RTOL, atol=ATOL)


def test_distributed_hiprec_rung_on_the_2d_grid():
    """float32 factors of the near-singular arrowhead on a 1×2 grid: one
    collective rerun at float64 factors on the 2-D executor reaches the
    target."""
    spec = ("rank_deficient_arrowhead", (60, 1e-6, 0), 1, None)
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec,
                         dict(MESH, factor_dtype="float32"), "root",
                         timeout=240, env=VERIFY)
    _same_everywhere(out, "x")
    for r in range(2):
        assert out[r]["rungs"] == ["distributed-hiprec"]
        assert out[r]["berr"] <= TARGET
    ja = jgal.rank_deficient_arrowhead(60, 1e-6, 0)
    jx, _, _, _ = jslu.gssvx(jslu.Options(), ja, cases._system(spec)[1])
    np.testing.assert_allclose(out[0]["x"], np.asarray(jx), rtol=RTOL,
                               atol=ATOL)


def test_2d_factored_without_every_handle_raises_on_every_rank():
    out = run_mesh_ranks(2, cases.factored_without_handle,
                         ("poisson2d", (8,), 0, None), MESH, timeout=180,
                         env=VERIFY)
    for r in range(2):
        assert out[r].startswith("raised: Fact=FACTORED requires EVERY "
                                 "rank's prior lu handle (1/2"), out[r]


def test_gssvx_2d_grid_equals_jax_gssvx():
    spec = ("poisson3d", (6,), 2, 3)
    out = run_mesh_ranks(4, cases.gssvx_grid, spec, MESH, nprow=2,
                         timeout=180, env=VERIFY)
    _same_everywhere(out, "x")
    _same_everywhere(out, "x2")
    jx = _jax_x(spec)
    np.testing.assert_allclose(out[0]["x"], jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[0]["x2"], 2 * jx, rtol=RTOL, atol=ATOL)
    for r in range(4):
        assert out[r]["info"] == 0 and out[r]["berr"] <= TARGET
        assert out[r]["executor"]["executor"] == "mesh-stream"
        assert out[r]["shard"]["own_cols_only"]
