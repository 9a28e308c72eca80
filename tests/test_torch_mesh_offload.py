"""Host offload on the grid (parallel/mesh_stream.py, parallel/spmd.py):
each group's own factor columns and its pivot stack go to host memory as
the group completes, and the offloaded factors are solved collectively
where they lie (``SpmdSolver`` on the grid's host view).  On gloo CPU
ranks (``testing.ranks.run_mesh_ranks``, functions in
tests/torch_mesh_cases.py) with SLU_TPU_VERIFY_COLLECTIVES on:

* at 1×2 and 2×2, the 2-D executor with the partitioned and the
  replicated pool and the spmd executor, ``front_bytes_limit=0``: the
  factors host-resident, their fronts bit for bit the non-offloaded 2-D
  run's, the tiny counts equal, the solver built in host memory and its
  x bit for bit the device factors' solver's;
* the JAX package's "config-4 recipe" (tests/test_parallel.py:221-243):
  its ``StreamExecutor(mesh=gridinit(4, 2).mesh, pool_partition=True,
  offload="host")`` on tests/test_parallel.py's plan against the port's
  offloaded 2×2 run: fronts within SCHEDULE_DRIFT, the tiny counts equal;
* ``pgssvx(grid=)`` and ``gssvx(grid=)`` with ``front_bytes_limit=0``:
  x within DEVICE_VS_HOST of the JAX gssvx, BERR at the target, the
  solves on the host;
* the executor cache keys the offload knobs of the mesh executors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit

import torch_mesh_cases as cases
import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.models import gallery as tgal
from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
GRIDS = [(1, 2), (2, 2)]
_GALLERY = [("poisson", lambda g: g.poisson2d(16), "float64"),
            ("helmholtz", lambda g: g.helmholtz_2d(10), "complex128")]
NAMES = [n for n, _, _ in _GALLERY]
RUNS = ("offload", "offload_replicated", "offload_spmd")
_CASES, _RUNS = {}, {}


def _case(name):
    if name not in _CASES:
        make, dt = {n: (m, d) for n, m, d in _GALLERY}[name]
        lu, bvals, _ = slt.analyze(slt.Options(), make(tgal), device="cpu")
        _CASES[name] = (lu.plan, bvals, lu.anorm, dt)
    return _CASES[name]


def _run(shape):
    if shape not in _RUNS:
        _RUNS[shape] = run_mesh_ranks(
            shape[0] * shape[1], cases.runs_vs_stream,
            [(n, *_case(n)) for n in NAMES], RUNS, nprow=shape[0],
            timeout=300, env=VERIFY)
    return _RUNS[shape]


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("run", RUNS)
def test_offloaded_grid_factors_are_host_resident_and_bitwise(shape, name,
                                                              run):
    out = _run(shape)
    want = "spmd" if run == "offload_spmd" else "mesh-stream"
    for r in out:
        rec = out[r][name]["runs"][run]
        assert rec["offload"] == "host" and rec["on_host"], r
        assert rec["fronts_on"] == ["cpu"] and rec["pivots_on"] == ["cpu"]
        ex = rec["executor"]
        assert ex["executor"] == want and ex["offload"] == "host"
        assert ex["host_bytes"] > 0 and ex["offload_wait_s"] >= 0.0
        assert rec["equal"], (r, rec["rel"])
        assert rec["tiny"] == out[r][name]["tiny"]


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("run", RUNS)
def test_offloaded_grid_factors_solve_in_host_memory(shape, run):
    out = _run(shape)
    for r in out:
        for name in NAMES:
            rec = out[r][name]["runs"][run]
            assert rec["solver_device"] == "cpu"
            assert rec["x_equal"], (r, name)


def test_the_jax_config4_recipe():
    """Host-offloaded panels and the partitioned pool together: the JAX
    StreamExecutor on gridinit(4, 2) against the port's 2×2 grid."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    from test_parallel import _plan
    jplan, avals, thresh = _plan()
    ex = JStream(jplan, "float64", mesh=jgridinit(4, 2).mesh,
                 pool_partition=True, offload="host")
    assert ex.offload == "host"
    jfronts, jtiny = ex(jnp.asarray(avals), jnp.asarray(thresh))
    anorm = jgal.poisson2d(12).norm_max()
    out = run_mesh_ranks(4, cases.grid_executor_fronts,
                         plan_from_reference(jplan), np.asarray(avals),
                         anorm, "stream", True, 0, nprow=2, timeout=240,
                         env=VERIFY)
    for r in range(4):
        assert out[r]["on_host"] and out[r]["tiny"] == int(jtiny)
    for (lp, up), (jl, ju) in zip(out[0]["fronts"], jfronts):
        assert isinstance(jl, np.ndarray)
        np.testing.assert_allclose(lp, jl, rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
        np.testing.assert_allclose(up, ju, rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)


@pytest.mark.parametrize("opts", [
    {"executor": "stream", "pool_partition": True},
    {"executor": "stream"},
    {}], ids=["partitioned", "replicated", "spmd"])
def test_pgssvx_offloaded_on_the_grid_equals_jax_gssvx(opts):
    spec = ("poisson2d", (10,), 1, None)
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec,
                         dict(opts, front_bytes_limit=0), "root",
                         timeout=240, env=VERIFY)
    a, b = cases._system(spec)
    jx, _, _, info = jslu.gssvx(jslu.Options(), jgal.poisson2d(10), b)
    assert info == 0
    for r in range(2):
        rec = out[r]
        assert rec["info"] == 0 and rec["berr"] <= TARGET
        assert rec["on_host"] and rec["solve_route"] == "host"
        assert rec["timings"]["offload"] == "host"
        assert rec["timings"]["host_bytes"] > 0
        np.testing.assert_array_equal(rec["x"], out[0]["x"])
        np.testing.assert_allclose(rec["x"], np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)
    b2 = out[0]["b_factored"]
    assert np.linalg.norm(b2 - a.matvec(out[0]["x_factored"])) \
        / np.linalg.norm(b2) < 1e-12


def test_gssvx_offloaded_on_the_grid_equals_jax_gssvx():
    spec = ("poisson3d", (6,), 2, 3)
    out = run_mesh_ranks(4, cases.gssvx_grid, spec,
                         {"executor": "stream", "pool_partition": True,
                          "front_bytes_limit": 0}, nprow=2, timeout=180,
                         env=VERIFY)
    a, b = cases._system(spec)
    jx, _, _, _ = jslu.gssvx(jslu.Options(), jgal.poisson3d(6), b)
    for r in range(4):
        rec = out[r]
        assert rec["info"] == 0 and rec["berr"] <= TARGET
        assert rec["on_host"] and rec["solve_route"] == "host"
        np.testing.assert_allclose(rec["x"], np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rec["x2"], 2 * np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)


class _Grid:
    """What get_executor's key and resolve_executor read of a grid."""

    def __init__(self, nprow, npcol):
        self.nprow, self.npcol = nprow, npcol
        self.device = torch.device("cpu")

    @property
    def nproc(self):
        return self.nprow * self.npcol


@pytest.mark.parametrize("executor,partition,want", [
    ("stream", True, "mesh-stream"), ("auto", False, "spmd"),
    ("mega", False, "mesh-mega")])
def test_mesh_executor_cache_keys_the_offload_knobs(executor, partition,
                                                    want):
    """A changed front_bytes_limit or offload lag on a grid builds a new
    executor (the key holds them), the same knobs reuse it."""
    plan = _case("poisson")[0]
    grid = _Grid(1, 2)
    built = []

    class Probe:
        def __init__(self, *a, **kw):
            built.append(kw)
            self.offload = kw.get("offload", "none")

    import superlu_dist_tpu_torch.parallel.mesh_graphs as mg
    import superlu_dist_tpu_torch.parallel.mesh_stream as ms
    import superlu_dist_tpu_torch.parallel.spmd as sp
    mp = pytest.MonkeyPatch()
    mp.setattr(ms, "MeshStreamExecutor", Probe)
    mp.setattr(sp, "SpmdFactorExecutor", Probe)
    mp.setattr(mg, "MeshMegaExecutor", Probe)
    try:
        plan.__dict__.pop("_factor_fns", None)
        kw = dict(grid=grid, pool_partition=partition)
        e1 = factor.get_executor(plan, torch.float64, executor, None, "cpu",
                                 **kw)
        e2 = factor.get_executor(plan, torch.float64, executor, None, "cpu",
                                 **kw)
        e3 = factor.get_executor(plan, torch.float64, executor, None, "cpu",
                                 front_bytes_limit=0, **kw)
        e4 = factor.get_executor(plan, torch.float64, executor, None, "cpu",
                                 front_bytes_limit=0, offload_lag=2, **kw)
    finally:
        mp.undo()
        plan.__dict__.pop("_factor_fns", None)
    assert factor.resolve_executor(executor, grid.device, grid,
                                   partition) == want
    assert e1 is e2 and e3 is not e1 and e4 is not e3
    assert [b["front_bytes_limit"] for b in built] == [None, 0, 0]
    assert built[-1]["offload_lag"] == 2
