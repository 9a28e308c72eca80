"""The fused and mega executors on a grid (superlu_dist_tpu_torch/
parallel/mesh_graphs.py): the 2-D executor's group programs as segment
graphs, on gloo CPU ranks (``testing.ranks.run_mesh_ranks``, functions
in tests/torch_mesh_cases.py) with SLU_TPU_VERIFY_COLLECTIVES on:

* on the CPU both run the programs eagerly — fused on the 2-D
  executor's tables, mega on its padded ones — and their fronts are the
  2-D executor's bit for bit at 1×2, 2×1 and 2×2, with the partitioned
  and the replicated pool, the tiny counts equal;
* against the JAX ``get_executor(executor="fused"/"mega", mesh=
  gridinit(4, 2).mesh, pool_partition=...)`` on tests/test_parallel.py's
  plan: fronts within SCHEDULE_DRIFT, tiny counts equal;
* ``gssvx(grid=)`` and ``pgssvx(grid=)`` with ``Options(executor=
  "fused")`` / ``"mega"`` against the JAX gssvx;
* a deadline turns fused into the 2-D stream on a grid.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import superlu_dist_tpu as jslu
from superlu_dist_tpu.numeric.factor import get_executor as jget_executor
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit

import torch_mesh_cases as cases
import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.models import gallery as tgal
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
GRIDS = [(1, 2), (2, 1), (2, 2)]
_GALLERY = [("poisson", lambda g: g.poisson2d(16), "float64"),
            ("helmholtz", lambda g: g.helmholtz_2d(10), "complex128")]
NAMES = [n for n, _, _ in _GALLERY]
RUNS = ("fused", "mega", "mega_replicated")
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
def test_grid_graphs_bitwise_the_2d_executor(shape, name, run):
    out = _run(shape)
    want = {"fused": "mesh-fused"}.get(run, "mesh-mega")
    for r in out:
        rec = out[r][name]["runs"][run]
        assert rec["equal"], (r, rec["rel"])
        assert rec["tiny"] == out[r][name]["tiny"]
        assert rec["executor"]["executor"] == want
        assert rec["executor"]["pool_partition"] == (run != "mega_replicated")
        assert rec["shard"]["own_slots_only"] and rec["shard"]["own_cols_only"]
        if run != "fused":
            assert rec["executor"]["closed_keys"] >= 1


def _jax_fronts(executor, partition):
    from test_parallel import _plan
    jplan, avals, thresh = _plan()
    ex = jget_executor(jplan, "float64", executor=executor,
                       mesh=jgridinit(4, 2).mesh, pool_partition=partition)
    fronts, tiny = ex(jnp.asarray(avals), jnp.asarray(thresh))
    return jplan, avals, fronts, int(tiny)


@pytest.mark.parametrize("executor,partition", [("fused", True),
                                                ("mega", False)])
def test_grid_graphs_against_the_jax_mesh_executors(executor, partition):
    """tests/test_parallel.py's plan on the JAX executor over
    gridinit(4, 2), against the port's on a 2×2 grid: fronts within
    SCHEDULE_DRIFT, the tiny counts equal."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    from superlu_dist_tpu.models import gallery as jgal
    jplan, avals, jfronts, jtiny = _jax_fronts(executor, partition)
    anorm = jgal.poisson2d(12).norm_max()
    out = run_mesh_ranks(4, cases.grid_executor_fronts,
                         plan_from_reference(jplan), np.asarray(avals),
                         anorm, executor, partition, nprow=2, timeout=240,
                         env=VERIFY)
    rec = out[0]
    assert rec["tiny"] == jtiny
    assert rec["executor"] == "mesh-" + executor
    for (lp, up), (jl, ju) in zip(rec["fronts"], jfronts):
        np.testing.assert_allclose(lp, np.asarray(jl),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
        np.testing.assert_allclose(up, np.asarray(ju),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)


@pytest.mark.parametrize("executor", ["fused", "mega"])
def test_pgssvx_on_the_grid_graphs_equals_jax_gssvx(executor):
    """pgssvx(grid=) with Options(executor=...) on a 1×2 grid: DOFACT,
    FACTORED at nrhs 2 and the SamePattern_SameRowPerm refactor (the
    replay), x within DEVICE_VS_HOST of the JAX gssvx on one device."""
    spec = ("poisson2d", (10,), 1, None)
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec,
                         {"executor": executor, "pool_partition": True},
                         "root", timeout=240, env=VERIFY)
    from superlu_dist_tpu.models import gallery as jgal
    jx, _, _, info = jslu.gssvx(jslu.Options(), jgal.poisson2d(10),
                                cases._system(spec)[1])
    assert info == 0
    for r in range(2):
        rec = out[r]
        assert rec["info"] == 0 and rec["berr"] <= TARGET
        assert rec["executor"]["executor"] == "mesh-" + executor
        np.testing.assert_array_equal(rec["x"], out[0]["x"])
        np.testing.assert_allclose(rec["x"], np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)
        assert rec["refactor_reused"]
    a = cases._system(spec)[0]
    a2 = a.__class__(a.n_rows, a.n_cols, a.indptr, a.indices, a.data * 1.5)
    b3 = a2.matvec(np.ones(a.n_rows))
    assert np.linalg.norm(b3 - a2.matvec(out[0]["x_refactor"])) \
        / np.linalg.norm(b3) < 1e-12


def test_gssvx_on_the_grid_graphs_equals_jax_gssvx():
    spec = ("poisson3d", (6,), 2, 3)
    out = run_mesh_ranks(4, cases.gssvx_grid, spec, {"executor": "mega"},
                         nprow=2, timeout=180, env=VERIFY)
    from superlu_dist_tpu.models import gallery as jgal
    a, b = cases._system(spec)
    jx, _, _, _ = jslu.gssvx(jslu.Options(), jgal.poisson3d(6), b)
    for r in range(4):
        assert out[r]["info"] == 0 and out[r]["berr"] <= TARGET
        assert out[r]["executor"]["executor"] == "mesh-mega"
        np.testing.assert_allclose(out[r]["x"], np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)


def test_deadline_turns_grid_fused_into_the_2d_stream():
    out = run_mesh_ranks(2, cases.grid_fused_deadline, timeout=180,
                         env=VERIFY)
    for r in range(2):
        assert out[r] == ("mesh-stream", "mesh-fused")
