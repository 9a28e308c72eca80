"""``granularity="level"`` on a grid (superlu_dist_tpu_torch/parallel/
mesh_stream.py, mesh_graphs.MeshLevelExecutor), on gloo CPU ranks
(``testing.ranks.run_mesh_ranks``, functions in tests/torch_mesh_cases.py)
with SLU_TPU_VERIFY_COLLECTIVES on, on tests/test_parallel.py's plan of
poisson2d(20) (float64: 8 groups in 5 schedule waves):

* at 1×2 and 2×1, with the partitioned and the replicated pool, and with
  the host offload: each rank's fronts and pivot stacks bit for bit those
  of "group" granularity, the tiny counts equal, ``report()`` saying
  which ran, one unit a schedule wave;
* the gathered fronts within 1e-12 of the JAX
  ``StreamExecutor(plan, "float64", granularity="level")`` — the
  tolerance of tests/test_parallel.py:196-218 — without a mesh and over
  ``gridinit(4, 2).mesh``;
* a granularity other than "group" or "level" raises ValueError with the
  JAX message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_cases as cases
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.parallel.mesh_stream import MeshStreamExecutor
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks

VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
SHAPES = [(1, 2), (2, 1)]
#: (pool_partition, offload) of each run
RUNS = {"partitioned": (True, "none"), "replicated": (False, "none"),
        "offload": (True, "host")}
_PLAN, _OUT = {}, {}


def _plan():
    if not _PLAN:
        from test_parallel import _plan as jplan_of
        jplan, avals, thresh = jplan_of(20)
        _PLAN.update(jplan=jplan, plan=plan_from_reference(jplan),
                     avals=np.asarray(avals), thresh=float(thresh))
    return _PLAN


def _run(shape, run):
    key = (shape, run)
    if key not in _OUT:
        p = _plan()
        partition, offload = RUNS[run]
        _OUT[key] = run_mesh_ranks(
            shape[0] * shape[1], cases.level_vs_group, p["plan"], p["avals"],
            p["thresh"], partition, offload, nprow=shape[0], timeout=240,
            env=VERIFY)
    return _OUT[key]


def _jax_level(mesh):
    from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
    p = _plan()
    fronts, tiny = JStream(p["jplan"], "float64", mesh=mesh,
                           granularity="level")(jnp.asarray(p["avals"]),
                                                jnp.asarray(p["thresh"]))
    return fronts, int(tiny)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("shape", SHAPES)
def test_level_bitwise_group(shape, run):
    out = _run(shape, run)
    waves = len({g.level for g in _plan()["plan"].groups})
    for r, rec in out.items():
        assert rec["equal"] and rec["pivots_equal"], r
        assert rec["tiny"][0] == rec["tiny"][1]
        assert rec["granularity"] == ("level", "group")
        assert rec["executor"] == ("mesh-stream", "MeshLevelExecutor")
        assert rec["units"] == waves < rec["groups"]
        assert rec["on_host"] == ["cpu"]


@pytest.mark.parametrize("mesh", ["none", "gridinit(4, 2)"])
@pytest.mark.parametrize("shape", SHAPES)
def test_level_agrees_with_jax_level_stream(shape, mesh):
    jmesh = None
    if mesh != "none":
        if len(jax.devices()) < 8:
            pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
        from superlu_dist_tpu.parallel.grid import gridinit
        jmesh = gridinit(4, 2).mesh
    jfronts, jtiny = _jax_level(jmesh)
    rec = _run(shape, "partitioned")[0]
    assert rec["tiny"][0] == jtiny
    assert len(rec["fronts"]) == len(jfronts)
    for (lp, up), (jl, ju) in zip(rec["fronts"], jfronts):
        np.testing.assert_allclose(lp, np.asarray(jl), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(up, np.asarray(ju), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("bad", ["levels", "wave", None])
def test_bad_granularity_raises(bad):
    with pytest.raises(ValueError, match="granularity must be 'group' or "
                                         "'level'"):
        MeshStreamExecutor(_plan()["plan"], torch.float64, "cpu", None,
                           granularity=bad)
