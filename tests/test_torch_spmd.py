"""The mesh tier's factor executor and solver
(superlu_dist_tpu_torch/parallel/spmd.py) on gloo CPU ranks.

* The layout helpers ``_cyclic_layout`` and ``_partition_rows`` array for
  array against the JAX package's, and the per-rank shares
  (``local_plan``) covering every group exactly once.
* ``SpmdFactorExecutor`` over nd = 2 and 3 spawned ranks
  (``testing.ranks.run_mesh_ranks``): the fronts, gathered to slot order,
  and the tiny count bit for bit the port's stream executor on the
  ``_GALLERY`` matrices of tests/test_spmd.py (and complex helmholtz_2d);
  every rank holds only its own slots' panels; ``SpmdSolver`` at NOTRANS
  (3 columns and 1), TRANS and CONJ bit for bit ``DeviceSolver``.
* Against the JAX ``SpmdFactorExecutor`` / ``SpmdSolver`` on
  ``gridinit(1, nd)`` of the 8-device virtual CPU mesh: fronts at
  SCHEDULE_DRIFT (the port writes the multipliers as computed, ROADMAP.md
  Queue 3), X at DEVICE_VS_HOST.
* The grid's lockstep verification and the collective deadline.
"""

import numpy as np
import pytest
import torch

import jax

from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import numeric_factorize as jfactorize
from superlu_dist_tpu.numeric.plan import build_plan as jbuild_plan
from superlu_dist_tpu.ordering.dispatch import get_perm_c as jget_perm_c
from superlu_dist_tpu.parallel import spmd as jspmd
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit
from superlu_dist_tpu.sparse.formats import symmetrize_pattern as jsym
from superlu_dist_tpu.symbolic.symbfact import (
    symbolic_factorize as jsymbolic)
from superlu_dist_tpu.utils.options import Options as JOptions

import torch_mesh_cases as cases
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.parallel import spmd
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

_GALLERY = [("poisson", lambda g: g.poisson2d(16), "float64"),
            ("hilbert", lambda g: g.hilbert(48), "float64"),
            ("arrowhead", lambda g: g.rank_deficient_arrowhead(40),
             "float64"),
            ("helmholtz", lambda g: g.helmholtz_2d(10), "complex128")]
NAMES = [name for name, _, _ in _GALLERY]


def _analyzed(a):
    """tests/test_spmd.py's analysis: ND order, symbolic, dataflow plan."""
    sym = jsym(a)
    sf = jsymbolic(sym, jget_perm_c(JOptions(), a, sym))
    plan = jbuild_plan(sf, schedule="dataflow")
    return plan, np.asarray(sym.data[sf.value_perm]), a.norm_max()


_JAX = {}


def _jax_case(name):
    if name not in _JAX:
        make, dt = {n: (m, d) for n, m, d in _GALLERY}[name]
        _JAX[name] = (*_analyzed(make(jgal)), dt)
    return _JAX[name]


# ---------------------------------------------------------------------------
# layout helpers vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 3, 5, 7, 8, 16, 33])
@pytest.mark.parametrize("nd", [1, 2, 3, 8])
def test_cyclic_layout_is_the_jax_one(batch, nd):
    mine, ref = spmd._cyclic_layout(batch, nd), jspmd._cyclic_layout(batch,
                                                                     nd)
    assert mine[:2] == ref[:2]
    for a, b in zip(mine[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nd", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_rows_is_the_jax_one(nd, seed):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, nd, size=37)
    cols = [rng.integers(0, 100, size=37), rng.standard_normal((37, 3))]
    c1, out1 = spmd._partition_rows(owner, nd, [-1, 0.5], cols)
    c2, out2 = jspmd._partition_rows(owner, nd, [-1, 0.5], cols)
    assert c1 == c2
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nd", [2, 3])
def test_local_plans_deal_every_slot_once(nd):
    jplan, _, _, _ = _jax_case("poisson")
    plan = plan_from_reference(jplan)
    shares = [spmd.local_plan(plan, nd, r) for r in range(nd)]
    for gi, g in enumerate(plan.groups):
        parts = [s.groups[gi] for s in shares]
        assert sum(p.batch for p in parts) == g.batch
        ws = np.empty(g.batch, dtype=np.int64)
        for r, p in enumerate(parts):
            ws[r::nd] = p.ws
            # every kept A entry is the rank's own, renumbered j // nd
            keep = p.a_slot < p.batch
            assert np.all(np.asarray(g.a_slot)[np.asarray(g.a_slot) % nd
                                               == r] // nd
                          == p.a_slot[keep])
        np.testing.assert_array_equal(ws, g.ws)
        # the A entries and the children of every rank add up to the group's
        assert sum(int((p.a_slot < p.batch).sum()) for p in parts) == \
            len(g.a_slot)
        for ci, cs in enumerate(g.children):
            assert sum(int((p.children[ci].child_slot < p.batch).sum())
                       for p in parts) == len(cs.child_slot)


# ---------------------------------------------------------------------------
# the executor and the solver on spawned gloo ranks
# ---------------------------------------------------------------------------

_RUNS = {}


def _run(nd):
    if nd not in _RUNS:
        args = [(name, plan_from_reference(jp), v, an, dt)
                for name in NAMES for jp, v, an, dt in [_jax_case(name)]]
        _RUNS[nd] = run_mesh_ranks(nd, cases.spmd_vs_stream, args,
                                   timeout=240,
                                   env={"SLU_TPU_VERIFY_COLLECTIVES": "1"})
    return _RUNS[nd]


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_spmd_fronts_bitwise_the_stream(nd, name):
    out = _run(nd)
    for r in range(nd):
        rec = out[r][name]
        assert rec["fronts_equal"], (r, name)
        assert rec["tiny"][0] == rec["tiny"][1], (r, name)
        assert rec["executor"]["executor"] == "spmd"
        assert rec["executor"]["nd"] == nd


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_spmd_solver_bitwise_the_device_solver(nd, name):
    out = _run(nd)
    for r in range(nd):
        solves = out[r][name]["solves"]
        assert all(solves.values()), (r, name, solves)
        if name == "helmholtz":
            assert "C" in solves
    # every rank returns the same X (the replayed scatters)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_own_panels(nd, name):
    out = _run(nd)
    slots = [out[r][name]["shard"]["owned_slots"] for r in range(nd)]
    plan = plan_from_reference(_jax_case(name)[0])
    assert sum(slots) == sum(g.batch for g in plan.groups)
    for r in range(nd):
        sh = out[r][name]["shard"]
        assert sh["own_slots_only"], (r, name)
        assert sh["groups"] == len(plan.groups)
    # the panels add up to the whole factor: no rank holds another's
    total = sum(out[r][name]["shard"]["front_bytes"] for r in range(nd))
    item = 16 if name == "helmholtz" else 8
    whole = sum(g.batch * (g.m * g.w + g.w * g.u) for g in plan.groups) * item
    assert total == whole


#: hilbert(48) (condition number past 1e60) is held bit for bit against
#: the port's own stream only: between two frameworks its fronts differ
#: wherever one rounding does, amplified by the conditioning (3.4e-6
#: relative), which no eps-scaled tolerance describes
JAX_COMPARED = [name for name in NAMES if name != "hilbert"]


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("name", JAX_COMPARED)
def test_spmd_against_the_jax_spmd_tier(nd, name):
    if len(jax.devices()) < nd:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    jplan, vals, anorm, dt = _jax_case(name)
    mesh = jgridinit(1, nd).mesh
    jf = jfactorize(jplan, vals, anorm, dtype=dt, executor="spmd", mesh=mesh)
    rec = _run(nd)[0][name]
    assert rec["tiny"][0] == jf.tiny_pivots
    for (lp, up), (jl, ju) in zip(rec["fronts"], jf.fronts):
        np.testing.assert_allclose(lp, np.asarray(jl),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
        np.testing.assert_allclose(up, np.asarray(ju),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
    rhs = cases._rhs(jplan.n, 3, dt.startswith("complex"), 7)
    jx = np.asarray(jspmd.SpmdSolver(jf, mesh).solve(rhs))
    np.testing.assert_allclose(rec["x"], jx, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)


# ---------------------------------------------------------------------------
# collective discipline
# ---------------------------------------------------------------------------

def test_divergent_collectives_raise_on_every_rank():
    out = run_mesh_ranks(2, cases.mismatched_collectives, timeout=120,
                         env={"SLU_TPU_VERIFY_COLLECTIVES": "1"})
    assert out == {0: "mismatch: CollectiveMismatchError",
                   1: "mismatch: CollectiveMismatchError"}


def test_deadline_is_a_collective_decision():
    out = run_mesh_ranks(2, cases.deadline_expires,
                         ("poisson3d", (6,), 0, None), timeout=120)
    assert out == {0: "expired on 1 rank(s)", 1: "expired on 1 rank(s)"}


def test_spmd_off_a_grid_is_the_stream():
    """executor="spmd" without a grid, and on a one-rank grid: the
    stream executor (the JAX package's rule without a mesh), plain
    factors bit for bit the stream's."""
    from superlu_dist_tpu_torch.numeric.factor import numeric_factorize
    from superlu_dist_tpu_torch.parallel.grid import gridinit
    jplan, vals, anorm, _ = _jax_case("poisson")
    plan = plan_from_reference(jplan)
    f0 = numeric_factorize(plan, vals, anorm, dtype=torch.float64,
                           device="cpu", executor="stream")
    for grid in (None, gridinit(1, 1, "cpu")):
        f1 = numeric_factorize(plan, vals, anorm, dtype=torch.float64,
                               device="cpu", executor="spmd", grid=grid)
        assert f1.shard is None and f1.executor["executor"] == "stream"
        for (a, b), (c, d) in zip(f1.fronts, f0.fronts):
            assert torch.equal(a, c) and torch.equal(b, d)


def test_spmd_knob_is_jax_only(monkeypatch):
    """SLU_TPU_SPMD chooses between the JAX package's two mesh executors;
    the port has one, so the knob is not registered and strict env
    refuses it."""
    from superlu_dist_tpu.utils import options as joptions
    from superlu_dist_tpu_torch.utils import options
    assert "SLU_TPU_SPMD" in joptions.KNOB_REGISTRY
    assert "SLU_TPU_SPMD" not in options.KNOB_REGISTRY
    monkeypatch.setenv("SLU_TPU_STRICT_ENV", "1")
    monkeypatch.setenv("SLU_TPU_SPMD", "0")
    monkeypatch.setattr(options, "_strict_checked", False)
    with pytest.raises(options.UnknownKnobError, match="SLU_TPU_SPMD"):
        options.env_int("SLU_TPU_SOLVE_NRHS_MAX")
