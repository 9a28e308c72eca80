"""The spmd tier as a grid of distinct cards captures it
(superlu_dist_tpu_torch/parallel/spmd.py), on gloo CPU ranks
(``testing.ranks.run_mesh_ranks``, functions in tests/torch_mesh_cases.py).
On an NCCL grid each group's program of ``SpmdFactorExecutor`` is one CUDA
graph with its ``gather_rows`` inside, and each sweep of ``SpmdSolver`` a
graph with its gathers and row sums; what the CPU can hold of that:

* the executor's capture path run on a grid that claims to be capturable
  (``torch_mesh_cases.eager_capture``: each group's program recorded
  inside ``ProcessGrid.recording`` at the first call, run again at the
  second as a replay runs it) with SLU_TPU_VERIFY_COLLECTIVES on: no
  verify check runs while a program records, ``check_tape`` runs them
  after, the fronts, pivot stacks and tiny count are the eager spmd
  executor's bit for bit at the capture and at the replay, one census
  record a group, none at the replay, no retrace; a divergent record
  raises on every rank;
* the grid solver's sweeps recorded the same way, on the spmd shards and
  the 2-D tier's, bit for bit the eager sweeps (nrhs 1 and 4, TRANS);
* the captured fronts within SCHEDULE_DRIFT and x within DEVICE_VS_HOST
  of the JAX ``SpmdFactorExecutor`` / ``SpmdSolver`` on a single-process
  CPU mesh of as many devices;
* the solver's graph decision ignores FUSE_MAX_BATCHES on a capturable
  grid (the JAX SpmdSolver is one program a bucket whatever the batch
  count), and nothing captures on gloo;
* each rank's traced peak (``testing/livebytes.py``) at or below the
  captured executor's estimate.
"""

import numpy as np
import pytest

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
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
SHAPES = [(1, 2), (2, 2)]
IDS = ["1x2", "2x2"]
#: poisson3d's edge a grid shape runs at, and the traced peak's
NX = {(1, 2): 7, (2, 2): 9}
PEAK_NX = 10
_JAX, _RUNS = {}, {}


def _jax_case(nx):
    """poisson3d(nx) analyzed by the JAX package as tests/test_spmd.py
    analyzes (ND order, symbolic, dataflow plan): (plan, values, ‖A‖)."""
    if nx not in _JAX:
        a = jgal.poisson3d(nx)
        sym = jsym(a)
        sf = jsymbolic(sym, jget_perm_c(JOptions(), a, sym))
        _JAX[nx] = (jbuild_plan(sf, schedule="dataflow"),
                    np.asarray(sym.data[sf.value_perm]), a.norm_max())
    return _JAX[nx]


def _rhs(n):
    return np.random.default_rng(11).standard_normal((n, 4))


def _items(nx, extra=()):
    jplan, vals, anorm = _jax_case(nx)
    case = (plan_from_reference(jplan), vals, anorm)
    return [("captured", "spmd_captured", case + (_rhs(jplan.n),))] \
        + list(extra)


def _suite(shape):
    """Every spawned case of this file, once, on one spawned 2×2 gloo grid
    (verify mode on): on each process row as a 1×2 grid of its own the
    captured executor and solver, the graph decision and a divergent
    record; then on the 2×2 grid the captured executor and solver and
    the traced peak.  Returns the ``shape`` grid's results by rank (on
    1×2, the first row's)."""
    if not _RUNS:
        jplan, vals, anorm = _jax_case(NX[(1, 2)])
        small = (plan_from_reference(jplan), vals, anorm)
        row = _items(NX[(1, 2)], [
            ("decision", "spmd_graph_decision", small),
            ("diverged", "spmd_capture_diverged", small)])
        items = [("1x2", "row_suite", (row,))] + _items(
            NX[(2, 2)], [("peak", "spmd_capture_peak", (PEAK_NX,))])
        out = run_mesh_ranks(4, cases.suite, items, nprow=2, timeout=300,
                             env=VERIFY)
        _RUNS[(2, 2)] = out
        _RUNS[(1, 2)] = {r: out[r]["1x2"] for r in (0, 1)}
    return _RUNS[shape]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_group_graphs_bitwise_the_eager_executor(shape):
    """The captured executor's fronts, pivot stacks and tiny count equal
    the eager spmd executor's bit for bit on every rank, at the capturing
    call and at the replay; the capturing call records one graph a group
    in the census (site spmd.unit), the replay none, and neither counts a
    retrace; the report says one graph a group, of kind "unit"; on gloo
    the executor runs eagerly.  The captured executor writes every Schur
    block one slice copy a slot (as the card does for large blocks), the
    eager one in indexed writes: the same pool, bit for bit."""
    for r, rec in _suite(shape).items():
        rec = rec["captured"]
        groups = rec["groups"]
        assert rec["capture"] and not rec["eager_capture"], rec
        assert rec["slot_writes"] > 0
        assert rec["graph_kind"] == "unit" and rec["graphs"] == groups
        capture, replay = rec["calls"]
        assert (capture["graphs"], replay["graphs"]) == (groups, 0), rec
        assert capture["retraces"] == replay["retraces"] == 0
        for call in (capture, replay):
            assert call["equal"] and call["pivots"], (r, call)
            assert call["tiny"][0] == call["tiny"][1]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_verify_checks_move_out_of_the_recorded_programs(shape):
    """SLU_TPU_VERIFY_COLLECTIVES with the group programs recorded as a
    capture records them: no verify check runs inside a program; at the
    capturing call ``check_tape`` runs one a record (a gather_rows a
    group, and the tiny count's all-reduce and the deadline-free call's
    other eager collectives besides), at the replay none runs for the
    graphs' collectives; ``replayed`` counts one gather a group at the
    replay, as the eager executor issues."""
    for r, rec in _suite(shape).items():
        rec = rec["captured"]
        capture, replay = rec["calls"]
        assert not capture["during"] and not replay["during"], rec
        assert rec["ops"] == ["gather_rows"]
        assert rec["gathered"] == rec["groups"]
        assert capture["checked"] >= rec["gathered"]
        assert replay["checked"] == capture["checked"] - rec["gathered"]
        assert replay["gathers"] == capture["gathers"] == rec["groups"]


def test_a_divergent_record_raises_on_every_rank():
    """Rank 1's record of group 0's gather differs: ``check_tape`` raises
    CollectiveMismatchError on both ranks before the group's graph would
    first run (none is kept), and no check ran while a program
    recorded."""
    for r, rec in _suite((1, 2)).items():
        rec = rec["diverged"]
        assert rec["raised"] and not rec["during"], rec
        assert "gather_rows" in rec["message"] and rec["graphs"] == 0


@pytest.mark.parametrize("tier", ["spmd", "2d"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_recorded_sweeps_bitwise_the_eager_solve(shape, tier):
    """The grid solver's sweeps recorded as a capture records them (its
    own ``_recording`` hook: ``check_tape`` after each), on the spmd
    shards and on the 2-D tier's: x at NOTRANS nrhs 1 and 4 and at TRANS
    bit for bit the eager sweeps'; no verify check while a sweep records,
    one a record after; the records hold the products' gathers (and on
    the 2-D tier with process columns the row sums); the JAX label."""
    for r, rec in _suite(shape).items():
        rec = rec["captured"][f"solve_{'1d' if tier == 'spmd' else tier}"]
        assert all(rec["equal"].values()), (r, rec["equal"])
        assert not rec["during"] and rec["checked"] >= rec["records"] > 0
        ops = set(rec["ops"])
        if tier == "spmd":
            assert ops == {"all_gather"}, ops
        else:
            assert "all_reduce_row" in ops, ops
            assert ("all_gather_col" in ops) == (shape[0] > 1), ops
        assert rec["site"] == "solve.spmd" and not rec["fused"]
        assert rec["label"].startswith("spmd-sweep n")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_captured_fronts_and_x_near_the_jax_spmd_tier(shape):
    """The captured executor's fronts, gathered to slot order, within
    SCHEDULE_DRIFT of the JAX SpmdFactorExecutor over a CPU mesh of as
    many devices on the same plan and values (the tiny count equal), and
    the recorded solves' x — on the spmd shards and the 2-D tier's —
    within DEVICE_VS_HOST of the JAX SpmdSolver's."""
    nd = shape[0] * shape[1]
    if len(jax.devices()) < nd:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    jplan, vals, anorm = _jax_case(NX[shape])
    mesh = jgridinit(*shape).mesh
    jf = jfactorize(jplan, vals, anorm, dtype="float64", executor="spmd",
                    mesh=mesh)
    rec = _suite(shape)[0]["captured"]
    assert rec["calls"][0]["tiny"][0] == jf.tiny_pivots
    for (lp, up), (jl, ju) in zip(rec["fronts"], jf.fronts):
        np.testing.assert_allclose(lp, np.asarray(jl),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
        np.testing.assert_allclose(up, np.asarray(ju),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
    jx = np.asarray(jspmd.SpmdSolver(jf, mesh).solve(_rhs(jplan.n)))
    for tier in ("solve_1d", "solve_2d"):
        np.testing.assert_allclose(rec[tier]["x"], jx,
                                   rtol=tols.DEVICE_VS_HOST_RTOL,
                                   atol=tols.DEVICE_VS_HOST_ATOL)


def test_graph_decision_ignores_fuse_max_batches():
    """With FUSE_MAX_BATCHES at 0 — every plan over the single card's cap
    — SpmdSolver on a capturable grid still captures its sweeps, on a
    gloo grid it runs them eagerly, and asking for graphs there raises
    ValueError, as does a capturing spmd executor on gloo."""
    for r, rec in _suite((1, 2)).items():
        rec = rec["decision"]
        assert rec["batches"] > 0
        assert rec["capturable"] is True and rec["gloo"] is False, rec
        assert rec["refused"] == [True, True], rec


def test_each_rank_holds_at_most_its_capture_estimate():
    """The captured spmd executor on poisson3d(10) over the 2×2 grid,
    each rank's device memory traced on the CPU (the storages torch ops
    keep alive; the kernels' plain versions counted by their outputs)
    over the capturing call, a replay, the grid solver and a solve: the
    peak at or below the rank's estimate with ``capture`` — the card's
    rule's bytes —, which counts the graphs' outputs and the largest
    group program's working set beside the eager executor's parts
    (exact: byte counts)."""
    for r, rec in _suite((2, 2)).items():
        rec = rec["peak"]
        assert 0 < rec["peak"] <= rec["estimate"], (r, rec)
        assert rec["estimate"] > rec["eager"] and rec["graph_bytes"] > 0
