"""The grid's graph executors as one graph a unit
(superlu_dist_tpu_torch/parallel/mesh_graphs.py, parallel/grid.py), on
gloo CPU ranks (``testing.ranks.run_mesh_ranks``, functions in
tests/torch_mesh_cases.py).  On an NCCL grid of distinct cards each unit
— a group (fused), a schedule wave (level), a closed key (mega) — is one
CUDA graph holding its collectives; what the CPU can hold of that:

* the unit plan of each family on 1×2 and 2×2 grids over poisson3d(10)
  and its closed plan: the graphs are the groups, the waves, the closed
  keys; the exchange counts each rank's programs issue are the group's
  own (on gloo and the CPU every family's; on NCCL mega's are padded to
  the group shape), and on every rank pair what r sends to d is what d
  receives from r, for every group (a captured all-to-all whose legs
  disagree would hang);
* the programs of poisson3d(7) driven as a capture drives them (inside
  ``ProcessGrid.recording``) with SLU_TPU_VERIFY_COLLECTIVES on: no
  verify check runs while they record, ``check_tape`` runs them after,
  the fronts and tiny count are the eager 2-D executor's, and a
  divergent record raises on every rank;
* every graph executor's fronts, pivot stacks and tiny count — and
  mega's with its legs padded as on NCCL — bit for bit the 2-D
  executor's, and within SCHEDULE_DRIFT of the JAX
  ``StreamExecutor(mesh=gridinit(2, 2).mesh, pool_partition=True)``;
* the card's rule: a one-card refusal of the closed plan names the grid
  as its remedy; on a 2×2 grid of four distinct (fake) cards each rank is
  held to its own card's budget; each rank's traced peak (the storages
  torch ops keep alive, ``testing/livebytes.py``) at or below its
  estimate.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit

import torch_mesh_cases as cases
import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
SHAPES = [(1, 2), (2, 2)]
_PLANS, _RUNS = {}, {}


def _plan(closed, nx=10):
    """poisson3d(nx)'s default plan, or its closed one: (plan, values,
    tiny-pivot threshold at float64)."""
    if (closed, nx) not in _PLANS:
        lu, bvals, _ = slt.analyze(slt.Options(bucket_closed=closed),
                                   gallery.poisson3d(nx), device="cpu")
        thresh = float(np.sqrt(np.finfo(np.float64).eps) * lu.anorm)
        _PLANS[(closed, nx)] = (lu.plan, bvals, thresh)
    return _PLANS[(closed, nx)]


def _suite(shape):
    """Every spawned case of this file, once, on one spawned 2×2 gloo
    grid (verify mode on), in order: on each process row as a 1×2 grid
    of its own the unit plans of the open and the closed plan, the
    recorded programs and a divergent record; then on the 2×2 grid the
    unit plans, the recorded programs, the graph executors against the
    2-D executor on tests/test_parallel.py's plan, the card's rule on
    four fake cards and the 2-D stream's traced peak.  Returns the ``shape`` grid's results by rank (on
    1×2, the first row's)."""
    if not _RUNS:
        plan, closed = _plan(False)[0], _plan(True)[0]
        small, svals, sthresh = _plan(False, 7)
        common = [("units open", "unit_plans", (plan,)),
                  ("units closed", "unit_plans", (closed,)),
                  ("recorded", "recorded_programs",
                   (small, svals, sthresh, False))]
        jplan, avals, jthresh = _jax_case()
        items = [("1x2", "row_suite", (common + [
                     ("diverged", "recorded_programs",
                      (small, svals, sthresh, True))],))] + common
        items += [("vs 2d", "graph_executors_vs_2d",
                   (plan_from_reference(jplan), np.asarray(avals),
                    float(np.asarray(jthresh))))]
        items += [(f"rule {k}", "rule_on_own_cards",
                   (closed, "float32", budgets)) for k, budgets in RULES]
        items += [("traced", "traced_peak", (8,))]
        out = run_mesh_ranks(4, cases.suite, items, nprow=2, timeout=300,
                             env=VERIFY)
        _RUNS[(2, 2)] = out
        _RUNS[(1, 2)] = {r: out[r]["1x2"] for r in (0, 1)}
    return _RUNS[shape]


def _jax_case():
    from test_parallel import _plan as jax_plan
    return jax_plan()


#: rank r's fake budget in each run of the four-card rule
RULES = (("own", ["own"] * 4),
         ("offloaded", ["own", "own", "offloaded", "own"]),
         ("below", ["own", "own", "below", "own"]))


def _units(shape, closed):
    out = _suite(shape)
    return {r: rec["units closed" if closed else "units open"]
            for r, rec in out.items()}


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("family", cases.GRAPH_EXECUTORS)
def test_the_unit_plan_of_each_family(family, shape, closed):
    """Fused's graphs are the groups, level's the schedule waves (runs of
    one level, in order, covering every group), mega's the closed keys
    (each group under its own key on this rank); the exchange counts on
    gloo are the group's own, mega's padded ones (NCCL's) the largest of
    its group shape's, and every rank pair's legs agree on every group,
    padded or not (exact: integer counts)."""
    plan = _plan(closed)[0]
    out = _units(shape, closed)
    nd = len(out)
    for r in range(nd):
        rec = out[r][family]
        units = [tuple(g) for g in rec["units"]]
        if family == "fused":
            assert units == [(gi,) for gi in range(len(plan.groups))]
        elif family == "level":
            assert sum(units, ()) == tuple(range(len(plan.groups)))
            for prev, unit in zip([None] + units, units):
                assert len({rec["levels"][g] for g in unit}) == 1
                if prev is not None:
                    assert rec["levels"][prev[-1]] != rec["levels"][unit[0]]
        else:
            assert sorted(sum(units, ())) == list(range(len(plan.groups)))
            for groups in units:
                assert len({tuple(rec["keys"][g]) for g in groups}) == 1
            assert len(units) == len({tuple(k) for k in rec["keys"]})
        assert rec["counts"] == rec["own"]
        for gi, ((send, recv), (own_s, own_r)) in enumerate(
                zip(rec.get("padded", ()), rec["own"])):
            assert all(p >= o for p, o in zip(send + recv, own_s + own_r))
            g = plan.groups[gi]
            same = [j for j, h in enumerate(plan.groups)
                    if (h.w, h.u) == (g.w, g.u)]
            assert all(rec["padded"][j] == rec["padded"][gi] for j in same)
    for kind in ("counts", "padded"):
        if kind not in out[0][family]:
            continue
        for gi in range(len(plan.groups)):
            for r in range(nd):
                for d in range(nd):
                    assert out[r][family][kind][gi][0][d] == \
                        out[d][family][kind][gi][1][r], (kind, gi, r, d)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
def test_verify_checks_move_out_of_the_recorded_programs(shape):
    """SLU_TPU_VERIFY_COLLECTIVES with the programs recorded as a capture
    records them: no verify check runs inside a program, ``check_tape``
    runs one a record after it (and an exchange's counts), the records
    carry the broadcasts and the exchange with their bytes, and the
    fronts and tiny count are the eager executor's, bit for bit."""
    for r, rec in _suite(shape).items():
        rec = rec["recorded"]
        assert not rec["raised"] and not rec["during"], rec
        assert rec["checked"] == rec["records"]
        assert "exchange" in rec["ops"] and rec["bytes"] > 0
        assert ("bcast_row" in rec["ops"]) == (shape[1] > 1)
        assert rec["same"] and rec["tiny"][0] == rec["tiny"][1]


def test_a_divergent_record_raises_on_every_rank():
    """Rank 1's record of group 0's exchange differs: ``check_tape``
    raises CollectiveMismatchError on both ranks, before any graph would
    have run, and no check ran while a program recorded."""
    for r, rec in _suite((1, 2)).items():
        rec = rec["diverged"]
        assert rec["raised"] and not rec["during"], rec
        assert "exchange" in rec["message"]


def test_graph_executors_bitwise_the_2d_executor_and_near_jax():
    """On a 2×2 grid every graph executor's fronts, pivot stacks and tiny
    count — mega's also with its exchange legs padded to its group
    shapes, as on NCCL — are the eager 2-D executor's bit for bit, and
    its gathered
    fronts are within SCHEDULE_DRIFT of the JAX StreamExecutor over
    gridinit(2, 2) with the partitioned pool on the same plan and values
    (tests/test_parallel.py's), whose tiny count they equal."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    jplan, avals, thresh = _jax_case()
    fronts, tiny = JStream(jplan, "float64", mesh=jgridinit(2, 2).mesh,
                           pool_partition=True)(jnp.asarray(avals),
                                                jnp.asarray(thresh))
    out = {r: rec["vs 2d"] for r, rec in _suite((2, 2)).items()}
    names = cases.GRAPH_EXECUTORS + ("mega padded",)
    for r in range(4):
        for name in names:
            rec = out[r][name]
            assert rec["equal"] and rec["pivots"], (r, name)
            assert rec["tiny"][0] == rec["tiny"][1] == int(tiny)
    for name in names:
        for (lp, up), (jl, ju) in zip(out[0][name]["fronts"], fronts):
            np.testing.assert_allclose(lp, np.asarray(jl),
                                       rtol=tols.SCHEDULE_DRIFT_RTOL,
                                       atol=tols.SCHEDULE_DRIFT_ATOL)
            np.testing.assert_allclose(up, np.asarray(ju),
                                       rtol=tols.SCHEDULE_DRIFT_RTOL,
                                       atol=tols.SCHEDULE_DRIFT_ATOL)


def test_the_closed_plan_refused_on_one_card_names_the_grid(monkeypatch):
    """The card's rule on one card whose budget is the closed plan's
    streamed estimate offloaded, less one byte: refused by name, even
    offloaded, with a grid over several cards with pool_partition among
    its remedies; the 2-D stream over a 2×2 grid of the same plan holds
    on each rank less than half its pool, and fewer factor bytes."""
    import torch
    from superlu_dist_tpu_torch.numeric import stream
    from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError
    plan = _plan(True)[0]
    est = stream.offload_estimate(plan, torch.float32)
    monkeypatch.setattr(stream, "device_budget",
                        lambda device: est["offload_bytes"] - 1)
    with pytest.raises(DeviceMemoryError) as err:
        stream.offload_rule(plan, torch.float32, torch.device("cuda", 0),
                            None)
    assert err.value.executor == "stream"
    assert any("grid over several cards with Options(pool_partition=True)"
               in r for r in err.value.remedies)
    out = _units((2, 2), True)
    for r in range(4):
        mine = out[r]["estimate"]
        assert mine["pool_bytes"] < est["pool_bytes"] / 2
        assert mine["factor_bytes"] < est["factor_bytes"]


def test_four_distinct_cards_each_hold_their_own_rank():
    """A 2×2 gloo grid of CPU ranks over the closed plan, each rank on a
    fake card of its own: with every budget its rank's own estimate the
    grid keeps the factors, and each rank's record is its own card's
    (one rank, its bytes, its budget); with rank 2's budget at its
    offloaded estimate mesh mega offloads on every rank and mesh fused,
    which cannot, is refused on every rank; one byte below that, both
    are refused on every rank, naming one card."""
    out = _suite((2, 2))
    runs = {k: {r: out[r][f"rule {k}"] for r in out} for k, _ in RULES}
    for r in range(4):
        for name in ("mega", "fused"):
            rec = runs["own"][r][name]
            assert rec["kind"] == "built" and rec["offload"] == "none"
            rule = rec["rule"]
            assert (rule["card_ranks"], rule["card_bytes"],
                    rule["card_limit"]) == (1, rec["est"]["bytes"],
                                            rec["budget"])
            assert rule["bytes"] == rec["est"]["bytes"]
        off = runs["offloaded"][r]
        assert off["mega"]["kind"] == "built", off["mega"]
        assert off["mega"]["offload"] == "host"
        assert off["fused"]["kind"] == "refused"
        assert off["fused"]["executor"] == "mesh-fused"
        below = runs["below"][r]
        for name in ("mega", "fused"):
            assert below[name]["kind"] == "refused", (r, name)
            assert below[name]["executor"] == "mesh-" + name
            assert below[name]["parts"]["cards_refused"] == 1
            assert below[name]["parts"]["card_ranks"] == 1


def test_each_rank_holds_at_most_its_estimate():
    """The 2-D stream through pgssvx(grid=) on poisson3d(8)'s closed plan
    over the 2×2 grid, each rank's device memory traced on the CPU from
    FACT to the end of the call (the storages torch ops keep alive; the
    plain kernels count by their outputs): the peak at or below the
    rank's estimate, the card's rule's bytes (exact: byte counts), and
    every kept front slice in a storage of its own size — a slice that
    is a view keeps its whole front alive beside the factors (a rank
    with none of a group's pivot columns), which no estimate counts."""
    for r, rec in _suite((2, 2)).items():
        rec = rec["traced"]
        assert rec["own"] and rec["slices"] > 0, (r, rec)
        assert 0 < rec["peak"] <= rec["estimate"], (r, rec)
