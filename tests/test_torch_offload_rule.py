"""The card's offload rule (numeric/stream.offload_rule), on the CPU.

``Options().front_bytes_limit`` is None: an executor built with it
offloads the factors to host memory when the main path's estimated peak
(``offload_estimate``) exceeds the card's free memory
(``device_budget``); an explicit number keeps the JAX package's rule,
the plan's padded front bytes against it (superlu_dist_tpu/numeric/
stream.py:218-226).  Here ``torch.cuda.mem_get_info`` and the caching
allocator's counters are replaced by fake readings, the grid's ranks
read fake budgets, and the parts of the estimate are held against what
a CPU factorization and its device solve really hold.  Each executor
either fits, offloads, or — where even its offloaded estimate is over
the budget, or it cannot offload — is refused by name
(``DeviceMemoryError``) before it uploads anything, on a grid on every
rank; the escalation ladder records such a refusal as a rung.  Then the
rendezvous of concurrent spawned grids.  Last, the front-assembly
kernel's maps at pool offsets above 2**31 (poisson3d(100) reads pool
values up to 5.2e9), built without such a pool.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.stream import StreamExecutor as JaxStream
from superlu_dist_tpu.utils.options import Options as JaxOptions

import torch_mesh_cases as cases
import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric import factor, kernels, stream
from superlu_dist_tpu_torch.numeric.fused import FusedExecutor
from superlu_dist_tpu_torch.numeric.mega import MegaExecutor
from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
from superlu_dist_tpu_torch.numeric.plan import bucket_rung
from superlu_dist_tpu_torch.numeric.stream import (StreamExecutor,
                                                   offload_estimate,
                                                   offload_rule,
                                                   padded_front_bytes)
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.testing.ranks import rendezvous, run_mesh_ranks
from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError

CARD = torch.device("cuda", 0)
TOTAL = 80 * 10 ** 9
SHIFT = 2 ** 31 + 7
_PLANS = {}


def _plan(nx=8):
    if nx not in _PLANS:
        lu, bvals, _ = slt.analyze(slt.Options(), gallery.poisson3d(nx),
                                   device="cpu")
        _PLANS[nx] = (lu.plan, bvals, lu.anorm)
    return _PLANS[nx]


def _fake_card(monkeypatch, free, reserved=0, allocated=0):
    """The card's memory readings: ``free`` of TOTAL bytes, and the
    caching allocator holding ``reserved`` bytes of which ``allocated``
    are in use."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (int(free), TOTAL))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: int(reserved))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: int(allocated))


def _free_for(budget, cached=0):
    """The free bytes at which the budget is ``budget``."""
    return budget - cached + stream.OFFLOAD_RESERVE_SHARE * TOTAL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_card_with_room_keeps_the_factors(monkeypatch, dtype):
    """The boundary lies at the estimate: a budget of exactly the
    estimate keeps the factors on the card, one byte less offloads."""
    plan = _plan()[0]
    full = offload_estimate(plan, dtype)
    est = full["bytes"]
    _fake_card(monkeypatch, _free_for(est))
    choice, rec = offload_rule(plan, dtype, CARD, None)
    assert choice == "none"
    assert rec == {"rule": "card", "bytes": est, "limit": est, "over": False,
                   "offload_bytes": full["offload_bytes"]}
    _fake_card(monkeypatch, _free_for(est - 1))
    choice, rec = offload_rule(plan, dtype, CARD, None)
    assert choice == "host" and rec["limit"] == est - 1 and rec["over"]


def test_cached_blocks_count_as_free(monkeypatch):
    """Blocks the caching allocator holds unused (a first FACT's pool,
    freed) are the budget's: a second FACT in the same process that the
    first one fitted fits too."""
    plan = _plan()[0]
    est = offload_estimate(plan, torch.float32)["bytes"]
    cached = est // 2
    _fake_card(monkeypatch, _free_for(est, cached), reserved=cached + 1000,
               allocated=1000)
    assert offload_rule(plan, torch.float32, CARD, None)[0] == "none"
    _fake_card(monkeypatch, _free_for(est, cached), reserved=cached,
               allocated=1000)
    assert offload_rule(plan, torch.float32, CARD, None)[0] == "host"


def _no_estimate():
    raise AssertionError("the estimate was made without a budget")


def test_the_default_on_the_cpu_keeps_the_factors():
    """``Options().front_bytes_limit`` is None, and None off the card
    means no offload: the CPU has no budget, and no estimate is made."""
    plan, bvals, anorm = _plan()
    assert slt.Options().front_bytes_limit is None
    assert offload_rule(plan, torch.float32, torch.device("cpu"), None,
                        estimate=_no_estimate) == (
        "none", {"rule": "card", "bytes": None, "limit": None,
                 "over": False, "offload_bytes": None})
    ex = StreamExecutor(plan, torch.float32, "cpu")
    assert ex.offload == "none"
    assert ex.report()["offload_rule"]["limit"] is None
    a = gallery.poisson3d(8)
    x, lu, st, info = slt.gssvx(slt.Options(executor="stream"), a,
                                a.matvec(np.ones(a.n_rows)), device="cpu")
    assert info == 0 and st.executor["offload"] == "none"
    assert st.executor["offload_rule"]["rule"] == "card"
    assert not lu.numeric.on_host


def _jax_choice(monkeypatch, jplan, dtype, limit):
    """The JAX package's StreamExecutor's "auto" at
    SLU_TPU_FRONT_BYTES_LIMIT=limit, on a backend other than the CPU."""
    monkeypatch.setenv("SLU_TPU_FRONT_BYTES_LIMIT", repr(float(limit)))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    try:
        return JaxStream(jplan, dtype=dtype, offload="auto").offload
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_an_explicit_limit_is_the_jax_rule(monkeypatch, dtype):
    """A number is the JAX package's rule on the same plan: "host" when
    the padded front bytes exceed it, on either side of the boundary."""
    lu, _, _ = jax_analyze(JaxOptions(), jgal.poisson3d(8))
    jplan = lu.plan
    plan = plan_from_reference(jplan)
    tdt = getattr(torch, dtype)
    padded = padded_front_bytes(plan, tdt)
    for limit in (0, padded - 1, padded, padded + 1, 6e9):
        want = _jax_choice(monkeypatch, jplan, getattr(jnp, dtype), limit)
        choice, rec = offload_rule(plan, tdt, CARD, limit)
        assert choice == want == ("host" if padded > limit else "none")
        assert rec == {"rule": "front_bytes_limit", "bytes": padded,
                       "limit": limit, "over": padded > limit}
        # on the CPU the JAX rule keeps the factors; on a grid it offloads
        assert offload_rule(plan, tdt, torch.device("cpu"), limit)[0] \
            == "none"


def test_the_estimate_holds_the_pool_and_the_padded_factors():
    """By hand from the plan's groups: the estimate is at least the pool
    and the pow-2 padded factors together, and its parts."""
    plan = _plan(10)[0]
    for dtype, s in ((torch.float32, 4), (torch.float64, 8)):
        est = offload_estimate(plan, dtype)
        pool = plan.pool_size * s
        padded = sum(bucket_rung(g.batch, lo=1, growth=2.0)
                     * (g.m * g.w + g.w * g.u) for g in plan.groups) * s
        assert est["pool_bytes"] == pool and est["factor_bytes"] == padded
        assert est["bytes"] >= pool + padded + est["work_bytes"]
        big = max(plan.groups, key=lambda g: g.batch * g.m * g.m)
        assert est["work_bytes"] >= 2 * big.batch * big.m * big.m * s
        # a graph executor holds its pool after FACT too
        keep = offload_estimate(plan, dtype, graphs=0)
        assert keep["bytes"] >= pool + padded + est["solve_copy_bytes"]
        assert offload_estimate(plan, dtype, graphs=0, warm=3 * pool)[
            "bytes"] >= 4 * pool


def test_the_estimate_bounds_what_the_path_holds():
    """The parts held against a CPU factorization: its factors, the
    device solve's gathered panels and the uploaded index maps."""
    plan, bvals, anorm = _plan(10)
    num = factor.numeric_factorize(plan, bvals, anorm, dtype=torch.float32,
                                   device="cpu", executor="stream")
    est = offload_estimate(plan, torch.float32)
    kept = sum(t.numel() * t.element_size() for p in num.fronts for t in p)
    assert 0 < kept <= est["factor_bytes"]
    solver = DeviceSolver(num)
    assert 0 < solver.gathered_bytes <= est["solve_copy_bytes"]
    maps = factor.upload_maps(plan, torch.device("cpu"))
    held = sum(t.numel() * t.element_size()
               for gm in maps
               for t in (gm.ws, gm.off, gm.a_slot, gm.a_flat, gm.a_src,
                         *gm.front.tensors(),
                         *(x for c in gm.children for x in c[1:]),
                         *(() if gm.keep is None else (gm.keep,))))
    assert held <= est["map_bytes"]


def test_a_level_executor_counts_its_graphs(monkeypatch):
    """Level waves keep a static pool, and one private pool with every
    wave's packed factors and the largest step's working set: the
    executor's estimate holds them beside the factors cloned out, and
    the rule reads it — a budget that fits the streamed loop offloads
    the waves."""
    plan = _plan()[0]
    ex = StreamExecutor(plan, torch.float64, "cpu", granularity="level")
    est = ex.device_estimate()
    kept, _, work = stream.factor_parts(plan, 8)
    assert est == offload_estimate(plan, torch.float64, graphs=kept + work,
                                   units=ex.waves())
    assert est["bytes"] == (est["map_bytes"] + est["pool_bytes"] + 2 * kept
                            + work + est["solve_copy_bytes"])
    _fake_card(monkeypatch, _free_for(est["bytes"] - 1))
    assert offload_rule(plan, torch.float64, CARD, None,
                        estimate=ex.device_estimate)[0] == "host"
    assert offload_rule(plan, torch.float64, CARD, None)[0] == "none"


def _built_as_on_the_card(monkeypatch):
    """Executors built on the CPU resolve "auto" as on the card."""
    real = stream.offload_rule

    def on_card(plan, dtype, device, limit, grid=None, estimate=None, **kw):
        return real(plan, dtype, CARD, limit, grid, estimate, **kw)
    monkeypatch.setattr(stream, "offload_rule", on_card)


@pytest.mark.parametrize("closed", [False, True])
def test_the_mega_estimate_holds_its_pool_graphs_and_tables(monkeypatch,
                                                           closed):
    """Mega keeps a static pool at its store rung with the dump region
    (``_statics``), one private graph pool a bucket at the bucket's rung,
    a scratch pool beside the static one while the buckets warm up, and
    its padded tables: its estimate is those, by hand.  A card whose
    budget fits the streamed loop's estimate keeps the streamed
    executor's factors and refuses mega, whose graph pools do not fit
    even with the factors offloaded; a budget of mega's offloaded
    estimate offloads it."""
    lu, _, _ = slt.analyze(slt.Options(bucket_closed=closed),
                           gallery.poisson3d(10), device="cpu")
    plan, dt, s = lu.plan, torch.float64, 8
    ex = MegaExecutor(plan, dt, "cpu", offload="none")
    est = ex.device_estimate()
    pool = ex._statics()[2]
    assert pool.numel() >= plan.pool_size
    assert est["pool_bytes"] == pool.numel() * s
    first, most = {}, {}
    for g in plan.groups:
        first.setdefault((g.w, g.u), g)
        most[(g.w, g.u)] = max(most.get((g.w, g.u), 0), g.batch)
    assert ex.spec == {k: bucket_rung(b, lo=1, growth=2.0)
                       for k, b in most.items()}
    per = {k: stream.group_work_bytes(g, s, ex.spec[k])
           + ex.spec[k] * (g.m * g.w + g.w * g.u) * s
           for k, g in first.items()}
    for k, g in first.items():
        assert per[k] >= 2 * ex.spec[k] * g.m * g.m * s
    assert est["graph_bytes"] == sum(per.values())
    assert est["warm_bytes"] == est["pool_bytes"] + max(per.values())
    tables = sum(x.nbytes for _, ws, off, front, _ in ex._group_arrays()
                 for x in (ws, off, *front))
    assert est["map_bytes"] == 2 * tables + ex._AV * s
    kept = stream.factor_parts(plan, s)[0]
    assert est["bytes"] == est["map_bytes"] + est["pool_bytes"] + max(
        est["warm_bytes"], sum(per.values()) + kept
        + est["solve_copy_bytes"])
    streamed = offload_estimate(plan, dt)["bytes"]
    assert est["bytes"] > est["offload_bytes"] > streamed
    _built_as_on_the_card(monkeypatch)
    _fake_card(monkeypatch, _free_for(streamed))
    assert StreamExecutor(plan, dt, "cpu").offload == "none"
    # offloaded, mega's graph pools alone are over the streamed loop's
    # budget: refused by name
    with pytest.raises(DeviceMemoryError) as refused:
        MegaExecutor(plan, dt, "cpu")
    assert refused.value.executor == "mega"
    assert refused.value.parts["offload_bytes"] == est["offload_bytes"]
    _fake_card(monkeypatch, _free_for(est["offload_bytes"]))
    mega = MegaExecutor(plan, dt, "cpu")
    assert mega.offload == "host"
    assert mega.report()["offload_rule"] == {
        "rule": "card", "bytes": est["bytes"],
        "limit": est["offload_bytes"], "over": True,
        "offload_bytes": est["offload_bytes"]}


GRID_EXECUTORS = ("spmd", "mesh-stream", "mesh-mega")


def test_ranks_with_different_budgets_offload_alike():
    """A 1×2 gloo grid of CPU ranks on two fake cards, rank 0 with room
    and rank 1 with room only for its offloaded run: each rank's record
    says so of itself, and every grid executor, built through
    ``get_executor``, resolves "host" on both ranks after one all-reduce.  Each rank's estimate is its
    executor's own: spmd's holds the whole pool (every rank allocates
    it), mesh mega's its pool with the dump element, a scratch pool
    beside it while the graphs warm up, and the graphs' shared pool."""
    plan = _plan()[0]
    out = run_mesh_ranks(2, cases.offload_rule_ranks, plan, "float32",
                         [10 ** 15, "offloaded"], [1, 2], timeout=240)
    for r in (0, 1):
        for name in GRID_EXECUTORS:
            choice, rec, est, pool_len = out[r][name]
            assert choice == "host", (r, name)
            assert rec["bytes"] == est["bytes"] and rec["over"] == (r == 1)
            assert (rec["card_ranks"], rec["card_bytes"]) == (1, est["bytes"])
            assert est["pool_bytes"] == 4 * pool_len
        est = out[r]["mesh-mega"][2]
        assert est["warm_bytes"] >= est["pool_bytes"]
        assert est["graph_bytes"] >= est["factor_bytes"]


@pytest.mark.parametrize("cards,want", [([7, 7], "host"), ([7, 8], "none")],
                         ids=["one card", "two cards"])
def test_ranks_that_share_a_card_count_their_pools_together(cards, want):
    """Each rank's budget is the ranks' mean of an estimate plus its
    offloaded one: alone each fits, but two ranks on one card hold two
    pools and two shares of the factors there, so the grid offloads
    (offloaded, the two fit); on two cards it does not."""
    plan = _plan()[0]
    out = run_mesh_ranks(2, cases.shared_card_ranks, plan, "float32",
                         cards, timeout=240)
    for r in (0, 1):
        for name in GRID_EXECUTORS:
            choice, rec = out[r][name]
            assert choice == want and not rec["over"], (r, name)
            assert rec["card_ranks"] == 2 - (cards[0] != cards[1])


def test_ranks_of_a_cpu_grid_keep_the_factors():
    """None on a grid of CPU ranks: no budget, no offload, no
    collective."""
    plan = _plan()[0]
    out = run_mesh_ranks(2, cases.offload_rule_ranks, plan, "float32",
                         [None, None], [1, 1], timeout=240)
    for r in (0, 1):
        for name in GRID_EXECUTORS:
            choice, rec, _, _ = out[r][name]
            assert choice == "none" and rec["bytes"] is None


def test_ranks_refuse_together_where_a_card_cannot_hold_them():
    """A 1×2 gloo grid on two fake cards, rank 1's with no room: every
    grid executor is refused by name on both ranks (one all-reduce
    carries each rank's offloaded bytes), rank 0's card fitting or not.
    With room for rank 1's offloaded run, the executors that offload
    resolve "host", and mesh fused, which cannot, is refused on both."""
    plan = _plan()[0]
    names = ("spmd", "mesh-stream", "mesh-mega", "mesh-fused")
    out = run_mesh_ranks(2, cases.refused_rule_ranks, plan, "float32",
                         [10 ** 15, 0], [1, 2], timeout=240)
    for r in (0, 1):
        for name in names:
            kind, executor, budget, ranks, refused, offloads = out[r][name]
            assert kind == "refused" and executor == name, (r, name)
            assert refused == 1 and ranks == 1
            assert budget == (10 ** 15 if r == 0 else 0)
            assert offloads == (name != "mesh-fused")
    out = run_mesh_ranks(2, cases.refused_rule_ranks, plan, "float32",
                         [10 ** 15, "offloaded"], [1, 2], timeout=240)
    for r in (0, 1):
        for name in names[:3]:
            assert out[r][name] == ("built", name, "host"), (r, name)
        assert out[r]["mesh-fused"][:2] == ("refused", "mesh-fused")


EXECUTORS = {
    "stream": lambda plan, dt: StreamExecutor(plan, dt, "cpu"),
    "stream[level]": lambda plan, dt: StreamExecutor(plan, dt, "cpu",
                                                     granularity="level"),
    "fused": lambda plan, dt: FusedExecutor(plan, dt, "cpu"),
    "mega": lambda plan, dt: MegaExecutor(plan, dt, "cpu"),
}


def _uploads_fail(monkeypatch):
    """Anything uploaded from here fails the test: a refusal comes before
    the executor's maps, pools and graphs."""
    def upload(*args, **kw):
        raise AssertionError("the executor uploaded before the rule")
    monkeypatch.setattr(factor, "upload_maps", upload)
    monkeypatch.setattr(kernels, "upload", upload)


def _refused(monkeypatch, build):
    """``build()``'s DeviceMemoryError, with nothing uploaded and no
    census record made on the way."""
    mark = COMPILE_STATS.marker()
    with monkeypatch.context() as m:
        _uploads_fail(m)
        with pytest.raises(DeviceMemoryError) as refused:
            build()
    assert COMPILE_STATS.marker() == mark
    return refused.value


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("name", list(EXECUTORS))
def test_each_executor_fits_offloads_or_is_refused(monkeypatch, name,
                                                   dtype):
    """Every single-card executor under the card's rule: a budget of its
    estimate keeps the factors ("none"); one byte less offloads them
    ("host"), where the executor can — the fused graph cannot and is
    refused; one byte below its offloaded estimate refuses it by name,
    before it uploads anything, with its parts, budget and remedies."""
    plan = _plan()[0]
    est = EXECUTORS[name](plan, dtype).device_estimate()
    assert est["offload_bytes"] < est["bytes"]
    _built_as_on_the_card(monkeypatch)
    _fake_card(monkeypatch, _free_for(est["bytes"]))
    ex = EXECUTORS[name](plan, dtype)
    assert ex.offload == "none" and ex.report()["offload_rule"] == {
        "rule": "card", "bytes": est["bytes"], "limit": est["bytes"],
        "over": False, "offload_bytes": est["offload_bytes"]}
    _fake_card(monkeypatch, _free_for(est["bytes"] - 1))
    if name == "fused":
        err = _refused(monkeypatch, lambda: EXECUTORS[name](plan, dtype))
        assert not err.offloads and "cannot offload" in str(err)
    else:
        assert EXECUTORS[name](plan, dtype).offload == "host"
    _fake_card(monkeypatch, _free_for(est["offload_bytes"] - 1))
    err = _refused(monkeypatch, lambda: EXECUTORS[name](plan, dtype))
    assert (err.executor, err.dtype) == (name, str(dtype)[6:])
    assert err.budget == est["offload_bytes"] - 1
    assert {k: err.parts[k] for k in est} == est
    assert any("pool_partition" in r for r in err.remedies)
    assert (name == "stream") == (not any("executor='stream'" in r
                                          for r in err.remedies))
    assert f"{est['bytes']:,}" in str(err) and name in str(err)


def test_the_closed_plan_is_refused_where_the_unclosed_one_fits(
        monkeypatch):
    """A closed plan pads every group to its key's rung: on a card whose
    budget holds the unclosed plan's streamed factors, every executor of
    the closed plan of the same matrix is refused, even offloaded, and
    the error names the unclosed plan as a remedy."""
    a = gallery.poisson3d(10)
    open_plan = slt.analyze(slt.Options(), a, device="cpu")[0].plan
    closed = slt.analyze(slt.Options(bucket_closed=True), a,
                         device="cpu")[0].plan
    assert closed.closed and not open_plan.closed
    dt = torch.float64
    budget = offload_estimate(open_plan, dt)["bytes"]
    _built_as_on_the_card(monkeypatch)
    _fake_card(monkeypatch, _free_for(budget))
    assert StreamExecutor(open_plan, dt, "cpu").offload == "none"
    for name, build in EXECUTORS.items():
        err = _refused(monkeypatch, lambda: build(closed, dt))
        assert err.executor == name and err.parts["offload_bytes"] > budget
        assert any("bucket_closed=False" in r for r in err.remedies)


def test_the_streamed_loop_offloads_at_its_real_batches(monkeypatch):
    """The streamed loop runs each group at its real batch: offloaded, its
    estimate counts the working sets there, not at the pow-2 rungs its
    kept-factor estimate keeps, so float64 factors whose offloaded run
    fits at their real batches are offloaded, not refused."""
    plan = slt.analyze(slt.Options(bucket_closed=True), gallery.poisson3d(10),
                       device="cpu")[0].plan
    dt = torch.float64
    est = offload_estimate(plan, dt)
    real = max(stream.group_work_bytes(g, 8, g.batch) for g in plan.groups)
    assert est["offload_work_bytes"] == real < est["work_bytes"]
    rung = (est["pool_bytes"] + est["map_bytes"] + est["inflight_bytes"]
            + est["work_bytes"])
    assert est["offload_bytes"] < rung
    _fake_card(monkeypatch, _free_for(est["offload_bytes"]))
    assert offload_rule(plan, dt, CARD, None)[0] == "host"
    _fake_card(monkeypatch, _free_for(est["offload_bytes"] - 1))
    with pytest.raises(DeviceMemoryError):
        offload_rule(plan, dt, CARD, None)


def test_the_ladder_records_a_refused_hiprec_rung(monkeypatch):
    """float32 factors that fit, whose refinement stalls, and float64
    factors the card cannot hold even offloaded: the ladder's
    hiprec-factors rung is refused by the card's rule and recorded as a
    rung, the refactor-rescale rung (float64 again) fails and is
    recorded, and gssvx returns the float32 answer instead of raising."""
    a = gallery.rank_deficient_arrowhead(n=60, delta=1e-6, seed=0)
    b = a.matvec(np.random.default_rng(1).standard_normal(a.n_rows))
    plan = slt.analyze(slt.Options(), a, device="cpu")[0].plan
    fits = offload_estimate(plan, torch.float32)["bytes"]
    assert offload_estimate(plan, torch.float64)["offload_bytes"] > fits
    _built_as_on_the_card(monkeypatch)
    _fake_card(monkeypatch, _free_for(fits))
    x, lu, stats, info = slt.gssvx(
        slt.Options(factor_dtype="float32", executor="stream"), a, b,
        device="cpu")
    assert info == 0 and np.all(np.isfinite(x))
    rungs = {r.name: r.detail for r in stats.solve_report.rungs}
    assert rungs["hiprec-factors"] == "float64: DeviceMemoryError"
    assert "DeviceMemoryError" in rungs["refactor-rescale"]
    assert lu.numeric.dtype == torch.float32
    assert stats.solve_report.factor_dtype == "float32"


def test_concurrent_grids_each_get_their_own_rendezvous():
    """Four 2-rank gloo grids spawned at once, each joining its process
    group at its own ``rendezvous()`` (a FileStore's file, no TCP port
    chosen free beforehand): every rank of every grid joins its own
    group and all-reduces with its own peer only."""
    import concurrent.futures as cf
    assert len({rendezvous() for _ in range(64)}) == 64
    with cf.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(
            lambda k: run_mesh_ranks(2, cases.rank_sum, k, timeout=240),
            range(4)))
    for k, out in enumerate(outs):
        assert out == {0: (2, 2 * k + 1), 1: (2, 2 * k + 1)}


def _shifted(arrays, shift):
    """The maps' arrays with every child's pool offset moved by
    ``shift``."""
    out = [a.copy() for a in arrays]
    out[3][:, 0] += shift
    return out


def test_kernel_maps_above_two_to_the_31():
    """``front_map_arrays`` for every group of a small plan whose child
    offsets (and pool length) are shifted by 2**31 + 7, no such pool
    allocated: every offset is int64 and exact — the unshifted maps plus
    the shift — and every other array is the unshifted one, the dropped
    sentinels (offset == pool length) dropped alike; the same through
    ``build_front_maps``'s upload."""
    plan = _plan()[0]
    seen = 0
    for g in plan.groups:
        a = (g.a_slot, g.a_flat, g.a_src)
        kids = [(c.ub, c.child_off, c.child_slot, c.rel) for c in g.children]
        base, pairs = kernels.front_map_arrays(g.batch, g.m, plan.pool_size,
                                               a=a, children=kids)
        moved = [(ub, np.asarray(off, dtype=np.int64) + SHIFT, slot, rel)
                 for ub, off, slot, rel in kids]
        arrays, pairs2 = kernels.front_map_arrays(
            g.batch, g.m, plan.pool_size + SHIFT, a=a, children=moved)
        assert pairs2 == pairs
        assert arrays[3].dtype == np.int64
        want = _shifted(base, SHIFT)
        for got, ref in zip(arrays, want):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
        if len(arrays[3]):
            assert int(arrays[3][:, 0].min()) > 2 ** 31
            seen += 1
        fm = kernels.build_front_maps(g.batch, g.m, plan.pool_size + SHIFT,
                                      a=a, children=moved, device="cpu")
        assert fm.ch_rec.dtype == torch.int64
        assert np.array_equal(fm.ch_rec.numpy(), want[3])
        assert fm.pool_len == plan.pool_size + SHIFT
    assert seen > 0
