"""The port's executor choice (numeric/factor.get_executor) on the CPU,
held against the JAX package on the same plans.

* The port's ``stream``, ``fused`` and ``mega`` executors against the JAX
  package's ``StreamExecutor``, ``make_factor_fn`` and ``MegaExecutor``
  (its Pallas kernels through the ``.at[]`` lowering, as its own CPU tests
  run them) on one plan: every front within SCHEDULE_DRIFT_RTOL/ATOL, the
  same tiny-pivot count; the port's three bit for bit among themselves.
* ``offload="host"``: CPU fronts, ``on_host``, and the port's host
  ``lu_solve`` / ``lu_solve_trans`` equal to the JAX package's on the same
  fronts (the same float64 arithmetic: bit for bit).
* The host-share split and level granularity bit for bit the port's
  stream, on the plan of the JAX package's tests/test_parallel.py:196,247.
* ``Options(executor=...)`` through gssvx and refactor; checkpoints, the
  deadline and resume turn auto and fused into stream; a mega checkpoint
  resumes under stream and the other way round.

Inputs are the gallery's, made with numpy from seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.drivers.gssvx import gssvx as jax_gssvx
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import make_factor_fn
from superlu_dist_tpu.numeric.factor import (
    numeric_factorize as jax_numeric_factorize)
from superlu_dist_tpu.numeric.mega import MegaExecutor as JaxMega
from superlu_dist_tpu.numeric.plan import build_plan as jax_build_plan
from superlu_dist_tpu.numeric.stream import StreamExecutor as JaxStream
from superlu_dist_tpu.ordering.dispatch import get_perm_c as jax_get_perm_c
from superlu_dist_tpu.solve.trisolve import lu_solve as jax_lu_solve
from superlu_dist_tpu.solve.trisolve import (
    lu_solve_trans as jax_lu_solve_trans)
from superlu_dist_tpu.sparse.formats import (
    symmetrize_pattern as jax_symmetrize)
from superlu_dist_tpu.symbolic.symbfact import (
    symbolic_factorize as jax_symbolic)
from superlu_dist_tpu.utils.options import Options as JaxOptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import (factors_from_reference,
                                           plan_from_reference)
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.numeric.factor import (NumericFactorization,
                                                   get_executor)
from superlu_dist_tpu_torch.numeric.plan import bucket_rung
from superlu_dist_tpu_torch.numeric.stream import (StreamExecutor,
                                                   padded_front_bytes)
from superlu_dist_tpu_torch.persist.serial import load_lu, save_lu
from superlu_dist_tpu_torch.solve.trisolve import lu_solve, lu_solve_trans
from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.deadline import Deadline
from superlu_dist_tpu_torch.utils.errors import DeadlineExceededError

#: port vs JAX package: the cross-schedule drift gate (two frameworks'
#: BLAS); the port's executors among themselves: bit for bit
RTOL, ATOL = tols.SCHEDULE_DRIFT_RTOL, tols.SCHEDULE_DRIFT_ATOL
CPU = torch.device("cpu")

MATRICES = {"poisson2d_16": lambda g: g.poisson2d(16),
            "poisson3d_8": lambda g: g.poisson3d(8)}


class Countdown(Deadline):
    """Expires just before group n (the (n+1)-th poll)."""

    def __init__(self, n):
        super().__init__(0.0)
        self.n = n

    def expired_local(self):
        return self.polls > self.n


def _jax_plan(name, closed=False):
    """The JAX analysis of one gallery matrix, its plan rebuilt with
    ``closed``: (JAX plan, port plan, values, anorm)."""
    lu, bvals, _ = jax_analyze(JaxOptions(), MATRICES[name](jgal))
    plan = jax_build_plan(lu.plan.sf, closed=closed) if closed else lu.plan
    return plan, plan_from_reference(plan), np.asarray(bvals), lu.anorm


def _thresh(anorm, dtype=np.float64):
    return np.sqrt(np.finfo(dtype).eps) * max(anorm, 1e-300)


def _port(plan, vals, anorm, executor, dtype=torch.float64, **kw):
    return factor.numeric_factorize(plan, vals, anorm, dtype=dtype,
                                    device="cpu", executor=executor, **kw)


def _assert_bitwise(f1, f2):
    assert len(f1) == len(f2)
    for (l1, u1), (l2, u2) in zip(f1, f2):
        assert torch.equal(l1, l2) and torch.equal(u1, u2)


def _assert_close_to_jax(fronts, jfronts):
    assert len(fronts) == len(jfronts)
    for (lp, up), (jl, ju) in zip(fronts, jfronts):
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(up.numpy(), np.asarray(ju), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the three executors against the JAX package's, and among themselves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("closed", [False, True], ids=["plan", "closed"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_executors_match_the_jax_executors(name, closed):
    jplan, plan, vals, anorm = _jax_plan(name, closed)
    th = jnp.asarray(_thresh(anorm))
    av = jnp.asarray(vals)
    want = {"stream": JaxStream(jplan, "float64")(av, th),
            "fused": make_factor_fn(jplan, "float64")(av, th),
            "mega": JaxMega(jplan, "float64")(av, th)}
    got = {ex: _port(plan, vals, anorm, ex) for ex in want}
    for ex, (jfronts, jtiny) in want.items():
        _assert_close_to_jax(got[ex].fronts, jfronts)
        assert got[ex].tiny_pivots == int(jtiny)
        assert got[ex].executor["executor"] == ex
    _assert_bitwise(got["fused"].fronts, got["stream"].fronts)
    _assert_bitwise(got["mega"].fronts, got["stream"].fronts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_mega_equals_stream_bitwise_on_a_closed_plan(dtype):
    """Padded batch slots (identity fronts), the dump region and the
    rung-padded stores change no bit of the real fronts."""
    _, plan, vals, anorm = _jax_plan("poisson2d_16", closed=True)
    if dtype.is_complex:
        vals = vals.astype(np.complex128) * (1 + 0.25j)
    s = _port(plan, vals, anorm, "stream", dtype=dtype)
    m = _port(plan, vals, anorm, "mega", dtype=dtype)
    _assert_bitwise(m.fronts, s.fronts)
    assert m.tiny_pivots == s.tiny_pivots
    ex = get_executor(plan, dtype, "mega", device="cpu")
    assert ex.n_graphs == len(plan.bucket_set) == len(ex.spec)
    assert all(b & (b - 1) == 0 for b in ex.spec.values())


def test_auto_rule_and_the_executor_cache():
    _, plan, _, _ = _jax_plan("poisson3d_8")
    auto = get_executor(plan, torch.float64, "auto", device="cpu")
    assert auto.name == "fused"          # the JAX rule: fused on the CPU
    assert get_executor(plan, torch.float64, "fused", device="cpu") is auto
    s = get_executor(plan, torch.float64, "stream", device="cpu")
    assert s.name == "stream" and s is not auto
    assert get_executor(plan, torch.float64, "stream", device="cpu",
                        host_flops=1e9) is not s
    assert get_executor(plan, torch.float64, "stream", "f32",
                        device="cpu") is not s
    # spmd without a grid of several ranks: the stream (the JAX rule)
    assert get_executor(plan, torch.float64, "spmd", device="cpu") is s
    with pytest.raises(ValueError):
        get_executor(plan, torch.float64, "bogus", device="cpu")
    with pytest.raises(RuntimeError):
        if not torch.cuda.is_available():
            get_executor(plan, torch.float64, "auto")   # the card: raises
        else:
            raise RuntimeError("a card is present")


def test_the_cache_keeps_one_graph_executor_per_device():
    """A new fused or mega executor drops the plan's earlier one on the
    same device (on the card their captured graphs hold gigabytes); the
    stream executors stay cached, and the dropped executor's factors stay
    valid."""
    jplan, plan, vals, anorm = _jax_plan("poisson3d_8", closed=True)
    s = get_executor(plan, torch.float64, "stream", device="cpu")
    first = _port(plan, vals, anorm, "fused")
    f = get_executor(plan, torch.float64, "fused", device="cpu")
    f32 = get_executor(plan, torch.float64, "fused", "f32", device="cpu")
    assert f32 is not f
    m = get_executor(plan, torch.float32, "mega", device="cpu")
    kept = list(plan.__dict__["_factor_fns"].values())
    assert s in kept and m in kept and f not in kept and f32 not in kept
    assert get_executor(plan, torch.float64, "stream", device="cpu") is s
    assert get_executor(plan, torch.float32, "mega", device="cpu") is m
    _assert_bitwise(first.fronts, _port(plan, vals, anorm, "stream").fronts)


def test_fused_is_the_level_executor_with_one_wave():
    """fused shares the level waves' code: one wave of every group, no
    offload and no host share, whatever the stream knobs say."""
    _, plan, _, _ = _jax_plan("poisson3d_8")
    f = get_executor(plan, torch.float64, "fused", device="cpu",
                     host_flops=1e12, front_bytes_limit=0)
    assert isinstance(f, StreamExecutor) and f.granularity == "level"
    assert f.waves() == [(0, len(plan.groups))]
    rep = f.report()
    assert (rep["executor"], rep["offload"], rep["host_levels"]) == (
        "fused", "none", 0)


def test_write_back_slots_match_the_mask():
    """upload_maps finds the written-back slots on the host, so the
    write-back needs no mask on the device."""
    _, plan, _, _ = _jax_plan("poisson3d_8")
    for g, gm in zip(plan.groups, factor.upload_maps(plan, CPU)):
        want = np.flatnonzero(np.asarray(g.off) < plan.pool_size)
        if gm.keep is None:
            assert len(want) == g.batch
        else:
            assert np.array_equal(gm.keep.numpy(), want)


# ---------------------------------------------------------------------------
# host offload and the host triangular solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_offload_puts_the_fronts_on_the_host(name):
    _, plan, vals, anorm = _jax_plan(name)
    ref = _port(plan, vals, anorm, "stream")
    ex = StreamExecutor(plan, torch.float64, "cpu", offload="host",
                        offload_lag=2)
    fronts, tiny = ex(torch.as_tensor(vals), torch.tensor(_thresh(anorm)))
    assert ex.offload == "host" and tiny == ref.tiny_pivots
    assert all(lp.device.type == "cpu" for lp, _ in fronts)
    _assert_bitwise(fronts, ref.fronts)
    # one arena for the whole plan: every front is a view of it
    base = fronts[0][0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for pair in fronts for t in pair)
    num = NumericFactorization(plan=plan, fronts=fronts, tiny_pivots=tiny,
                               dtype=torch.float64, offload="host")
    assert num.on_host and not ref.on_host
    assert all(isinstance(x, np.ndarray) for p in num.pull_to_host()
               for x in p)


def test_auto_offload_follows_the_front_bytes_limit():
    _, plan, _, _ = _jax_plan("poisson3d_8")
    nbytes = padded_front_bytes(plan, torch.float32)
    assert nbytes > 0
    # "auto" offloads on the card only: on the CPU it stays "none"
    assert StreamExecutor(plan, torch.float32, "cpu",
                          front_bytes_limit=0).offload == "none"
    with pytest.raises(ValueError):
        StreamExecutor(plan, torch.float32, "cpu", offload="disk")


@pytest.mark.parametrize("name,dtype", [("poisson3d_8", "float64"),
                                        ("poisson2d_16", "float32"),
                                        ("poisson2d_16", "complex128")])
def test_host_solves_equal_the_jax_host_solves(name, dtype):
    """lu_solve / lu_solve_trans (and its conjugate) on the same fronts:
    the JAX package's factors, moved into the port as host factors."""
    jplan, _, vals, anorm = _jax_plan(name)
    if dtype == "complex128":
        vals = vals.astype(np.complex128) * (1 + 0.25j)
    jnum = jax_numeric_factorize(jplan, vals, anorm, dtype=dtype)
    num = factors_from_reference(jnum, device="cpu")
    num = dataclasses.replace(num, offload="host")
    assert num.on_host
    rng = np.random.default_rng(7)
    for rhs in (rng.standard_normal(jplan.n),
                rng.standard_normal((jplan.n, 3))):
        if dtype == "complex128":
            rhs = rhs + 1j * rng.standard_normal(rhs.shape)
        assert np.array_equal(lu_solve(num, rhs), jax_lu_solve(jnum, rhs))
        for conj in (False, True):
            assert np.array_equal(lu_solve_trans(num, rhs, conj=conj),
                                  jax_lu_solve_trans(jnum, rhs, conj=conj))


def test_offloaded_factors_solve_on_the_host_through_gssvx():
    """A handle whose factors lie in host memory solves and refines on
    the host, TRANS too, to the delivered-BERR gate; the report says so."""
    a = gallery.poisson3d(8)
    b = a.matvec(np.random.default_rng(3).standard_normal(a.n_rows))
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    ex = StreamExecutor(lu.plan, torch.float64, "cpu", offload="host")
    _, bv, _ = slt.analyze(slt.Options(fact=slt.Fact.SamePattern_SameRowPerm),
                           a, device="cpu", lu=lu)
    fronts, tiny = ex(torch.as_tensor(bv), torch.tensor(_thresh(lu.anorm)))
    lu.numeric = NumericFactorization(plan=lu.plan, fronts=fronts,
                                      tiny_pivots=tiny, dtype=torch.float64,
                                      offload="host")
    lu.dev_solver = None
    for trans in (slt.Trans.NOTRANS, slt.Trans.TRANS):
        x, _, st, info = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED,
                                               trans=trans), a, b, lu=lu)
        rep = st.solve_report
        assert info == 0 and rep.solve_route == "host"
        assert rep.residual_route == "host"
        assert rep.berr <= tols.berr_target(np.float64)
    assert lu.dev_solver is None         # no device solver was built
    assert "solve on host" in st.solve_report.summary()


def test_offload_resume_keeps_the_fronts_on_the_host(tmp_path):
    _, plan, vals, anorm = _jax_plan("poisson3d_8")
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceededError):
        _port(plan, vals, anorm, "stream", ckpt_dir=ck, ckpt_every=1,
              deadline=Countdown(3))
    ref = _port(plan, vals, anorm, "stream")
    from superlu_dist_tpu_torch.persist.checkpoint import load_checkpoint
    ex = StreamExecutor(plan, torch.float64, "cpu", offload="host")
    ex.resume = load_checkpoint(ck)
    fronts, tiny = ex(torch.as_tensor(vals), torch.tensor(_thresh(anorm)))
    assert tiny == ref.tiny_pivots
    assert all(lp.device.type == "cpu" for lp, _ in fronts)
    _assert_bitwise(fronts, ref.fronts)


def test_save_lu_of_host_resident_factors(tmp_path):
    a = gallery.poisson2d(12)
    b = a.matvec(np.ones(a.n_rows))
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    ex = StreamExecutor(lu.plan, torch.float64, "cpu", offload="host")
    _, bv, _ = slt.analyze(slt.Options(fact=slt.Fact.SamePattern_SameRowPerm),
                           a, device="cpu", lu=lu)
    fronts, tiny = ex(torch.as_tensor(bv), torch.tensor(_thresh(lu.anorm)))
    host = NumericFactorization(plan=lu.plan, fronts=fronts,
                                tiny_pivots=tiny, dtype=torch.float64,
                                offload="host")
    _assert_bitwise(host.fronts, lu.numeric.fronts)
    lu.numeric = host
    save_lu(lu, str(tmp_path / "b"))
    back = load_lu(str(tmp_path / "b"), device="cpu")
    _assert_bitwise(back.numeric.fronts, host.fronts)


# ---------------------------------------------------------------------------
# the host-share split and level waves
# ---------------------------------------------------------------------------

def _fine_plan():
    """The plan of the JAX package's host-share test
    (tests/test_parallel.py:247): poisson2d(16) with fine supernodes."""
    a = jgal.poisson2d(16)
    sym = jax_symmetrize(a)
    sf = jax_symbolic(sym, jax_get_perm_c(JaxOptions(), a, sym), relax=4,
                      max_supernode=16, amalg_tol=0.0)
    jplan = jax_build_plan(sf)
    return jplan, plan_from_reference(jplan), sym.data[sf.value_perm], \
        a.norm_max()


@pytest.mark.parametrize("offload", ["none", "host"])
@pytest.mark.parametrize("granularity", ["group", "level"])
def test_host_share_and_level_waves_equal_the_stream(granularity, offload):
    jplan, plan, vals, anorm = _fine_plan()
    ref = StreamExecutor(plan, torch.float64, "cpu")
    av, th = torch.as_tensor(vals), torch.tensor(_thresh(anorm))
    rfronts, rtiny = ref(av, th)
    # the JAX test's threshold: above the leaf level's cost, below the
    # costliest level's, so the split engages and leaves device levels
    cut = max(bucket_rung(g.batch, lo=1, growth=2.0) * _front_flops(g.w, g.u)
              for g in plan.groups)
    ex = StreamExecutor(plan, torch.float64, "cpu", granularity=granularity,
                        host_flops=cut, offload=offload)
    jex = JaxStream(jplan, "float64", host_flops=cut)
    assert 0 < ex.host_levels == jex.host_levels
    assert ex.host_levels < len({g.level for g in plan.groups})
    fronts, tiny = ex(av, th)
    assert tiny == rtiny
    _assert_bitwise(fronts, rfronts)
    assert ex.report()["host_groups"] == jex._n_host_groups


def test_level_waves_are_the_schedule_waves():
    _, plan, vals, anorm = _jax_plan("poisson3d_8")
    ex = StreamExecutor(plan, torch.float64, "cpu", granularity="level")
    waves = ex.waves()
    assert waves[0][0] == 0 and waves[-1][1] == len(plan.groups)
    for (lo, hi), (lo2, _) in zip(waves, waves[1:]):
        assert hi == lo2
    for lo, hi in waves:
        assert len({plan.groups[i].level for i in range(lo, hi)}) == 1
    with pytest.raises(ValueError):
        StreamExecutor(plan, torch.float64, "cpu", granularity="panel")


# ---------------------------------------------------------------------------
# the driver: Options.executor, refactor, the forcing rule, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["auto", "stream", "fused", "mega"])
def test_gssvx_and_refactor_take_the_executor(executor):
    """gssvx and refactor run the executor Options names (mega on a
    closed plan, Options.bucket_closed as the JAX driver's), with x within
    DEVICE_VS_HOST of the JAX package's gssvx on the same options."""
    closed = executor == "mega"
    rng = np.random.default_rng(11)
    a = gallery.poisson2d(16)
    b = a.matvec(rng.standard_normal(a.n_rows))
    opts = slt.Options(executor=executor, bucket_closed=closed,
                       bucket_keys=4)
    x, lu, st, info = slt.gssvx(opts, a, b, device="cpu")
    jx, jlu, _, jinfo = jax_gssvx(JaxOptions(executor=executor,
                                             bucket_closed=closed),
                                  jgal.poisson2d(16), b)
    assert info == jinfo == 0
    assert lu.plan.closed == closed
    if closed:
        assert len(lu.plan.bucket_set) <= 4
    np.testing.assert_allclose(x, jx, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    want = "fused" if executor == "auto" else executor
    assert st.executor["executor"] == want
    assert lu.numeric.executor["executor"] == want
    assert f"executor {want}" in st.report()
    st2 = slt.refactor(lu, a.data * (1.0 + 0.01 * rng.uniform(-1, 1, a.nnz)))
    assert st2.executor["executor"] == want
    x2, _, st3, _ = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, b,
                              lu=lu)
    assert st3.solve_report.berr <= tols.berr_target(np.float64)


def test_options_validate_the_executor():
    with pytest.raises(ValueError):
        slt.Options(executor="bogus")
    assert slt.Options(executor="spmd").executor == "spmd"
    o = slt.Options()
    assert (o.executor, o.bucket_closed, o.bucket_keys, o.front_bytes_limit,
            o.offload_lag, o.host_flops) == ("auto", False, 6, None, 8, 0.0)


@pytest.mark.parametrize("arm", ["ckpt_dir", "ckpt_every", "deadline",
                                 "resume_from"])
@pytest.mark.parametrize("executor", ["auto", "fused"])
def test_crash_consistency_forces_the_stream(tmp_path, arm, executor):
    _, plan, vals, anorm = _jax_plan("poisson3d_8")
    ck = str(tmp_path / "ck")
    kw = {"ckpt_dir": dict(ckpt_dir=ck), "ckpt_every": dict(ckpt_every=100),
          "deadline": dict(deadline=Deadline(3600.0)),
          "resume_from": dict(resume_from=ck)}[arm]
    if arm == "resume_from":
        with pytest.raises(DeadlineExceededError):
            _port(plan, vals, anorm, "stream", ckpt_dir=ck,
                  deadline=Countdown(2))
    num = _port(plan, vals, anorm, executor, **kw)
    assert num.executor["executor"] == "stream"
    _assert_bitwise(num.fronts, _port(plan, vals, anorm, "fused").fronts)


@pytest.mark.parametrize("first,then", [("mega", "stream"),
                                        ("stream", "mega"),
                                        ("mega", "mega")])
def test_a_checkpoint_resumes_under_the_other_executor(tmp_path, first, then):
    """Frontiers store the pool without mega's padding (JAX
    tests/test_megakernel.py:277): resumed factors bit for bit an
    uninterrupted run's."""
    _, plan, vals, anorm = _jax_plan("poisson2d_16", closed=True)
    ref = _port(plan, vals, anorm, "stream")
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceededError):
        _port(plan, vals, anorm, first, ckpt_dir=ck, ckpt_every=1,
              deadline=Countdown(3))
    res = _port(plan, vals, anorm, then, resume_from=ck)
    assert res.resumed_groups == 3
    assert res.executor["executor"] == then
    assert res.tiny_pivots == ref.tiny_pivots
    _assert_bitwise(res.fronts, ref.fronts)


def test_the_plan_pickles_without_its_executors():
    _, plan, vals, anorm = _jax_plan("poisson3d_8")
    _port(plan, vals, anorm, "fused")
    assert plan.__dict__.get("_factor_fns")
    state = plan.__getstate__()
    assert "_factor_fns" not in state and "_device_maps" not in state


@pytest.mark.parametrize("executor", ["stream", "fused", "mega", "level"])
def test_dropping_the_plan_frees_its_executors_without_a_collection(
        executor):
    """The plan owns its executors and they hold it weakly (plan.PlanRef):
    no reference cycle, so the executors (on the card, their pools and
    graphs) go with the plan's last reference, and no cyclic collection
    is needed to free them."""
    import gc
    import weakref
    _, plan, vals, anorm = _jax_plan("poisson3d_8")
    was = gc.isenabled()
    gc.disable()
    try:
        if executor == "level":
            ex = StreamExecutor(plan, torch.float64, "cpu",
                                granularity="level")
            ex(torch.as_tensor(vals), torch.tensor(1e-300))
            plan.__dict__.setdefault("_factor_fns", {})["level"] = ex
            del ex
        else:
            _port(plan, vals, anorm, executor)
        (ex,) = factor.cached_executors(plan)
        refs = (weakref.ref(plan), weakref.ref(ex))
        del ex
        assert refs[1]() is not None       # the plan keeps it
        del plan
        assert [r() for r in refs] == [None, None]
    finally:
        if was:
            gc.enable()


def test_an_executor_that_outlives_its_plan_says_so():
    _, plan, vals, anorm = _jax_plan("poisson3d_8")
    ex = StreamExecutor(plan, torch.float64, "cpu")
    del plan
    with pytest.raises(ReferenceError, match="outlived its plan"):
        ex(torch.as_tensor(vals), torch.tensor(1e-300))
