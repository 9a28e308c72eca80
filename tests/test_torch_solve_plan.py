"""The port's solve plan (superlu_dist_tpu_torch/solve/plan.py) and recursive
blocked TRSM (solve/device._trsm) against the JAX package's.

``build_solve_plan`` must give the JAX package's sweep batches array for
array under every schedule, window and alignment, on plans that both
packages analysed with their native libraries; the nrhs bucket set and its
chunking are equal too.  The blocked TRSM agrees with the unblocked one
and with the JAX ``_trsm`` to float64 tightness (the two order the GEMM
sums differently, so the gate is a tolerance, not bit equality)."""

import functools

import numpy as np
import pytest
import torch

from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.solve import plan as jplan
from superlu_dist_tpu.solve.device import _trsm as jax_trsm
from superlu_dist_tpu.utils.options import Options as JaxOptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.solve import plan as tplan
from superlu_dist_tpu_torch.solve.device import DeviceSolver, _trsm
from superlu_dist_tpu_torch.utils import tols

MATRICES = {
    "poisson2d_12": (lambda: jgal.poisson2d(12), lambda: gallery.poisson2d(12)),
    "poisson3d_8": (lambda: jgal.poisson3d(8), lambda: gallery.poisson3d(8)),
    "convdiff_20": (lambda: jgal.convection_diffusion_2d(20),
                    lambda: gallery.convection_diffusion_2d(20)),
    "random_300": (lambda: jgal.random_sparse(300, density=0.02, seed=4),
                   lambda: gallery.random_sparse(300, density=0.02, seed=4)),
}
GROUP_ARRAYS = ("sns", "ws", "src_group", "src_slot")
GROUP_INTS = ("level", "m", "w", "u", "batch", "reuse")


@functools.lru_cache(maxsize=None)
def _plans(name):
    """The JAX package's and the port's default plans of one matrix, both
    analysed with the native libraries."""
    make_jax, make_port = MATRICES[name]
    jlu, _, _ = jax_analyze(JaxOptions(), make_jax())
    lu, _, _ = slt.analyze(slt.Options(), make_port(), device="cpu")
    return jlu.plan, lu.plan


@functools.lru_cache(maxsize=None)
def _factored(name="poisson3d_8", **kw):
    """A port handle of one matrix, factored and solved on the CPU."""
    a = MATRICES[name][1]()
    _, lu, _, info = slt.gssvx(slt.Options(
        iter_refine=slt.IterRefine.NOREFINE, **kw), a, np.ones(a.n_rows),
        device="cpu")
    assert info == 0
    return lu


@pytest.mark.parametrize("align", [1.0, 1.25])
@pytest.mark.parametrize("window", [0, 1])
@pytest.mark.parametrize("schedule", ["dataflow", "level", "factor"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_build_solve_plan_matches_jax(name, schedule, window, align):
    jax_fp, port_fp = _plans(name)
    want = jplan.build_solve_plan(jax_fp, schedule=schedule, window=window,
                                  align=align, nrhs_max=1024, nrhs_growth=1.5)
    got = tplan.build_solve_plan(port_fp, schedule=schedule, window=window,
                                 align=align)
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        for f in GROUP_INTS:
            assert getattr(g, f) == getattr(w, f), f
        for f in GROUP_ARRAYS:
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
    for f in ("critical_path", "flops_per_rhs", "executed_flops_per_rhs",
              "nrhs_bucket_set", "n_factor_groups", "schedule", "window",
              "align"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.schedule_stats(130) == want.schedule_stats(130)


@pytest.mark.parametrize("cap,growth", [(1024, 1.5), (4, 1.5), (32, 2.0),
                                        (1000, 1.3), (1, 1.5)])
def test_nrhs_buckets_and_chunks_match_jax(cap, growth):
    bs = tplan.nrhs_buckets(cap, growth)
    assert bs == jplan.nrhs_buckets(cap, growth)
    for k in (1, 3, 64, 65, 97, 1024, 2500):
        assert tplan.chunk_nrhs(k, bs) == jplan.chunk_nrhs(k, bs)


def test_nrhs_buckets_bounded_and_exact_small():
    bs = tplan.nrhs_buckets(1024, 1.5)
    assert bs[0] == 1 and bs[-1] == 1024 and list(bs) == sorted(set(bs))
    for k in (1, 2, 4, 8, 16, 32, 64):
        assert tplan.bucket_nrhs(k, bs) == k
    assert len(bs) <= 16
    assert all(b % 32 == 0 for b in bs if b > 64)
    assert tplan.bucket_nrhs(65, bs) == 96
    with pytest.raises(ValueError):
        tplan.bucket_nrhs(1025, bs)
    chunks = tplan.chunk_nrhs(2500, bs)
    assert chunks[0] == (0, 1024, 1024) and chunks[1] == (1024, 2048, 1024)
    assert all(c1[1] == c2[0] for c1, c2 in zip(chunks, chunks[1:]))
    assert tplan.chunk_nrhs(11, (1, 2, 4)) == [(0, 4, 4), (4, 8, 4),
                                               (8, 11, 4)]


def test_solve_plan_topological_and_bounded():
    plan = _factored().plan
    sp = tplan.build_solve_plan(plan)
    sf = plan.sf
    pos = np.empty(sf.n_supernodes, dtype=np.int64)
    for i, g in enumerate(sp.groups):
        pos[g.sns] = i
    for s in range(sf.n_supernodes):
        p = int(sf.sn_parent[s])
        if p >= 0:
            assert pos[s] < pos[p], (s, p)
    assert len(sp.groups) <= sp.n_factor_groups
    assert sp.mean_occupancy >= plan.mean_occupancy - 1e-9
    assert sp.critical_path <= len(sp.groups)


def test_window_one_equals_level_partition():
    plan = _factored("poisson2d_12").plan
    sp1 = tplan.build_solve_plan(plan, schedule="dataflow", window=1)
    spl = tplan.build_solve_plan(plan, schedule="level")
    assert [g.sns.tolist() for g in sp1.groups] == \
        [g.sns.tolist() for g in spl.groups]
    assert [(g.w, g.u) for g in sp1.groups] == [(g.w, g.u) for g in spl.groups]


def test_factor_schedule_aliases_every_group():
    plan = _factored().plan
    sp = tplan.build_solve_plan(plan, schedule="factor")
    assert len(sp.groups) == len(plan.groups)
    for i, (g, fg) in enumerate(zip(sp.groups, plan.groups)):
        assert g.reuse == i and np.array_equal(g.sns, fg.sns)
        assert (g.w, g.u, g.m) == (fg.w, fg.u, fg.m)


def test_same_machinery_same_inputs_reproduces_factor_batches():
    """The solve scheduler run with the factor scheduler's own window and
    no alignment gives the factor groups: every batch aliases."""
    plan = _factored().plan
    sp = tplan.build_solve_plan(plan, schedule=plan.schedule,
                                window=plan.sched_window, align=1.0)
    assert all(g.reuse >= 0 for g in sp.groups)
    assert len(sp.groups) == len(plan.groups)


def test_schedule_stats_fields_and_padding_honesty():
    sp = tplan.build_solve_plan(_factored("random_300").plan)
    st = sp.schedule_stats(nrhs=130)
    for key in ("schedule", "n_groups", "n_factor_groups", "occupancy",
                "critical_path", "nrhs_buckets", "shape_padding",
                "reused_groups", "nrhs", "padded_nrhs", "padding_factor"):
        assert key in st, key
    assert st["shape_padding"] >= 1.0
    assert st["padding_factor"] >= st["shape_padding"] - 1e-9
    kb = sum(b for _, _, b in tplan.chunk_nrhs(130, sp.nrhs_bucket_set))
    assert st["padded_nrhs"] == kb
    assert sp.executed_flops(130) == sp.executed_flops_per_rhs * kb
    assert sp.solve_flops(130) == sp.flops_per_rhs * 130


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        tplan.build_solve_plan(_factored().plan, schedule="bogus")


def test_driver_threads_solve_options():
    lu = _factored("convdiff_20", solve_schedule="level", solve_window=0,
                   solve_align=1.0, diag_inv=True)
    s = lu.dev_solver
    assert s.splan.schedule == "level" and s.splan.align == 1.0
    assert s.diag_inv and s.gemm_prec == lu.numeric.gemm_prec == "default"
    assert _factored().dev_solver.splan.schedule == "dataflow"


def test_promoted_keys_pad_benignly():
    """A large alignment tolerance merges shape keys, so some sweep batches
    gather identity/zero-padded panel stacks: the solution must not move."""
    lu = _factored("random_300")
    sp = tplan.build_solve_plan(lu.plan, schedule="dataflow", window=0,
                                align=4.0)
    assert any(g.reuse < 0 for g in sp.groups)
    assert any((g.w, g.u) != (lu.plan.groups[g.src_group[0]].w,
                              lu.plan.groups[g.src_group[0]].u)
               for g in sp.groups)
    d = np.random.default_rng(11).standard_normal((lu.n, 3))
    ref = DeviceSolver(lu.numeric, schedule="factor")
    padded = DeviceSolver(lu.numeric, solve_plan=sp)
    for got, want in ((padded.solve(d), ref.solve(d)),
                      (padded.solve_trans(d), ref.solve_trans(d))):
        np.testing.assert_allclose(got, want, rtol=tols.DEVICE_VS_HOST_RTOL,
                                   atol=tols.DEVICE_VS_HOST_ATOL)


@pytest.mark.parametrize("lower,unit,trans", [
    (True, True, 0), (False, False, 0), (True, True, 1), (False, False, 1),
])
def test_blocked_trsm_matches_unblocked_and_jax(lower, unit, trans):
    rng = np.random.default_rng(3)
    w, b, k = 37, 4, 5          # odd width: uneven splits
    a = rng.standard_normal((b, w, w))
    tri = (np.tril(a) if lower else np.triu(a)) + np.eye(w) * w
    rhs = rng.standard_normal((b, w, k))
    ta, tb = torch.from_numpy(tri), torch.from_numpy(rhs)
    want = _trsm(ta, tb, lower, unit, trans, leaf=0).numpy()
    got = _trsm(ta, tb, lower, unit, trans, leaf=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)
    ref = np.asarray(jax_trsm(tri, rhs, lower, unit, trans, leaf=8))
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-13)


def test_blocked_trsm_leaf_changes_nothing_numerically():
    """Wide supernodes force w past the leaf: a solver with deep TRSM
    recursion agrees with the unblocked one to float64 tightness."""
    lu = _factored()
    assert max(g.w for g in lu.dev_solver.splan.groups) > 8
    d = np.random.default_rng(13).standard_normal((lu.n, 2))
    want = DeviceSolver(lu.numeric, trsm_leaf=0).solve(d)
    for leaf in (8, 64):
        got = DeviceSolver(lu.numeric, trsm_leaf=leaf).solve(d)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)
