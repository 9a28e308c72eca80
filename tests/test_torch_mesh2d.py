"""The 2-D mesh tier (superlu_dist_tpu_torch/parallel/mesh_stream.py,
layout2d.py): the "panel" axis and ``pool_partition`` on gloo CPU ranks,
each scenario on spawned ranks (``testing.ranks.run_mesh_ranks``,
functions in tests/torch_mesh_cases.py) with SLU_TPU_VERIFY_COLLECTIVES
on, held against the port's stream and the JAX package in this process:

* the layout: every column of every front has one owner in its process
  row, every Schur element one receiver under ``pool_partition``;
* the plain twin's column-share assembly against the whole-front plain
  assembly sliced to the share, bit for bit, in all four dtypes;
* the 2-D executor at 1×2, 2×1 and 2×2 against the port's stream
  executor: the partitioned and replicated pools bit for bit equal, the
  fronts bit for bit the stream's (at npcol = 1 by construction; at
  npcol > 1 torch's CPU TRSM and GEMM give a column block the bits of
  the whole), the tiny counts equal; the 2-D SpmdSolver at NOTRANS,
  TRANS and CONJ within DEVICE_VS_HOST of DeviceSolver;
* against the JAX ``StreamExecutor(mesh=gridinit(4, 2).mesh,
  pool_partition=True)`` on tests/test_parallel.py's plan: fronts at
  SCHEDULE_DRIFT (the port writes the multipliers as computed);
* (the drivers on the 2-D grid: tests/test_torch_mesh2d_drivers.py)
* the grid's row and exchange collectives, their lockstep verification,
  ``Options.pool_partition`` / ``SLU_TPU_POOL_PARTITION`` and the
  executor routing of ``resolve_executor``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit
from superlu_dist_tpu.utils import options as joptions

import torch_mesh_cases as cases
import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.models import gallery as tgal
from superlu_dist_tpu_torch.numeric import factor, kernels
from superlu_dist_tpu_torch.parallel import layout2d
from superlu_dist_tpu_torch.parallel.mesh_stream import share_maps
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import options, tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
GRIDS = [(1, 2), (2, 1), (2, 2)]

_GALLERY = [("poisson", lambda g: g.poisson2d(16), "float64"),
            ("arrowhead", lambda g: g.rank_deficient_arrowhead(40),
             "float64"),
            ("convdiff", lambda g: g.convection_diffusion_2d(14), "float32"),
            ("helmholtz", lambda g: g.helmholtz_2d(10), "complex128")]
NAMES = [name for name, _, _ in _GALLERY]
_CASES = {}


def _case(name):
    """The port's analysis of a gallery matrix: (plan, values, ‖A‖)."""
    if name not in _CASES:
        make, dt = {n: (m, d) for n, m, d in _GALLERY}[name]
        lu, bvals, _ = slt.analyze(slt.Options(), make(tgal), device="cpu")
        _CASES[name] = (lu.plan, bvals, lu.anorm, dt)
    return _CASES[name]


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", GRIDS + [(1, 3)])
def test_every_column_has_one_owner_in_its_row(shape):
    nprow, npcol = shape
    plan = _case("poisson")[0]
    for g in plan.groups:
        parts = [layout2d.front_cols(g.m, g.w, npcol, c)
                 for c in range(npcol)]
        m_ext = parts[0][1]
        cols = np.concatenate([p[2] for p in parts])
        np.testing.assert_array_equal(np.sort(cols), np.arange(m_ext))
        # each panel of the blocked LU lies whole on one process column
        pb = parts[0][0]
        owner = layout2d.col_owner(m_ext, g.w, npcol)
        for j0 in range(0, g.w, pb):
            assert len(set(owner[j0:j0 + pb])) == 1


@pytest.mark.parametrize("shape", GRIDS + [(1, 3)])
def test_every_schur_element_has_one_receiver(shape):
    nprow, npcol = shape
    nd = nprow * npcol
    plan = _case("poisson")[0]
    lays = [layout2d.layout(plan, nprow, npcol, r, True) for r in range(nd)]
    routes, _ = layout2d.schur_routes(plan, nprow, npcol)
    us = np.array([len(r) for r in plan.sf.sn_rows])
    total = 0
    for gi, g in enumerate(plan.groups):
        own = routes[gi]
        if own is None:
            assert all(lay.groups[gi].pool_in == 0 for lay in lays)
            continue
        assert own["receiver"].min() >= 0 and own["receiver"].max() < nd
        elems = int(own["ur"].sum())            # each column: ur rows
        have = np.asarray(g.off) < plan.pool_size
        assert elems == int((us[np.asarray(g.sns)[have]] ** 2).sum())
        # received exactly once over the grid, each where it is added
        assert sum(lay.groups[gi].pool_in for lay in lays) == elems
        for r, lay in enumerate(lays):
            assert lay.groups[gi].pool_in == int(
                own["ur"][own["receiver"] == r].sum())
        total += elems
    assert sum(lay.pool_elems for lay in lays) == total
    assert max(lay.pool_len for lay in lays) <= plan.pool_size


@pytest.mark.parametrize("shape", GRIDS + [(1, 3)])
@pytest.mark.parametrize("partition", [False, True])
def test_own_exchange_leg_pairs_up(shape, partition):
    """A rank sends itself nothing: its own pivot and Schur columns are
    a separate leg whose source and target segments pair up one to
    one."""
    nprow, npcol = shape
    plan = _case("poisson")[0]
    for r in range(nprow * npcol):
        lay = layout2d.layout(plan, nprow, npcol, r, partition)
        for gl in lay.groups:
            assert gl.send_counts[r] == 0 and gl.recv_counts[r] == 0
            for frm, to in (gl.self_piv, gl.self_pool):
                np.testing.assert_array_equal(frm.length, to.length)


@pytest.mark.parametrize("npcol", [2, 3])
def test_share_ops_split_the_blocked_lu(npcol):
    """The process columns' counts of panel_partial_factor's operations
    sum to the one-column count, which is the blocked LU's."""
    from superlu_dist_tpu_torch.ops.dense import panel_width
    from superlu_dist_tpu_torch.parallel.mesh_stream import share_ops
    for g in _case("poisson")[0].groups:
        whole = share_ops(g.w, *layout2d.front_cols(g.m, g.w, 1, 0)[1:3],
                          1, 0)
        pb, nsteps = panel_width(g.w)
        m_ext = max(g.m, nsteps * pb)
        want = sum(min(pb, g.w - j0) * (m_ext * (2 * pb + 1)
                                        + (m_ext - j0 - pb)
                                        * (min(pb, g.w - j0) - 1
                                           + 2 * (m_ext - j0
                                                  - min(pb, g.w - j0))))
                   for j0 in range(0, g.w, pb))
        assert whole == want
        assert sum(share_ops(g.w, *layout2d.front_cols(g.m, g.w, npcol,
                                                       c)[1:3], npcol, c)
                   for c in range(npcol)) == whole


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("npcol", [2, 3])
def test_column_share_assembly_is_the_whole_front_sliced(dtype, npcol):
    """front_assemble_plain on a rank's column share (the replicated pool)
    equals the whole-front plain assembly of its slots, sliced to its
    columns, bit for bit."""
    plan, bvals, _, _ = _case("poisson")
    rng = np.random.default_rng(4)

    def rand(n):
        x = rng.standard_normal(n)
        if dtype.is_complex:
            x = x + 1j * rng.standard_normal(n)
        return torch.as_tensor(x).to(dtype)
    pool, avals = rand(plan.pool_size), rand(len(bvals))
    whole = factor.upload_maps(plan, "cpu")
    for nprow in (1, 2):
        for rank in range(nprow * npcol):
            lay = layout2d.layout(plan, nprow, npcol, rank, False)
            for g, gl, gm in zip(plan.groups, lay.groups, whole):
                if not (len(gl.slots) and gl.mc):
                    continue
                f = kernels.front_assemble_plain(avals, pool, g.m, g.w, gm)
                want = f.view(g.batch, g.m, g.m)[gl.slots][:, :,
                                                            gl.gcol[:gl.mc]]
                got = kernels.front_assemble_(avals, pool, g.m, g.w,
                                              share_maps(gl, "cpu"))
                assert torch.equal(got.view(len(gl.slots), g.m, gl.mc),
                                   want)


# ---------------------------------------------------------------------------
# the executor and the solver on spawned gloo ranks
# ---------------------------------------------------------------------------

_RUNS = {}


def _run(shape):
    if shape not in _RUNS:
        args = [(name, *_case(name)) for name in NAMES]
        _RUNS[shape] = run_mesh_ranks(
            shape[0] * shape[1], cases.mesh2d_vs_stream, args,
            nprow=shape[0], timeout=240, env=VERIFY)
    return _RUNS[shape]


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", NAMES)
def test_partitioned_and_replicated_pools_are_bitwise_equal(shape, name):
    out = _run(shape)
    for r in out:
        rec = out[r][name]
        assert rec["partition_equals_replicated"], (r, name)
        assert rec["executor"]["executor"] == "mesh-stream"
        assert rec["executor"]["pool_partition"]
        assert not rec["executor_replicated"]["pool_partition"]
        assert (rec["executor"]["nprow"], rec["executor"]["npcol"]) == shape


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", NAMES)
def test_2d_fronts_bitwise_the_stream(shape, name):
    out = _run(shape)
    for r in out:
        rec = out[r][name]
        assert rec["equal_to_stream"], (r, name, rec["rel_to_stream"])
        assert len(set(rec["tiny"])) == 1, rec["tiny"]


#: the float32 case's solves: the row sum of partial products
#: reassociates float32 sums, so they agree to float32's precision —
#: DEVICE_VS_HOST's budget is float64's
F32_SOLVE = tols.tol("float32", 2 ** 8, "float32 products summed over a "
                     "process row in another association")


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", NAMES)
def test_2d_solver_within_device_vs_host(shape, name):
    out = _run(shape)
    single = _case(name)[3] == "float32"
    rtol, atol = (F32_SOLVE, F32_SOLVE) if single else (RTOL, ATOL)
    for r in out:
        solves = out[r][name]["solves"]
        assert set(solves) >= {"N", "N1", "T"}
        if name == "helmholtz":
            assert "C" in solves
        for key, (x, x0) in solves.items():
            np.testing.assert_allclose(x, x0, rtol=rtol, atol=atol,
                                       err_msg=f"{r} {key}")
            # every rank gets the same x
            np.testing.assert_array_equal(x, out[0][name]["solves"][key][0])


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", NAMES)
def test_no_rank_holds_another_ranks_columns_or_pool(shape, name):
    out = _run(shape)
    nd = shape[0] * shape[1]
    plan = _case(name)[0]
    item = torch.empty((), dtype=getattr(torch, _case(name)[3])).element_size()
    for r in range(nd):
        sh = out[r][name]["shard"]
        assert sh["own_slots_only"] and sh["own_cols_only"], (r, name)
    # the panels add up to the whole factor: no column is held twice
    total = sum(out[r][name]["shard"]["front_bytes"] for r in range(nd))
    whole = sum(g.batch * (g.m * g.w + g.w * g.u) for g in plan.groups)
    assert total == whole * item
    # each rank's pool holds what it extend-adds: the shares add up to
    # the elements the plan's Schur blocks pass on, not nd pools
    pools = [out[r][name]["executor"]["pool_elems"] for r in range(nd)]
    replicated = out[0][name]["executor_replicated"]["pool_elems"]
    assert sum(pools) == replicated
    assert max(out[r][name]["executor"]["pool_bytes"] for r in range(nd)) \
        <= plan.pool_size * item


def test_2d_fronts_against_the_jax_mesh_stream():
    """tests/test_parallel.py's plan on the JAX StreamExecutor over
    gridinit(4, 2) with the partitioned pool, against the port's 2-D
    executor on a 2×2 grid: fronts within SCHEDULE_DRIFT, the tiny
    counts equal."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    from test_parallel import _plan
    jplan, avals, thresh = _plan()
    got = JStream(jplan, "float64", mesh=jgridinit(4, 2).mesh,
                  pool_partition=True)(jnp.asarray(avals),
                                       jnp.asarray(thresh))
    anorm = jgal.poisson2d(12).norm_max()
    plan = plan_from_reference(jplan)
    out = run_mesh_ranks(4, cases.mesh2d_vs_stream,
                         [("p", plan, np.asarray(avals), anorm, "float64")],
                         nprow=2, timeout=240, env=VERIFY)
    rec = out[0]["p"]
    assert rec["tiny"][0] == int(got[1])
    for (lp, up), (jl, ju) in zip(rec["fronts"], got[0]):
        np.testing.assert_allclose(lp, np.asarray(jl),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
        np.testing.assert_allclose(up, np.asarray(ju),
                                   rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)


# ---------------------------------------------------------------------------
# the grid's 2-D collectives
# ---------------------------------------------------------------------------

def test_row_and_exchange_collectives_on_a_2x2_grid():
    out = run_mesh_ranks(4, cases.row_collectives, nprow=2, timeout=120,
                         env=VERIFY)
    for r, rec in out.items():
        prow, pcol = divmod(r, 2)
        for src in range(2):
            assert (rec[f"bcast{src}"] == prow * 10 + src).all()
        # process-column order: (0.1 + 1e16 ...) the same bits on the row
        want = (torch.tensor([0.1, 1e16, -1e16], dtype=torch.float64)
                + torch.tensor([0.2, 1e16, -1e16], dtype=torch.float64))
        np.testing.assert_array_equal(rec["row_sum"], want.numpy())
        np.testing.assert_array_equal(rec["row_sum"],
                                      out[prow * 2]["row_sum"])
        want_x = np.concatenate([np.full(s + r + 1, 100.0 * s + r)
                                 for s in range(4)])
        np.testing.assert_array_equal(rec["exchange"], want_x)
        np.testing.assert_array_equal(rec["col"], [pcol, 2 + pcol])
        assert {"bcast_row", "all_reduce_row", "exchange",
                "all_gather_col"} <= set(rec["comm"])


@pytest.mark.parametrize("case", ["row", "counts"])
def test_divergent_2d_collectives_raise_on_every_rank(case):
    out = run_mesh_ranks(2, cases.mismatched_row_collectives, case,
                         timeout=120, env=VERIFY)
    assert out == {0: "mismatch: CollectiveMismatchError",
                   1: "mismatch: CollectiveMismatchError"}


# ---------------------------------------------------------------------------
# the option, the knob and the routing
# ---------------------------------------------------------------------------

def test_pool_partition_option_and_knob(monkeypatch):
    assert slt.Options().pool_partition is False
    assert slt.Options(pool_partition=True).pool_partition is True
    assert "SLU_TPU_POOL_PARTITION" in options.KNOB_REGISTRY
    mine = options.KNOB_REGISTRY["SLU_TPU_POOL_PARTITION"]
    ref = joptions.KNOB_REGISTRY["SLU_TPU_POOL_PARTITION"]
    assert (mine.kind, mine.default, mine.group) == (ref.kind, ref.default,
                                                     ref.group)
    monkeypatch.setenv("SLU_TPU_POOL_PARTITION", "1")
    assert slt.Options().pool_partition is True
    assert slt.Options().pool_partition == \
        joptions.Options().pool_partition
    # a registered knob: strict env takes it (with only the port's knobs
    # in the environment)
    for key in [k for k in os.environ if k.startswith("SLU_TPU_")
                and k not in options.KNOB_REGISTRY]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("SLU_TPU_STRICT_ENV", "1")
    monkeypatch.setattr(options, "_strict_checked", False)
    assert options.env_flag("SLU_TPU_POOL_PARTITION") is True
    assert slt.Options().pool_partition is True


class _Grid:
    def __init__(self, nprow, npcol):
        self.nprow, self.npcol = nprow, npcol

    @property
    def nproc(self):
        return self.nprow * self.npcol


@pytest.mark.parametrize("executor,partition,want", [
    ("stream", False, "mesh-stream"), ("stream", True, "mesh-stream"),
    ("auto", True, "mesh-stream"), ("spmd", True, "mesh-stream"),
    ("auto", False, "spmd"), ("spmd", False, "spmd"),
    ("fused", False, None), ("mega", True, None)])
def test_resolve_executor_on_a_grid(executor, partition, want):
    grid = _Grid(1, 2)
    dev = torch.device("cpu")
    if want is None:
        with pytest.raises(ValueError, match="runs the spmd or the 2-D"):
            factor.resolve_executor(executor, dev, grid, partition)
    else:
        assert factor.resolve_executor(executor, dev, grid,
                                       partition) == want


@pytest.mark.parametrize("executor", ["auto", "stream", "spmd", "fused"])
def test_pool_partition_is_ignored_off_a_grid(executor):
    dev = torch.device("cpu")
    for grid in (None, _Grid(1, 1)):
        assert factor.resolve_executor(executor, dev, grid, True) == \
            factor.resolve_executor(executor, dev, grid, False)
    plan, bvals, anorm, _ = _case("poisson")
    f0 = factor.numeric_factorize(plan, bvals, anorm, dtype=torch.float64,
                                  device="cpu", executor="stream")
    f1 = factor.numeric_factorize(plan, bvals, anorm, dtype=torch.float64,
                                  device="cpu", executor="stream",
                                  pool_partition=True)
    assert f1.shard is None and f1.executor["executor"] == "stream"
    for (a, b), (c, d) in zip(f1.fronts, f0.fronts):
        assert torch.equal(a, c) and torch.equal(b, d)
