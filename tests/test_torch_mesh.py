"""The mesh tier's drivers on gloo CPU ranks: ``pgssvx(grid=)``
(superlu_dist_tpu_torch/parallel/pgssvx.py), ``gssvx(grid=)``,
``ShardedSpMV`` and the ``pddrive_grid`` example.

Each scenario runs on spawned ranks (``testing.ranks.run_mesh_ranks``,
functions in tests/torch_mesh_cases.py) with SLU_TPU_VERIFY_COLLECTIVES
on, and is held against the JAX package in this process:

* pgssvx(grid=) with the root-broadcast analysis, replicate_analysis and
  par_symb_fact: x within DEVICE_VS_HOST of the JAX ``gssvx``, BERR at
  the float64 target, the residuals on the ranks' devices
  (``ShardedSpMV.from_rows``), every rank the same x bit for bit, no rank
  holding another's panels; then FACTORED at nrhs 2 on the sharded
  handles and a SamePattern_SameRowPerm refactor (symbolic structure and
  plan reused on the root);
* TRANS, complex CONJ, the distributed-hiprec rung (float32 factors of a
  near-singular arrowhead), FACTORED refused on every rank when one rank
  lacks its handle;
* gssvx(grid=) with the whole matrix on every rank, against the JAX
  ``gssvx``; ShardedSpMV against the JAX ``ShardedSpMV`` on the
  8-device virtual mesh, and over each rank's block rows at NOTRANS,
  TRANS and CONJ (and |op(A)|) against the host products, refusing blocks
  out of rank order; the example on 2 ranks, and with --parsymb on 3.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel.dist import ShardedSpMV as JShardedSpMV
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit

import torch_mesh_cases as cases
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_x(spec, trans=None, nrhs=None, scale=1.0, seed_shift=0):
    """The JAX gssvx's x for a case spec (name, args, seed, nrhs)."""
    name, args, seed, k = spec
    a = getattr(jgal, name)(*args)
    if scale != 1.0:
        a = a.__class__(a.n_rows, a.n_cols, a.indptr, a.indices,
                        a.data * scale)
    _, b = cases._system((name, args, seed + seed_shift,
                          k if nrhs is None else nrhs))
    opts = jslu.Options() if trans is None else jslu.Options(trans=trans)
    x, _, _, info = jslu.gssvx(opts, a, b)
    assert info == 0
    return np.asarray(x)


def _same_everywhere(out, key):
    for r in out:
        np.testing.assert_array_equal(out[r][key], out[0][key])


_FLOWS = {}


def _flow(mode, nd=2):
    if (mode, nd) not in _FLOWS:
        spec = ("poisson3d", (7,), 0, None)
        _FLOWS[mode, nd] = (spec, run_mesh_ranks(
            nd, cases.pgssvx_flow, spec, {}, mode, timeout=240, env=VERIFY))
    return _FLOWS[mode, nd]


@pytest.mark.parametrize("mode,nd", [("root", 2), ("root", 3),
                                     ("replicate", 2), ("psf", 2)])
def test_pgssvx_grid_equals_jax_gssvx(mode, nd):
    spec, out = _flow(mode, nd)
    _same_everywhere(out, "x")
    jx = _jax_x(spec)
    for r in range(nd):
        rec = out[r]
        assert rec["info"] == 0 and rec["berr"] <= TARGET
        assert rec["sharded"] and rec["route"] == "device"
        np.testing.assert_allclose(rec["x"], jx, rtol=RTOL, atol=ATOL)
    # the tiny count is the grid's: the same on every rank
    assert len({out[r]["tiny"] for r in range(nd)}) == 1


@pytest.mark.parametrize("mode,nd", [("root", 2), ("root", 3),
                                     ("replicate", 2), ("psf", 2)])
def test_no_rank_holds_another_ranks_panels(mode, nd):
    _, out = _flow(mode, nd)
    shards = [out[r]["shard"] for r in range(nd)]
    assert all(s["own_slots_only"] for s in shards)
    assert sum(s["owned_slots"] for s in shards) > max(
        s["owned_slots"] for s in shards)
    # every rank's timings are recorded
    for r in range(nd):
        t = out[r]["timings"]
        assert t["fact_s"] > 0 and t["gather_bytes"] > 0
        assert set(t) >= {"analysis_s", "fact_s", "solve_s", "refine_s",
                          "gather_s", "peak_bytes"}


@pytest.mark.parametrize("mode,nd", [("root", 2), ("root", 3),
                                     ("replicate", 2), ("psf", 2)])
def test_factored_on_the_sharded_handles(mode, nd):
    spec, out = _flow(mode, nd)
    _same_everywhere(out, "x_factored")
    b2 = out[0]["b_factored"]
    a = cases._system(spec)[0]
    res = np.linalg.norm(b2 - a.matvec(out[0]["x_factored"])) \
        / np.linalg.norm(b2)
    assert res < 1e-12
    jx2 = _jax_x(spec, nrhs=2, seed_shift=10)
    np.testing.assert_allclose(out[0]["x_factored"], jx2, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode,nd", [("root", 2), ("root", 3),
                                     ("replicate", 2)])
def test_samepattern_refactor_on_the_grid(mode, nd):
    spec, out = _flow(mode, nd)
    _same_everywhere(out, "x_refactor")
    a = cases._system(spec)[0]
    a2 = a.__class__(a.n_rows, a.n_cols, a.indptr, a.indices, a.data * 1.5)
    b3 = a2.matvec(np.ones(a.n_rows))
    res = np.linalg.norm(b3 - a2.matvec(out[0]["x_refactor"])) \
        / np.linalg.norm(b3)
    assert res < 1e-12
    if mode == "root":
        # the root reuses its symbolic structure and plan (the peers
        # receive the reused skeleton in the broadcast)
        assert out[0]["refactor_reused"]


@pytest.mark.parametrize("case", ["trans", "conj"])
def test_pgssvx_grid_trans_and_conj(case):
    from superlu_dist_tpu_torch.utils.options import Trans
    if case == "trans":
        spec = ("convection_diffusion_2d", (12,), 3, None)
        trans, jtrans = Trans.TRANS, jslu.Trans.TRANS
    else:
        spec = ("helmholtz_2d", (10,), 4, None)
        trans, jtrans = Trans.CONJ, jslu.Trans.CONJ
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec, {"trans": trans},
                         "root", timeout=240, env=VERIFY)
    _same_everywhere(out, "x")
    jx = _jax_x(spec, trans=jtrans)
    assert out[0]["berr"] <= TARGET
    np.testing.assert_allclose(out[0]["x"], jx, rtol=RTOL, atol=ATOL)


def test_distributed_hiprec_rung_on_the_grid():
    """float32 factors of the near-singular arrowhead: the distributed
    refinement stagnates, and one collective rerun at float64 factors
    on the grid reaches the target."""
    spec = ("rank_deficient_arrowhead", (60, 1e-6, 0), 1, None)
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec,
                         {"factor_dtype": "float32"}, "root", timeout=240,
                         env=VERIFY)
    _same_everywhere(out, "x")
    for r in range(2):
        assert out[r]["rungs"] == ["distributed-hiprec"]
        assert out[r]["berr"] <= TARGET
    ja = jgal.rank_deficient_arrowhead(60, 1e-6, 0)
    jx, _, _, _ = jslu.gssvx(jslu.Options(), ja, cases._system(spec)[1])
    np.testing.assert_allclose(out[0]["x"], np.asarray(jx), rtol=RTOL,
                               atol=ATOL)


def test_factored_without_every_handle_raises_on_every_rank():
    out = run_mesh_ranks(2, cases.factored_without_handle,
                         ("poisson2d", (8,), 0, None), timeout=180,
                         env=VERIFY)
    for r in range(2):
        assert out[r].startswith("raised: Fact=FACTORED requires EVERY "
                                 "rank's prior lu handle (1/2"), out[r]


@pytest.mark.parametrize("nd", [2, 3])
def test_gssvx_grid_equals_jax_gssvx(nd):
    spec = ("poisson3d", (6,), 2, 3)
    out = run_mesh_ranks(nd, cases.gssvx_grid, spec, {}, timeout=180,
                         env=VERIFY)
    _same_everywhere(out, "x")
    _same_everywhere(out, "x2")
    jx = _jax_x(spec)
    np.testing.assert_allclose(out[0]["x"], jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[0]["x2"], 2 * jx, rtol=RTOL, atol=ATOL)
    for r in range(nd):
        assert out[r]["info"] == 0 and out[r]["berr"] <= TARGET
        assert out[r]["executor"]["executor"] == "spmd"
        assert out[r]["shard"]["own_slots_only"]
        # a sharded handle is no bundle: save_lu refuses it
        assert out[r]["saved"].startswith("refused: save_lu takes a whole")


@pytest.mark.parametrize("nd", [2])
def test_sharded_spmv_equals_jax(nd):
    if len(jax.devices()) < nd:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    spec = ("convection_diffusion_2d", (15,), 0, None)
    a, _ = cases._system(spec)
    x = np.random.default_rng(5).standard_normal(a.n_rows)
    out = run_mesh_ranks(nd, cases.sharded_spmv, spec, x, timeout=120)
    _same_everywhere({r: {"y": y} for r, y in out.items()}, "y")
    ja = jgal.convection_diffusion_2d(15)
    jy = np.asarray(JShardedSpMV(ja, jgridinit(1, nd).mesh)(x))
    np.testing.assert_allclose(out[0], jy, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(out[0], a.matvec(x), rtol=1e-14, atol=1e-14)


_SPMV_CASES = [("convection_diffusion_2d", (9,), 0, None),
               ("helmholtz_2d", (8,), 0, None)]
_SPMV = {}


def _spmv_ops(nd):
    """The cases' operands and every rank's products, one spawn per nd."""
    if nd not in _SPMV:
        xs = []
        for spec in _SPMV_CASES:
            a, _ = cases._system(spec)
            rng = np.random.default_rng(6)
            x = rng.standard_normal((a.n_rows, 2))
            if np.iscomplexobj(a.data):
                x = x + 1j * rng.standard_normal((a.n_rows, 2))
            xs.append(x)
        _SPMV[nd] = xs, run_mesh_ranks(nd, cases.sharded_spmv_ops,
                                       _SPMV_CASES, xs, timeout=120,
                                       env=VERIFY)
    return _SPMV[nd]


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("case", [0, 1], ids=[c[0] for c in _SPMV_CASES])
def test_sharded_spmv_op_over_block_rows(nd, case):
    """The mesh refinement's residual operator over each rank's block
    rows: op(A)·x and |op(A)|·x at NOTRANS, TRANS and CONJ against the
    host products of the whole matrix; NOTRANS bit for bit the
    whole-matrix constructor's."""
    spec = _SPMV_CASES[case]
    xs, out = _spmv_ops(nd)
    x = xs[case]
    got = {r: out[r][spec[0]] for r in out}
    for key in got[0]:
        _same_everywhere(got, key)
    dense = cases._system(spec)[0].to_dense()
    want = {"NOTRANS": dense @ x, "TRANS": dense.T @ x,
            "CONJ": dense.conj().T @ x,
            "abs NOTRANS": np.abs(dense) @ np.abs(x),
            "abs TRANS": np.abs(dense).T @ np.abs(x),
            "abs CONJ": np.abs(dense).T @ np.abs(x)}
    for key, w in want.items():
        np.testing.assert_allclose(got[0][key], w, rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(got[0]["whole"], got[0]["NOTRANS"])


def test_sharded_spmv_refuses_blocks_out_of_rank_order():
    out = run_mesh_ranks(2, cases.sharded_spmv_out_of_order,
                         ("poisson2d", (6,), 0, None), timeout=120)
    assert all(v.startswith("refused: the ranks' block rows")
               for v in out.values()), out


@pytest.mark.parametrize("argv", [["--nproc", "2", "--resolve"],
                                  ["--nproc", "3", "--parsymb",
                                   "--resolve"]],
                         ids=["resolve", "parsymb"])
def test_pddrive_grid_example(argv):
    script = os.path.join(REPO, "superlu_dist_tpu_torch", "examples",
                          "pddrive_grid.py")
    proc = subprocess.run([sys.executable, script, "--device", "cpu", *argv],
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pddrive_grid OK" in proc.stdout
    assert "FACTORED re-solve" in proc.stdout
