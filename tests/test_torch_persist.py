"""The port's persistence (superlu_dist_tpu_torch/persist/) on the CPU,
held against the JAX package's persist/ on the same inputs: LU bundles
round-trip bit for bit and solve without refactoring; corrupt, truncated
or unknown-version bundles raise the structured errors; a checkpointed
factorization resumes to fronts bit for bit equal to an uninterrupted
run; a resume refuses changed values, another plan or another GEMM tier;
a bundle the JAX package wrote is refused by a process that never
imports jax, while its arrays are readable and agree with the port's
own bundle of the same matrix; the in-place pool is copied only at a
group boundary."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from superlu_dist_tpu.drivers.gssvx import gssvx as jax_gssvx
from superlu_dist_tpu.persist import save_lu as jax_save_lu
from superlu_dist_tpu.utils.options import Options as JaxOptions
from superlu_dist_tpu.models import gallery as jgal

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.persist import checkpoint, serial
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.deadline import Deadline
from superlu_dist_tpu_torch.utils.errors import (CheckpointCorruptError,
                                                 CheckpointError,
                                                 CheckpointMismatchError,
                                                 CheckpointVersionError,
                                                 DeadlineExceededError)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


class Countdown(Deadline):
    """Expires at the (n+1)-th poll — just before group n — instead of on
    the wall clock, so a test stops the loop at an exact boundary."""

    def __init__(self, n):
        super().__init__(0.0)
        self.n = n

    def expired_local(self):
        return self.polls > self.n


def _same_fronts(f1, f2):
    return len(f1) == len(f2) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(f1, f2))


def _matrix(kind):
    a = gallery.poisson3d(6)
    if kind == "complex128":
        rng = np.random.default_rng(5)
        a = slt.SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                          a.data + 0.1j * rng.standard_normal(a.nnz))
    return a


def _analyzed(nx=8, **opts):
    a = gallery.poisson3d(nx)
    lu, bvals, _ = slt.analyze(slt.Options(**opts), a, device=CPU)
    return a, lu, bvals


def _factor(lu, bvals, **kw):
    kw.setdefault("dtype", torch.float64)
    return factor.numeric_factorize(lu.plan, bvals, lu.anorm, device=CPU,
                                    **kw)


# ---------------------------------------------------------------------------
# LU handle bundles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_lu_round_trip_is_bitwise_and_solves_factored(tmp_path, dtype):
    a = _matrix(dtype)
    b = a.matvec(np.ones(a.n_rows))
    _, lu, _, info = slt.gssvx(
        slt.Options(factor_dtype=None if dtype == "complex128" else dtype),
        a, b, device=CPU)
    assert info == 0 and serial.dtype_str(lu.numeric.dtype) == dtype
    path = slt.save_lu(lu, str(tmp_path / "h"))
    meta = serial.lu_meta(path)
    assert meta["factor_dtype"] == dtype and meta["n"] == a.n_rows
    assert meta["nbytes"] == sum(f.stat().st_size for f in
                                 pathlib.Path(path).iterdir()
                                 if f.name != serial.MANIFEST)
    lu2 = slt.load_lu(path, device=CPU)
    assert lu2.a is None and lu2.numeric.dtype == lu.numeric.dtype
    assert _same_fronts(lu.numeric.fronts, lu2.numeric.fronts)
    assert serial.front_digests(lu2.numeric.fronts) == \
        serial.bundle_front_digests(path)
    assert lu2.identity() == lu.identity()
    x, _, st, info = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, b,
                               lu=lu2)
    assert info == 0 and st.utime["FACT"] == 0.0
    assert st.solve_report.berr <= tols.berr_target(np.float64)


def test_load_lu_asks_for_the_card_by_default(tmp_path, monkeypatch):
    _, lu, bvals = _analyzed(nx=4)
    lu.numeric = _factor(lu, bvals)
    path = slt.save_lu(lu, str(tmp_path / "h"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        slt.load_lu(path)


def _corrupt(path, name, mode):
    f = os.path.join(path, name)
    if mode == "truncate":
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)
    elif mode == "flip":
        with open(f, "r+b") as fh:
            fh.seek(os.path.getsize(f) // 2)
            byte = fh.read(1)
            fh.seek(os.path.getsize(f) // 2)
            fh.write(bytes([byte[0] ^ 0xFF]))
    elif mode == "version":
        doc = json.loads(open(f).read())
        doc["version"] = 999
        open(f, "w").write(json.dumps(doc))
    elif mode == "garbage":
        open(f, "w").write("{not json")
    else:
        os.remove(f)


@pytest.mark.parametrize("name,mode,error", [
    ("front_00002_l.npy", "flip", CheckpointCorruptError),
    ("front_00002_l.npy", "truncate", CheckpointCorruptError),
    ("structure.pkl", "flip", CheckpointCorruptError),
    ("dr.npy", "delete", CheckpointCorruptError),
    (serial.MANIFEST, "version", CheckpointVersionError),
    (serial.MANIFEST, "garbage", CheckpointCorruptError),
    (serial.MANIFEST, "delete", CheckpointError),
])
def test_damaged_bundles_raise_structured_errors(tmp_path, name, mode,
                                                 error):
    """The same damage the JAX package's load_lu answers with the same
    error class."""
    from superlu_dist_tpu.persist import load_lu as jax_load_lu
    a = gallery.poisson3d(6)
    b = a.matvec(np.ones(a.n_rows))
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device=CPU)
    _, jlu, _, _ = jax_gssvx(JaxOptions(), jgal.poisson3d(6), b)
    for tag, save in (("port", slt.save_lu), ("jax", jax_save_lu)):
        save(lu if tag == "port" else jlu, str(tmp_path / tag))
        _corrupt(str(tmp_path / tag), name, mode)
    with pytest.raises(error):
        slt.load_lu(str(tmp_path / "port"), device=CPU)
    # the JAX package raises its own classes, of the same names
    with pytest.raises(Exception) as ei:
        jax_load_lu(str(tmp_path / "jax"))
    assert error.__name__ in [c.__name__ for c in type(ei.value).__mro__]


_JAX_FREE = r"""
import sys
sys.path.insert(0, {root!r})
import superlu_dist_tpu_torch, superlu_dist_tpu_torch.persist
import superlu_dist_tpu_torch.io, superlu_dist_tpu_torch.__main__
from superlu_dist_tpu_torch.persist import load_lu
from superlu_dist_tpu_torch.utils.errors import CheckpointMismatchError
try:
    load_lu({path!r}, device="cpu")
except CheckpointMismatchError as e:
    assert "JAX package" in str(e), e
else:
    raise SystemExit("a bundle of the JAX package was loaded")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "superlu_dist_tpu")]
assert not bad, bad
print("refused")
"""


def test_bundle_of_the_jax_package_is_refused_without_importing_jax(
        tmp_path):
    a = jgal.poisson3d(6)
    _, jlu, _, _ = jax_gssvx(JaxOptions(), a, a.matvec(np.ones(a.n_rows)))
    path = jax_save_lu(jlu, str(tmp_path / "jax"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_FREE.format(root=str(ROOT), path=path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "refused" in out.stdout


def test_arrays_of_a_jax_bundle_agree_with_the_port_bundle(tmp_path):
    """Same matrix, same native plan: the manifests share the plan
    fingerprint and layout, and the port's read_array (digests verified)
    reads the JAX fronts, which agree with the port's at the
    cross-schedule drift gate."""
    a = gallery.poisson3d(8)
    b = a.matvec(np.ones(a.n_rows))
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device=CPU)
    _, jlu, _, _ = jax_gssvx(JaxOptions(), jgal.poisson3d(8), b)
    ours = slt.save_lu(lu, str(tmp_path / "port"))
    theirs = jax_save_lu(jlu, str(tmp_path / "jax"))
    d_ours = serial.read_manifest(ours, kind="lu_handle")
    d_theirs = serial.read_manifest(theirs, kind="lu_handle")
    for key in ("n", "n_groups", "plan_fingerprint", "pattern_digest",
                "factor_dtype", "equed", "tiny_pivots"):
        assert d_ours["meta"][key] == d_theirs["meta"][key], key
    assert set(d_ours["arrays"]) == set(d_theirs["arrays"])
    for g in range(d_ours["meta"]["n_groups"]):
        for side in ("l", "u"):
            name = f"front_{g:05d}_{side}"
            np.testing.assert_allclose(
                serial.read_array(ours, name, d_ours),
                serial.read_array(theirs, name, d_theirs),
                rtol=tols.SCHEDULE_DRIFT_RTOL, atol=tols.SCHEDULE_DRIFT_ATOL,
                err_msg=name)
    for name in ("dr", "dc", "r1", "c1", "row_order", "col_order"):
        np.testing.assert_allclose(serial.read_array(ours, name, d_ours),
                                   serial.read_array(theirs, name, d_theirs),
                                   rtol=1e-13, err_msg=name)


# ---------------------------------------------------------------------------
# mid-factor checkpoints and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128])
def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path, dtype):
    """poisson3d(8) (complex values for complex128), ckpt_every=2:
    interval flushes at 2 and 4, the deadline's at 5; the resumed run's
    every front is torch.equal to an uninterrupted one, and its tiny-pivot
    count is the same."""
    _, lu, bvals = _analyzed(nx=8)
    if dtype.is_complex:
        bvals = bvals + 0.1j * np.random.default_rng(1).standard_normal(
            len(bvals))
    assert len(lu.plan.groups) >= 8
    ref = _factor(lu, bvals, dtype=dtype)
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceededError) as ei:
        _factor(lu, bvals, dtype=dtype, ckpt_dir=ck, ckpt_every=2,
                deadline=Countdown(5))
    assert ei.value.checkpoint_path == os.path.abspath(ck)
    meta = checkpoint.peek(ck)
    assert (meta["k"], meta["reason"]) == (5, "deadline")
    res = _factor(lu, bvals, dtype=dtype, resume_from=ck)
    assert res.resumed_groups == 5
    assert _same_fronts(res.fronts, ref.fronts)
    assert res.tiny_pivots == ref.tiny_pivots


def test_resume_through_the_driver_is_a_report_rung(tmp_path):
    """gssvx(resume_from=) records the resume on stats.resume, as a
    'resume-from-checkpoint' rung and in the Stats report, and its
    factors equal an uninterrupted gssvx's."""
    a, lu0, bvals = _analyzed(nx=8)
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceededError):
        _factor(lu0, bvals, ckpt_dir=ck, deadline=Countdown(3))
    b = a.matvec(np.ones(a.n_rows))
    _, ref, _, _ = slt.gssvx(slt.Options(), a, b, device=CPU)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device=CPU,
                                   resume_from=ck)
    assert info == 0
    assert stats.resume == {"groups": 3, "of": len(lu.plan.groups),
                            "path": ck}
    rungs = [r for r in stats.solve_report.rungs
             if r.name == "resume-from-checkpoint"]
    assert len(rungs) == 1 and rungs[0].detail.startswith("3/")
    assert "resume-from-checkpoint" in stats.solve_report.summary()
    assert "resumed" in stats.report()
    assert _same_fronts(lu.numeric.fronts, ref.numeric.fronts)
    assert stats.solve_report.berr <= tols.berr_target(np.float64)


@pytest.mark.parametrize("change", ["values", "plan", "gemm_tier",
                                    "dtype"])
def test_resume_refuses_another_factorization(tmp_path, change):
    _, lu, bvals = _analyzed(nx=8)
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceededError):
        _factor(lu, bvals, ckpt_dir=ck, deadline=Countdown(3))
    kw = {}
    if change == "values":
        bvals = bvals.copy()
        bvals[0] *= 1.5
    elif change == "plan":
        _, lu, bvals = _analyzed(nx=8, relax=4, max_supernode=16)
    elif change == "gemm_tier":
        kw["gemm_prec"] = "bf16"
    else:
        kw["dtype"] = torch.float32
    with pytest.raises(CheckpointMismatchError, match="different"):
        _factor(lu, bvals, resume_from=ck, **kw)


def test_checkpoint_is_removed_after_a_completed_run(tmp_path):
    _, lu, bvals = _analyzed(nx=6)
    ck = str(tmp_path / "ck")
    _factor(lu, bvals, ckpt_dir=ck, ckpt_every=2)
    assert not os.path.exists(os.path.join(ck, serial.MANIFEST))
    assert checkpoint.last_checkpoint() is None


def test_the_pool_is_copied_at_a_boundary_not_referenced(tmp_path,
                                                         monkeypatch):
    """The loop writes the Schur pool in place.  A flush asked for from
    outside the loop (a SIGTERM) just before group 3's note — when the
    pool already holds group 3's write-back — must not write the noted
    frontier 3 with that pool: the request waits for the boundary, and
    the bundle is frontier 4, equal to a fresh run stopped at 4."""
    _, lu, bvals = _analyzed(nx=8)
    ck, snap = str(tmp_path / "ck"), str(tmp_path / "snap")
    note = checkpoint.FactorCheckpointer.note

    def noted(self, gi, fronts, pool, tiny):
        if gi == 3:
            checkpoint.flush_active("test")
        note(self, gi, fronts, pool, tiny)
        if gi == 3:
            shutil.copytree(self.dirpath, snap)

    monkeypatch.setattr(checkpoint.FactorCheckpointer, "note", noted)
    ref = _factor(lu, bvals, ckpt_dir=ck)
    monkeypatch.undo()
    fresh = str(tmp_path / "fresh")
    with pytest.raises(DeadlineExceededError):
        _factor(lu, bvals, ckpt_dir=fresh, deadline=Countdown(4))
    got, want = (checkpoint.load_checkpoint(p) for p in (snap, fresh))
    assert (got.k, got.meta["reason"]) == (4, "test")
    assert np.array_equal(got.pool, want.pool)
    assert got.tiny == want.tiny
    for (l1, u1), (l2, u2), (l3, u3) in zip(got.fronts, want.fronts,
                                            ref.fronts):
        assert np.array_equal(l1, l2) and np.array_equal(u1, u2)
        assert np.array_equal(l1, l3.numpy()) and np.array_equal(u1,
                                                                 u3.numpy())


def test_an_interval_flush_copies_the_pool(tmp_path):
    """The checkpointer on its own: the interval flush copies the pool
    and the tiny count as they stand; later in-place updates do not reach
    the bundle."""
    _, lu, bvals = _analyzed(nx=4)
    ck = checkpoint.FactorCheckpointer(str(tmp_path / "ck"), lu.plan, bvals,
                                       1e-8, torch.float64, every=2)
    pool = torch.arange(lu.plan.pool_size, dtype=torch.float64)
    tiny = torch.tensor(3)
    fronts = [(torch.ones(1, 2, 2), torch.ones(1, 2, 0))] * 2
    ck.note(1, fronts, pool, tiny)
    pool += 1.0
    tiny += 5
    got = checkpoint.load_checkpoint(ck.dirpath)
    ck.complete(cleanup=True)
    assert got.k == 2 and got.tiny == 3
    assert np.array_equal(got.pool, np.arange(lu.plan.pool_size,
                                              dtype=np.float64))
