"""The port's command-line driver (``python -m superlu_dist_tpu_torch``,
the pddrive / pdtest analog) on the CPU, beside the JAX package's CLI on
the same matrix file: the solve and its PStatPrint-style report, TRANS
with two right-hand sides, the pdtest-style sweep, df64 (native float64
factors, rc 0), and the card asked for by default."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from superlu_dist_tpu.__main__ import main as jax_main
from superlu_dist_tpu.io import write_matrix_market as jax_write

from superlu_dist_tpu_torch.__main__ import main
from superlu_dist_tpu_torch.io import write_matrix_market
from superlu_dist_tpu_torch.models.gallery import poisson2d
from superlu_dist_tpu_torch.utils import tols

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def mtx_file(tmp_path):
    path = str(tmp_path / "p2d.mtx")
    write_matrix_market(path, poisson2d(7))
    return path


def _value(out, label):
    m = re.search(re.escape(label) + r"\s+([-+0-9.eE]+)", out)
    assert m, (label, out)
    return float(m.group(1))


def test_cli_solves_and_reports(mtx_file, capsys):
    rc = main(["-f", mtx_file, "--device", "cpu", "--stats"])
    out = capsys.readouterr().out
    assert rc == 0
    for phase in ("FACT", "SOLVE", "REFINE"):
        assert re.search(rf"{phase}\s+time\s+\d", out), phase
    assert "schedule dataflow" in out and "peak device memory" in out
    assert "solve report:" in out and "read in" in out
    assert _value(out, "backward error (IR)") <= tols.berr_target(np.float64)
    res = _value(out, "residual ||b-Ax||/||b||")
    assert jax_main(["-f", mtx_file]) == 0
    jout = capsys.readouterr().out
    np.testing.assert_allclose(res, _value(jout, "residual ||b-Ax||/||b||"),
                               rtol=0, atol=1e-14)
    assert res < tols.RESID_GATE


def test_cli_trans_with_two_rhs(mtx_file, capsys):
    assert main(["-f", mtx_file, "--device", "cpu", "--trans", "--nrhs",
                 "2", "-q"]) == 0
    assert "residual" not in capsys.readouterr().out


def test_cli_sweep_counts_like_the_jax_package(mtx_file, capsys):
    assert main(["-f", mtx_file, "--device", "cpu", "--sweep"]) == 0
    out = capsys.readouterr().out
    assert jax_main(["-f", mtx_file, "--sweep"]) == 0
    jout = capsys.readouterr().out
    summary = re.compile(r"summary: (\d+) passed, (\d+) failed")
    assert summary.search(out).groups() == summary.search(jout).groups() \
        == ("21", "0")


def test_cli_df64_exits_2_without_a_traceback(mtx_file, capsys):
    """``--dtype df64`` runs: the port factors in native float64 (the
    JAX package's df64 is emulated double), rc 0, no traceback."""
    assert main(["-f", mtx_file, "--device", "cpu", "--dtype", "df64",
                 "--stats"]) == 0
    cap = capsys.readouterr()
    assert "factor dtype float64" in cap.out
    assert "Traceback" not in cap.err


def test_cli_float32_on_a_complex_file(tmp_path, capsys):
    """--dtype float32 on a complex matrix factors in complex64, refined
    to float64 accuracy."""
    rng = np.random.default_rng(0)
    a = poisson2d(6)
    a.data = a.data + 0.2j * rng.standard_normal(a.nnz)
    path = str(tmp_path / "c.mtx")
    jax_write(path, a)
    assert main(["-f", path, "--device", "cpu", "--dtype", "float32"]) == 0
    assert "factor dtype complex64" in capsys.readouterr().out


def test_cli_asks_for_the_card_by_default(mtx_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-f", mtx_file])


def test_module_entry_point(mtx_file):
    out = subprocess.run(
        [sys.executable, "-m", "superlu_dist_tpu_torch", "-f", mtx_file,
         "--device", "cpu", "--no-equil", "--rowperm", "NOROWPERM"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "backward error (IR)" in out.stdout


def test_stats_report_blocks_match_jax():
    """The report's time, flop, schedule, resume, memory and count lines
    are the JAX package's lines for the same Stats contents (its report
    adds blocks the port has no counterpart of: compile census, comm,
    latency)."""
    from superlu_dist_tpu.utils.stats import Stats as JaxStats
    from superlu_dist_tpu_torch.utils.stats import Stats
    a = poisson2d(9)
    import superlu_dist_tpu_torch as slt
    lu, _, _ = slt.analyze(slt.Options(), a, device="cpu")
    reports = []
    for cls in (Stats, JaxStats):
        st = cls()
        st.utime["FACT"], st.utime["SOLVE"] = 1.5, 0.25
        st.ops["FACT"], st.ops["SOLVE"] = 2.0e9, 1.0e6
        st.sched = lu.plan.schedule_stats(itemsize=4)
        st.resume = {"groups": 3, "of": 9, "path": "/x/ck"}
        st.for_lu_bytes, st.pool_bytes = 12_345_678, 2_345_678
        st.log_memory(500_000_000)
        st.log_memory(-100_000_000)
        st.observe_memory(300_000_000)
        st.tiny_pivots, st.refine_steps = 2, 5
        assert st.peak_memory_bytes == 500_000_000
        reports.append(st.report().splitlines())
    ours, theirs = reports
    assert ours[0] == ours[-1] == "*" * 50
    assert [line for line in ours if line not in theirs] == []
    assert any(line.startswith("    schedule dataflow") for line in ours)
    assert any("resumed  3/9 groups" in line for line in ours)


def test_print_stat_prints_the_banner_and_the_report(capsys):
    import superlu_dist_tpu_torch as slt
    a = poisson2d(6)
    slt.gssvx(slt.Options(print_stat=True), a, a.matvec(np.ones(a.n_rows)),
              device="cpu")
    out = capsys.readouterr().out
    assert ".. options:" in out and "print_stat           True" in out
    assert "**** Time (seconds) ****" in out and "peak device memory" in out
