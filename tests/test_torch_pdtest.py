"""The port's pdtest (superlu_dist_tpu_torch/examples/pdtest.py) on the
CPU, beside the JAX package's ``scripts/pdtest.py``.

Its inner loop (DOFACT → FACTORED → SamePattern → SamePattern_SameRowPerm
under one configuration) is held against the JAX ``_one_config`` — called
directly, never the JAX ``main``, which writes docs/pdtest_summary.json —
at every ``--quick`` configuration of the 1×1 grid: the same tags, run
counts and pass flags.  Then ``main --quick`` (1×1 in-process, 1×2 on two
gloo CPU ranks) reports no failure, writes nothing without ``--out``, and
with it writes the JSON summary.
"""

import importlib.util
import json
import os

import pytest

from superlu_dist_tpu_torch.examples import pdtest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_pdtest():
    spec = importlib.util.spec_from_file_location(
        "jax_pdtest", os.path.join(REPO, "scripts", "pdtest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("equil,rowperm", pdtest.EQUIL_ROWPERM)
def test_one_config_matches_the_jax_pdtest(nrhs, equil, rowperm):
    jpd = _jax_pdtest()
    a, tag = pdtest.load_fixture("g20.rua")
    ja, jtag = jpd._load_fixture("g20.rua")
    assert tag == jtag
    rows, jrows = [], []
    got = pdtest.one_config(a, None, nrhs, 8, 20, equil, rowperm, rows,
                            device="cpu")
    want = jpd._one_config(ja, None, nrhs, 8, 20, equil, rowperm, jrows)
    assert got == want == (4, 0)
    assert [(r["tag"], r["pass"]) for r in rows] == \
        [(r["tag"], r["pass"]) for r in jrows]


def test_stand_ins_are_the_jax_packages():
    import numpy as np
    jpd = _jax_pdtest()
    for name in ("g20.rua", "big.rua", "cg20.cua"):
        (a, tag), (ja, jtag) = pdtest.load_fixture(name), \
            jpd._load_fixture(name)
        assert tag == jtag
        np.testing.assert_array_equal(a.indptr, ja.indptr)
        np.testing.assert_array_equal(a.indices, ja.indices)
        np.testing.assert_array_equal(a.data, ja.data)


def test_quick_passes_and_writes_only_to_out(tmp_path, monkeypatch, capsys):
    summary = os.path.join(REPO, "docs", "pdtest_summary.json")
    before = os.stat(summary).st_mtime_ns
    monkeypatch.chdir(tmp_path)
    assert pdtest.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "All tests for DGS driver passed the threshold (    48 tests run)" \
        in out
    assert "@poisson2d(20) 1x2 s=3 equil=1 rowperm=0" in out
    assert os.listdir(tmp_path) == []
    assert os.stat(summary).st_mtime_ns == before


def test_travis_runs_the_ports_examples_and_out_writes(tmp_path, capsys):
    path = tmp_path / "summary.json"
    assert pdtest.main(["--quick", "--nrhs", "1", "--device", "cpu",
                        "--travis", "--out", str(path)]) == 0
    out = capsys.readouterr().out
    for ex in pdtest.TRAVIS:
        assert f"[pdtest] example {ex}: ok" in out
    rec = json.loads(path.read_text())
    assert rec["grids"] == ["1x1", "1x2"] and rec["device"] == "cpu"
    assert rec["summary"] == {"DGS": {"nfail": 0, "nrun": 24 + 4},
                              "ZGS": {"nfail": 0, "nrun": 1}}
    assert {r["grid"] for r in rec["rows"]} == {"1x1", "1x2"}
    assert [e["example"] for e in rec["examples"]] == list(pdtest.TRAVIS)
