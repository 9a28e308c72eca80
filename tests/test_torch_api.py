"""The port's small user API and knobs, each held against the JAX
package: ``get_version_number`` / ``__version__``, ``YesNo``,
``set_default_options``, ``numeric/factor.factor_flops``, the MFU
denominator (``utils/peaks.py``: ``SLU_TPU_PEAK_GFLOPS``, the H100
data-sheet table, the calibration) and ``SLU_TPU_PROGRESS`` (the stream's
progress lines)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import superlu_dist_tpu as jslu
from superlu_dist_tpu.numeric import factor as jfactor
from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
from superlu_dist_tpu.utils import peaks as jpeaks
from superlu_dist_tpu.utils import options as joptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch import utils as tutils
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.numeric.mega import MegaExecutor
from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
from superlu_dist_tpu_torch.utils import options, peaks


def test_version_number_is_the_jax_packages():
    assert slt.get_version_number() == jslu.get_version_number()
    assert slt.__version__ == jslu.__version__
    assert all(isinstance(x, int) for x in slt.get_version_number())


def test_yes_no_and_set_default_options():
    assert [(m.name, m.value) for m in slt.YesNo] == \
        [(m.name, m.value) for m in joptions.YesNo]
    assert slt.set_default_options() == slt.Options()
    assert slt.set_default_options() is not slt.set_default_options()
    # exported where the JAX package exports them
    for name in ("Options", "Fact", "ColPerm", "RowPerm", "IterRefine",
                 "Trans", "YesNo", "set_default_options", "Stats",
                 "SuperLUError", "SingularMatrixError"):
        assert hasattr(tutils, name), name
    assert tutils.set_default_options is options.set_default_options


def _plan():
    from test_parallel import _plan as jplan
    plan, avals, thresh = jplan()
    return plan, np.asarray(avals), float(thresh)


def test_factor_flops_is_the_jax_count():
    jplan, _, _ = _plan()
    plan = plan_from_reference(jplan)
    assert factor.factor_flops(plan) == jfactor.factor_flops(jplan)
    assert factor.factor_flops(plan) == plan.flops > 0


def test_mfu_under_the_env_peak_matches_jax(monkeypatch):
    monkeypatch.setenv("SLU_TPU_PEAK_GFLOPS", "1000")
    for tier in ("bf16", "default", "f32", "highest"):
        assert peaks.mfu_pct(12.5, tier) == jpeaks.mfu_pct(12.5, tier)
        assert peaks.detect_peak_gflops(tier) == (1000.0, "env")
    assert peaks.mfu_pct(0.0123456, "default")[0] == \
        round(100.0 * 0.0123456 / 1000.0, 4)


@pytest.mark.parametrize("name,sxm", [("NVIDIA H100 80GB HBM3", True),
                                      ("NVIDIA H100 PCIe", False)])
def test_h100_table_is_the_data_sheet(name, sxm):
    want = ({"bf16": 989_400.0, "default": 494_700.0, "f32": 67_000.0,
             "highest": 67_000.0, "float64": 67_000.0} if sxm else
            {"bf16": 756_000.0, "default": 378_000.0, "f32": 51_000.0,
             "highest": 51_000.0, "float64": 51_000.0})
    for tier, gflops in want.items():
        assert peaks.table_peak_gflops(name, tier) == gflops
    # no TPU figure is carried over
    assert peaks.table_peak_gflops("TPU v5e", "bf16") is None


def test_cpu_peak_is_measured(monkeypatch):
    monkeypatch.delenv("SLU_TPU_PEAK_GFLOPS", raising=False)
    peak, src = peaks.detect_peak_gflops("default", backend="cpu")
    assert peak > 0 and src == "measured:cpu"
    pct, p, s = peaks.mfu_pct(peak / 100.0, "default", backend="cpu")
    assert pct > 0.0 and (p, s) == (peak, src)


def _lines(capsys, word):
    err = capsys.readouterr().err
    return [ln for ln in err.splitlines()
            if ln.startswith(f"[stream] issuing {word}")]


@pytest.mark.parametrize("k", [1, 2, 5])
def test_progress_prints_the_jax_line_count(monkeypatch, capsys, k):
    jplan, avals, thresh = _plan()
    plan = plan_from_reference(jplan)
    monkeypatch.setenv("SLU_TPU_PROGRESS", str(k))
    capsys.readouterr()
    JStream(jplan, "float64")(jnp.asarray(avals), jnp.asarray(thresh))
    want = _lines(capsys, "group")
    th = torch.tensor(thresh, dtype=torch.float64)
    av = torch.as_tensor(avals)
    StreamExecutor(plan, torch.float64, "cpu")(av, th)
    got = _lines(capsys, "group")
    assert len(got) == len(want) == -(-len(plan.groups) // k)
    assert [g.split(" (+")[0] for g in got] == \
        [w.split(" (+")[0] for w in want]
    MegaExecutor(plan, torch.float64, "cpu")(av, th)
    assert len(_lines(capsys, "group")) == len(want)
    # level granularity: one line a schedule wave, as the JAX levels
    JStream(jplan, "float64", granularity="level")(jnp.asarray(avals),
                                                   jnp.asarray(thresh))
    jl = _lines(capsys, "level")
    StreamExecutor(plan, torch.float64, "cpu", granularity="level")(av, th)
    assert _lines(capsys, "level") == jl and jl
    monkeypatch.setenv("SLU_TPU_PROGRESS", "0")
    StreamExecutor(plan, torch.float64, "cpu")(av, th)
    assert not _lines(capsys, "")
