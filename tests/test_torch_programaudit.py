"""The port's runtime program audits (utils/programaudit.py,
analysis/program.py) on the CPU, each held against the JAX package's
twin (superlu_dist_tpu/utils/programaudit.py, analysis/program.py).

* Per rule, an injected fault and its clean twin on the analogous
  program in both packages — a jitted program walked as a jaxpr there, a
  torch program walked on fake tensors here: SLU111 (a dead 1 MiB
  argument not donated / copied out of place), SLU112 (a closure's
  512 KiB array), SLU114 (an axis off the mesh; ranks that differ — two
  gloo ranks, both raising), SLU115 (an f64 -> f32 convert feeding an add;
  the bf16 GEMM-input pattern clean), SLU116 (a bf16 product without
  float32 accumulation), SLU119 (a gathered 1 MiB), SLU121 (a chain of
  elementwise ops priced by a hand count, and the budget either side).
* The executors' audits on one plan in both packages: stream, fused,
  mega and the device solve clean at every site; mega's budget error
  naming its rung; the off path allocating nothing; fronts and x the
  same with the knobs on and off; and the fake-CUDA walk — every group
  and sweep program of a plan on ``device="cuda"`` fake tensors through
  the kernels' fake implementations, here on a host without a card.

Inputs are the gallery's and numpy's, made from seeds.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from superlu_dist_tpu.analysis import program as jprogram
from superlu_dist_tpu.analysis import rules_program as jrules_program
from superlu_dist_tpu.analysis import rules_sharding as jrules_sharding
from superlu_dist_tpu.models.gallery import poisson2d as jpoisson2d
from superlu_dist_tpu.numeric import stream as jstream
from superlu_dist_tpu.numeric.factor import (
    numeric_factorize as jax_numeric_factorize)
from superlu_dist_tpu.numeric.plan import build_plan as jax_build_plan
from superlu_dist_tpu.obs import flightrec as jflightrec
from superlu_dist_tpu.obs.compilestats import COMPILE_STATS
from superlu_dist_tpu.ordering.dispatch import get_perm_c as jax_get_perm_c
from superlu_dist_tpu.solve.device import DeviceSolver as JaxDeviceSolver
from superlu_dist_tpu.sparse.formats import (
    symmetrize_pattern as jax_symmetrize)
from superlu_dist_tpu.symbolic.symbfact import (
    symbolic_factorize as jax_symbolic)
from superlu_dist_tpu.utils import errors as jerrors
from superlu_dist_tpu.utils import programaudit as jpa
from superlu_dist_tpu.utils.options import Options as JaxOptions

from superlu_dist_tpu_torch.analysis import program
from superlu_dist_tpu_torch.analysis import rules_program
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.numeric import factor, kernels
from superlu_dist_tpu_torch.ops import dense
from superlu_dist_tpu_torch.parallel.grid import ProcessGrid
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import errors
from superlu_dist_tpu_torch.utils import programaudit as pa
from superlu_dist_tpu_torch.utils.options import KNOB_REGISTRY

import torch_mesh_cases as cases

BIG = 1 << 30            # a threshold the rule not under test never meets
MIB = 1 << 20
KNOBS = ("SLU_TPU_VERIFY_PROGRAMS", "SLU_TPU_VERIFY_DTYPES",
         "SLU_TPU_VERIFY_SHARDING", "SLU_TPU_MEM_BUDGET_BYTES")
FAKE_CUDA = torch.device("cuda", 0)
ON = dict(SLU_TPU_VERIFY_PROGRAMS=1, SLU_TPU_VERIFY_DTYPES=1,
          SLU_TPU_VERIFY_SHARDING=1)


@pytest.fixture
def knobs(monkeypatch):
    """Every knob unset and both packages' auditors (and the JAX census
    notes) fresh; ``knobs(**env)`` sets some; all undone afterwards."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    pa._reset()
    jpa._reset()
    with COMPILE_STATS._lock:
        saved = dict(COMPILE_STATS._audits)
        COMPILE_STATS._audits = {}

    def on(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        pa._reset()
        jpa._reset()
    yield on
    pa._reset()
    jpa._reset()
    with COMPILE_STATS._lock:
        COMPILE_STATS._audits = saved


def _rng(seed=0):
    return np.random.default_rng(seed)


def _port_spec(fn, args, **kw):
    return program.trace_spec(fn, args, label=kw.pop("label", "p"),
                              site=kw.pop("site", "test"), **kw)


def _jax_spec(fn, args, **kw):
    return jprogram.trace_spec(fn, args, label=kw.pop("label", "p"),
                               site=kw.pop("site", "test"), **kw)


def _rules(findings):
    return [f.rule for f in findings]


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", KNOBS)
def test_knob_kind_and_default_are_the_jax_packages(name):
    from superlu_dist_tpu.utils.options import KNOB_REGISTRY as JREG
    mine, ref = KNOB_REGISTRY[name], JREG[name]
    assert (mine.kind, mine.default, mine.group) == \
        (ref.kind, ref.default, ref.group)
    assert "SLU12" in mine.help or "SLU11" in mine.help


@pytest.mark.parametrize("name", ["ProgramAuditError", "PrecisionAuditError",
                                  "ShardingAuditError", "MemoryBudgetError"])
def test_errors_carry_the_jax_fields(name, tmp_path, monkeypatch):
    from superlu_dist_tpu_torch.analysis.core import Finding
    from superlu_dist_tpu_torch.obs import flightrec
    monkeypatch.setenv("SLU_TPU_FLIGHTREC", str(tmp_path / "fr-%p.json"))
    flightrec._reset()
    try:
        f = Finding("SLU121", "<program:s[l]>", 0, 1, "m")
        kw = dict(peak_bytes=9, budget_bytes=4) \
            if name == "MemoryBudgetError" else {}
        err = getattr(errors, name)(site="s", program="l", findings=[f],
                                    **kw)
        ref = getattr(jerrors, name)(site="s", program="l", findings=[f],
                                     **kw)
    finally:
        flightrec._reset()
        # the JAX error latched the JAX recorder on this test's path:
        # later tests in the process must not dump into it
        jflightrec._reset()
    for k in ("site", "program", "rules") + tuple(kw):
        assert getattr(err, k) == getattr(ref, k)
    assert err.flightrec_dump and os.path.exists(err.flightrec_dump)
    # the JAX hierarchy: siblings, the budget error a sharding error
    assert isinstance(err, errors.ShardingAuditError) == isinstance(
        ref, jerrors.ShardingAuditError)
    assert isinstance(err, errors.ProgramAuditError) == isinstance(
        ref, jerrors.ProgramAuditError)


def test_audit_metrics_against_jax(knobs):
    """With metrics on, an audit counts in the JAX package's series:
    ``slu_{program,precision,sharding}_audit_total{site, result}``."""
    from superlu_dist_tpu.obs import metrics as jmetrics
    from superlu_dist_tpu_torch.obs import metrics as pmetrics
    jprev = jmetrics.install(jmetrics.Metrics())
    pprev = pmetrics.install(pmetrics.Metrics())
    try:
        knobs(**ON)
        jpa.maybe_audit("test.site", "m", jax.jit(lambda v: v * 2.0),
                        (np.zeros(4),))
        pa.maybe_audit("test.site", "m", lambda v: v * 2.0,
                       (torch.zeros(4),))
        jsnap = jmetrics.get_metrics().snapshot()["counters"]
        psnap = pmetrics.get_metrics().snapshot()["counters"]
    finally:
        jmetrics.install(jprev)
        pmetrics.install(pprev)
    names = {k: v for k, v in psnap.items() if "_audit_total" in k}
    assert len(names) == 3 and set(names.values()) == {1.0}
    assert names == {k: v for k, v in jsnap.items() if "_audit_total" in k}


def test_program_rules_in_the_catalog():
    from superlu_dist_tpu_torch.analysis import default_rules
    ids = {r.rule_id for r in default_rules()}
    assert {"SLU111", "SLU112", "SLU114", "SLU119", "SLU121"} <= ids


# --------------------------------------------------------------------------
# SLU111 — a dead argument
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [True, False])
def test_slu111_dead_argument_against_jax(fault):
    x = _rng().standard_normal(MIB // 8)           # 1 MiB of float64
    jf = jax.jit(lambda v: v + 1.0, donate_argnums=() if fault else (0,))
    jfind, jstats = jprogram.audit_spec(
        _jax_spec(jf, (x,), dead=(0,)), MIB, BIG)
    pf = (lambda v: v + 1.0) if fault else (lambda v: v.add_(1.0))
    pfind, pstats = program.audit_spec(
        _port_spec(pf, (torch.as_tensor(x),), dead=(0,)), MIB, BIG)
    assert _rules(pfind) == _rules(jfind) == (["SLU111"] if fault else [])
    assert pstats["inplace_coverage_pct"] == \
        jstats["donation_coverage_pct"] == (0.0 if fault else 100.0)
    assert pstats["dead_bytes"] == jstats["dead_bytes"] == MIB


def test_slu111_small_live_and_gathered_arguments_exempt():
    x = torch.zeros(4, dtype=torch.float64)           # dead but tiny
    y = torch.zeros(MIB // 8, dtype=torch.float64)    # big but live
    idx = torch.arange(MIB // 8)
    spec = _port_spec(lambda a, b, i: (a * 2.0, b * 3.0, b[i]), (x, y, idx),
                      dead=(0,))
    assert program.audit_spec(spec, MIB, BIG)[0] == []
    # a gather of a dead argument is not a copy of it
    spec = _port_spec(lambda b, i: b[i], (y, idx), dead=(0,))
    assert program.audit_spec(spec, MIB, BIG)[0] == []


# --------------------------------------------------------------------------
# SLU112 — a baked tensor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [True, False])
def test_slu112_closure_captured_against_jax(fault):
    big = _rng(1).standard_normal(1 << 16)            # 512 KiB of float64
    x = np.zeros(1 << 16)
    jbig, pbig = jnp.asarray(big), torch.as_tensor(big)
    if fault:
        jspec = _jax_spec(jax.jit(lambda v: v + jbig), (x,))
        pspec = _port_spec(lambda v: v + pbig, (torch.as_tensor(x),))
    else:
        jspec = _jax_spec(jax.jit(lambda v, c: v + c), (x, big))
        pspec = _port_spec(lambda v, c: v + c, (torch.as_tensor(x), pbig))
    jfind, jstats = jprogram.audit_spec(jspec, BIG, 1 << 18)
    pfind, pstats = program.audit_spec(pspec, BIG, 1 << 18)
    assert _rules(pfind) == _rules(jfind) == (["SLU112"] if fault else [])
    assert pstats["baked_const_bytes"] == (big.nbytes if fault else 0)
    assert (jstats["baked_const_bytes"] >= big.nbytes) == fault


def test_slu112_error_names_the_capturing_site():
    pbig = torch.arange(1 << 16, dtype=torch.float64)
    aud = pa.ProgramAuditor(inplace_min_bytes=BIG, const_max_bytes=1 << 18)
    with pytest.raises(errors.ProgramAuditError) as ei:
        aud.check(_port_spec(lambda v: v + pbig,
                             (torch.zeros(1 << 16, dtype=torch.float64),),
                             site="stream.group_step", label="captured"))
    assert "capturing build site" in str(ei.value)
    assert "factor.py" in str(ei.value)
    assert ("stream.group_step", "captured") not in aud.audited


# --------------------------------------------------------------------------
# SLU114 — collective lockstep
# --------------------------------------------------------------------------

def test_slu114_off_axis_against_jax_stub():
    class Prim:
        name = "psum"

    class Eqn:
        primitive = Prim()
        params = {"axes": ("ghost",)}

    class Closed:
        jaxpr = type("J", (), {"eqns": [Eqn()]})()
        consts = ()
        in_avals = ()

    jfind = jrules_program.audit_collective_lockstep(jprogram.ProgramSpec(
        label="stub", site="test", jaxpr=Closed(), mesh_axes=("x",)))
    pspec = program.ProgramSpec(
        label="stub", site="test", mesh_axes=program.GRID_AXES,
        collectives=[program.CollectiveRec("all_reduce", ("ghost",), 8)])
    pfind = rules_program.audit_collective_lockstep(pspec)
    assert _rules(pfind) == _rules(jfind) == ["SLU114"]
    assert "ghost" in pfind[0].message and "ghost" in jfind[0].message
    pspec.collectives = [program.CollectiveRec("all_reduce",
                                               program.GRID_AXES, 8)]
    assert rules_program.audit_collective_lockstep(pspec) == []


def _stand_in_grid(nprow=1, npcol=2):
    """A ProcessGrid value for walks only: its collectives are recorded
    by the walk's stand-in, never sent."""
    return ProcessGrid(nprow=nprow, npcol=npcol, rank=0,
                       device=torch.device("cpu"), backend="gloo")


def test_slu114_walk_records_the_grid_axes():
    grid = _stand_in_grid(2, 2)

    def prog(t, g):
        r = g.all_reduce_row(t)
        g.bcast_row(r, 1, tuple(t.shape), t.dtype)
        g.exchange(t.reshape(-1), [4, 4, 4, 4], [2, 2, 2, 2])
        return g.all_gather(r, axis="snode")

    spec = _port_spec(prog, (torch.zeros((4, 4)), grid))
    assert spec.collective_sequence() == [
        ("all_reduce_row", ("panel",)), ("bcast_row", ("panel",)),
        ("exchange", ("snode", "panel")), ("all_gather", ("snode",))]
    assert spec.mesh_axes == program.GRID_AXES and spec.grid is grid
    assert rules_program.audit_collective_lockstep(spec) == []


@pytest.mark.parametrize("diverge", [True, False])
def test_slu114_rank_divergence_raises_on_both_ranks(diverge):
    out = run_mesh_ranks(2, cases.audit_divergence, diverge, timeout=120.0,
                         env={"SLU_TPU_VERIFY_PROGRAMS": "1"})
    for r in (0, 1):
        if diverge:
            assert out[r]["error"] == "ProgramAuditError", out[r]
            assert out[r]["rules"] == ["SLU114"]
            assert "DIVERGENT" in out[r]["message"]
        else:
            assert out[r]["error"] is None, out[r]
            assert out[r]["stats"]["findings"] == 0
    if not diverge:
        assert out[0]["stats"]["digest"] == out[1]["stats"]["digest"]


# --------------------------------------------------------------------------
# SLU115 / SLU116 — precision
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [True, False])
def test_slu115_narrowing_against_jax(fault):
    a = _rng(2).standard_normal((16, 16))
    b = _rng(3).standard_normal((16, 16))
    if fault:        # f64 -> f32 feeding an add
        jspec = _jax_spec(jax.jit(lambda v: v.astype(jnp.float32) + 1.0),
                          (a,))
        pspec = _port_spec(lambda v: v.to(torch.float32) + 1.0,
                           (torch.as_tensor(a),))
    else:            # the bf16 GEMM-input pattern, f32 accumulate
        jspec = _jax_spec(jax.jit(lambda u, v: jnp.dot(
            u.astype(jnp.bfloat16), v.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)),
            (a.astype(np.float32), b.astype(np.float32)))
        pspec = _port_spec(
            lambda u, v: dense.gemm(u, v, "bf16"),
            (torch.as_tensor(a, dtype=torch.float32)[None],
             torch.as_tensor(b, dtype=torch.float32)[None]))
    jfind, _ = jprogram.audit_dtypes(jspec)
    pfind, pstats = program.audit_dtypes(pspec)
    assert _rules(pfind) == _rules(jfind) == (["SLU115"] if fault else [])
    assert pstats["n_narrowing"] >= 1


def test_slu115_bf16_card_route_clean():
    """ops/dense._bf16_gemm on the card: bf16 inputs, one bmm with
    out_dtype float32 — walked on fake CUDA tensors."""
    a = torch.as_tensor(_rng(4).standard_normal((2, 8, 8)),
                        dtype=torch.float32)
    spec = _port_spec(lambda u, v: dense.gemm(u, v, "bf16"), (a, a),
                      device=FAKE_CUDA)
    findings, stats = program.audit_dtypes(spec)
    assert findings == [] and stats["n_narrowing"] == 2
    if dense.BF16_ROUTE == "bmm_out_dtype":
        assert "aten.bmm.dtype" in {o.op for o in spec.ops}


@pytest.mark.parametrize("fault", [True, False])
def test_slu116_bf16_accumulation_against_jax(fault):
    a = _rng(5).standard_normal((8, 8)).astype(np.float32)
    jb = jnp.asarray(a, dtype=jnp.bfloat16)
    pb = torch.as_tensor(a).to(torch.bfloat16)
    if fault:
        jspec = _jax_spec(jax.jit(lambda u, v: jnp.dot(u, v)), (jb, jb))
        pspec = _port_spec(lambda u, v: torch.matmul(u, v), (pb, pb))
    else:
        jspec = _jax_spec(jax.jit(lambda u, v: jnp.dot(
            u, v, preferred_element_type=jnp.float32)), (jb, jb))
        pspec = _port_spec(
            lambda u, v: torch.bmm(u[None], v[None], out_dtype=torch.float32),
            (pb, pb), device=FAKE_CUDA)
    jfind, _ = jprogram.audit_dtypes(jspec)
    pfind, pstats = program.audit_dtypes(pspec)
    assert _rules(pfind) == _rules(jfind) == (["SLU116"] if fault else [])
    assert pstats["n_matmuls"] == 1


# --------------------------------------------------------------------------
# SLU119 / SLU121 — sharding and memory
# --------------------------------------------------------------------------

class _Aval:
    def __init__(self, shape, itemsize):
        self.shape = shape
        self.dtype = type("dt", (), {"itemsize": itemsize})()


@pytest.mark.parametrize("fault", [True, False])
def test_slu119_gather_against_jax(fault):
    rows = (MIB if fault else MIB // 4) // 2 // 8     # gathered over 2
    # the JAX rule on a stub all_gather of the same output bytes
    eqn = type("E", (), {
        "primitive": type("P", (), {"name": "all_gather"})(),
        "params": {"axis_name": "snode"}, "invars": [],
        "outvars": [type("V", (), {"aval": _Aval((2 * rows,), 8)})()]})()
    closed = type("C", (), {"jaxpr": type("J", (), {
        "eqns": [eqn], "invars": [], "outvars": []})(), "consts": ()})()
    jfind, jstats = jrules_sharding.audit_resharding(
        jprogram.ProgramSpec(label="stub", site="test", jaxpr=closed,
                             mesh_axes=("snode",)), MIB)
    spec = _port_spec(lambda t, g: g.all_gather(t),
                      (torch.zeros(rows, dtype=torch.float64),
                       _stand_in_grid()))
    pfind, pstats = program.audit_sharding(spec, MIB)
    assert _rules(pfind) == _rules(jfind) == (["SLU119"] if fault else [])
    assert pstats["replicated_bytes"] == jstats["replicated_bytes"] \
        == 2 * rows * 8


_JAX_SPMD = r"""
import json, os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax
jax.config.update("jax_enable_x64", True)
from superlu_dist_tpu.drivers.gssvx import analyze
from superlu_dist_tpu.models.gallery import poisson3d
from superlu_dist_tpu.numeric.factor import numeric_factorize
from superlu_dist_tpu.parallel.grid import gridinit
from superlu_dist_tpu.utils.errors import ShardingAuditError
from superlu_dist_tpu.utils.options import Options
lu, bvals, _ = analyze(Options(), poisson3d(14))
try:
    numeric_factorize(lu.plan, bvals, lu.anorm, executor="spmd",
                      mesh=gridinit(1, 2).mesh)
    print(json.dumps("clean"))
except ShardingAuditError as e:
    print(json.dumps(e.rules))
"""


def test_a_peer_finding_raises_on_every_rank():
    """Every audit on, an SLU115 finding on rank 0 only: both ranks
    raise PrecisionAuditError for it (rank 1 through the exchange)."""
    out = run_mesh_ranks(2, cases.audit_peer_finding, timeout=120.0)
    for r in (0, 1):
        assert out[r] == {"error": "PrecisionAuditError",
                          "rules": ["SLU115"]}, out[r]


def test_slu119_spmd_gathers_against_jax():
    """The spmd factorization of poisson3d(14) on two ranks under the
    sharding audit: the port gathers each group's pivot and Schur blocks
    in one ``gather_rows``, the JAX package its panels and Schur blocks in
    three ``all_gather``s — both deliver a buffer of at least 1 MiB to
    every rank there, and both flag SLU119 (at (13) both are clean)."""
    import json
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", _JAX_SPMD],
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                SLU_TPU_VERIFY_SHARDING="1"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = run_mesh_ranks(2, cases.spmd_sharding_verdict, 14, timeout=240.0,
                         env={"SLU_TPU_VERIFY_SHARDING": "1"})
    assert out[0] == out[1] == json.loads(r.stdout.splitlines()[-1]) \
        == ["SLU119"]


def test_slu121_chain_against_jax_and_hand_counts(knobs):
    """((x + 1) * 2) - 3 on a 1 MiB float64 x.  JAX's jaxpr walk frees
    each value after its last use: x and the first sum, then one live
    value beside the next — 2 MiB.  Torch's eager lifetimes: the caller
    keeps x alive throughout, and each temporary lives until the next op
    returns — x, the sum and the product at the multiply: 3 MiB."""
    x = _rng(6).standard_normal(MIB // 8)
    jspec = _jax_spec(jax.jit(lambda v: ((v + 1.0) * 2.0) - 3.0), (x,))
    pspec = _port_spec(lambda v: ((v + 1.0) * 2.0) - 3.0,
                       (torch.as_tensor(x),))
    assert jprogram.audit_sharding(jspec, MIB)[1]["peak_bytes_est"] \
        == 2 * MIB
    assert program.audit_sharding(pspec, MIB)[1]["peak_bytes_est"] \
        == 3 * MIB
    jf = jax.jit(lambda v: ((v + 1.0) * 2.0) - 3.0)

    def pf(v):
        return ((v + 1.0) * 2.0) - 3.0
    tx = torch.as_tensor(x)
    for budget, raises in ((MIB + MIB // 2, True), (4 * MIB, False)):
        knobs(SLU_TPU_MEM_BUDGET_BYTES=budget)
        if raises:
            with pytest.raises(jerrors.MemoryBudgetError) as je:
                jpa.maybe_audit("test", "chain", jf, (x,))
            with pytest.raises(errors.MemoryBudgetError) as pe:
                pa.maybe_audit("test", "chain", pf, (tx,))
            assert pe.value.rules == je.value.rules == ["SLU121"]
            assert pe.value.budget_bytes == je.value.budget_bytes == budget
            assert "add" in str(pe.value) or "mul" in str(pe.value)
        else:
            assert jpa.maybe_audit("test", "chain", jf, (x,))[
                "findings"] == 0
            assert pa.maybe_audit("test", "chain", pf, (tx,))[
                "findings"] == 0


def test_kernel_scratch_counts_in_the_peak():
    """The panel LU op's fake implementation allocates the kernel's
    snapshot (B, pa, pb + 2): the walk counts it live at the op."""
    panel = torch.zeros((3, 40, 32), dtype=torch.float32)
    flags = torch.zeros((3, 32), dtype=torch.int32)
    thresh = torch.tensor(1e-3, dtype=torch.float32)
    spec = _port_spec(lambda p, t, f: kernels.panel_lu_(p, 0, 32, t, f),
                      (panel, thresh, flags), device=FAKE_CUDA)
    (op,) = spec.ops
    assert op.op == "slu.panel_lu.default" and op.writes == (0, 2)
    assert op.outputs[0].shape == (3, 32, 34) and op.fresh == (0,)
    assert spec.peak_bytes == spec.args_bytes + 3 * 32 * 34 * 4


# --------------------------------------------------------------------------
# the executors on one plan, in both packages
# --------------------------------------------------------------------------

def _plans(nx):
    a = jpoisson2d(nx)
    sym = jax_symmetrize(a)
    sf = jax_symbolic(sym, jax_get_perm_c(JaxOptions(), a, sym))
    jplan = jax_build_plan(sf)
    return jplan, plan_from_reference(jplan), sym.data[sf.value_perm], \
        a.norm_max()


@pytest.fixture(scope="module")
def p7():
    return _plans(7)


def test_executor_audits_clean_in_both(knobs, p7, monkeypatch):
    jplan, plan, vals, anorm = p7
    knobs(**ON)
    monkeypatch.setattr(jstream, "_CENSUSED_KEYS", set())
    for ex in ("stream", "fused", "mega"):
        jnum = jax_numeric_factorize(jplan, vals, anorm, executor=ex)
    for fused in (True, False):
        ds = JaxDeviceSolver(jnum, fused=fused)
        ds.solve(np.ones((jplan.n, 3)))
        ds.solve_trans(np.ones(jplan.n))
    jblk = COMPILE_STATS.audit_block()
    assert jblk["findings"] == 0 and jblk["programs"] > 0
    for ex in ("stream", "fused", "mega"):
        num = factor.numeric_factorize(plan, vals, anorm, device="cpu",
                                       executor=ex)
    ds = DeviceSolver(num, fused=False)
    ds.solve(np.ones((plan.n, 3)))
    ds.solve_trans(np.ones(plan.n))
    blk = pa.audit_block()
    assert blk["findings"] == 0
    assert blk["inplace_coverage_pct"] == 100.0
    assert blk["baked_const_bytes"] == 0 and blk["replicated_bytes"] == 0
    assert set(blk["sites"]) == {"stream.group_step", "fused.run_groups",
                                 "mega.group_step", "device._sweep"}
    assert blk["programs_audited"] == blk["programs_dtypes_audited"] \
        == blk["programs_sharding_audited"] == blk["programs"]
    assert blk["peak_bytes_est"] > 0 and blk["seconds"] > 0


def test_mega_budget_names_the_rung_in_both(knobs):
    jplan, plan, vals, anorm = _plans(8)
    knobs(SLU_TPU_MEM_BUDGET_BYTES=4096)
    with pytest.raises(jerrors.MemoryBudgetError) as je:
        jax_numeric_factorize(jplan, vals, anorm, executor="mega")
    with pytest.raises(errors.MemoryBudgetError) as pe:
        factor.numeric_factorize(plan, vals, anorm, device="cpu",
                                 executor="mega")
    assert je.value.site == "mega._kernel"
    assert pe.value.site == "mega.group_step"
    assert " P" in je.value.program and " P" in pe.value.program
    assert pe.value.peak_bytes > 4096 == pe.value.budget_bytes


def test_off_path_allocates_nothing(knobs, p7):
    jplan, plan, vals, anorm = p7
    jax_numeric_factorize(jplan, vals, anorm, executor="fused")
    factor.numeric_factorize(plan, vals, anorm, device="cpu",
                             executor="stream")
    assert jpa._AUDITOR is None and jpa.get_auditor() is None
    for get in (pa.get_auditor, pa.get_dtype_auditor,
                pa.get_sharding_auditor):
        assert get() is None
    assert (pa._AUDITOR, pa._DTYPE_AUDITOR, pa._SHARDING_AUDITOR) == \
        (None, None, None)
    assert pa.maybe_audit("test", "off", None, ()) is None


def test_knobs_on_and_off_give_the_same_bits(knobs):
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    a = poisson3d(6)
    b = a.matvec(_rng(7).standard_normal(a.n_rows))
    x0, lu0, _, _ = slt.gssvx(slt.Options(executor="stream"), a, b,
                              device="cpu")
    knobs(**ON, SLU_TPU_MEM_BUDGET_BYTES=int(80e9))
    x1, lu1, _, _ = slt.gssvx(slt.Options(executor="stream"), a, b,
                              device="cpu")
    assert np.array_equal(x0, x1)
    assert all(torch.equal(p, q) and torch.equal(r, s)
               for (p, r), (q, s) in zip(lu0.numeric.fronts,
                                         lu1.numeric.fronts))
    assert pa.audit_block()["programs"] > 0


def test_fake_cuda_walk_of_a_plans_programs(knobs, p7):
    """Every group program of poisson2d(7)'s plan, and its sweeps, on
    device="cuda" fake tensors: the kernels' fake implementations, the
    TF32 branch, no launch — on a host without a card."""
    _, plan, vals, anorm = p7
    knobs(**ON, SLU_TPU_MEM_BUDGET_BYTES=int(80e9))
    maps = factor.upload_maps(plan, torch.device("cpu"))
    avals = torch.as_tensor(vals, dtype=torch.float32)
    pool = torch.zeros(plan.pool_size, dtype=torch.float32)
    thresh = torch.tensor(1e-4, dtype=torch.float32)
    before = dict(kernels.LAUNCHES)
    seen = set()
    for gi, g in enumerate(plan.groups):
        dims = (g.batch, g.m, g.w, g.u)
        fn = functools.partial(factor.group_step, dims, gemm_prec="default")
        spec = program.trace_spec(fn, (avals, pool, thresh, maps[gi]),
                                  label=f"g{gi}", site="stream.group_step",
                                  dead=(1,), device=FAKE_CUDA)
        assert {t.dtype for op in spec.ops for t in op.outputs
                if t.dtype.is_floating_point} == {torch.float32}
        seen |= {op.op for op in spec.ops}
        stats = pa.maybe_audit("stream.group_step", f"g{gi}", fn,
                               (avals, pool, thresh, maps[gi]), dead=(1,),
                               device=FAKE_CUDA)
        assert stats["findings"] == 0
    assert {"slu.front_assemble.default", "slu.panel_lu.default"} <= seen
    # the sweeps of a solver on the same plan, on fakes of the card
    num = factor.numeric_factorize(plan, vals, anorm, dtype=torch.float32,
                                   device="cpu", executor="stream")
    ds = DeviceSolver(num, fused=False)
    x = torch.zeros((plan.n + 1, 2), dtype=torch.float32)
    for direction in ("fwd", "bwd"):
        for mode in ("N", "T"):
            stats = pa.maybe_audit(
                "device._sweep", f"{direction}{mode}",
                functools.partial(ds._sweep, direction, mode),
                (x, torch.zeros_like(x), ds._state(mode)), dead=(0, 1),
                device=FAKE_CUDA)
            assert stats["findings"] == 0
    assert kernels.LAUNCHES == before
    assert pa.audit_block()["findings"] == 0


def test_grid_audit_on_gloo_ranks():
    """The 2-D executor's group programs audited on two gloo ranks: clean,
    the same digests on both, fronts bit for bit the un-audited FACT's."""
    out = run_mesh_ranks(2, cases.audited_grid_fact, 6, timeout=180.0)
    assert out[0]["digests"] == out[1]["digests"] and out[0]["digests"]
    for r in (0, 1):
        assert out[r]["findings"] == 0 and out[r]["equal"], out[r]
        assert set(out[r]["sites"]) == {"mesh-stream._group"}
