"""The port's slulint (superlu_dist_tpu_torch/analysis/) held against the
JAX package's.

* The framework-neutral rules (SLU101/103/104/108/109/110/118) give the
  same (rule, line, col) as the JAX linter on its own fixtures
  (tests/fixtures/slulint/) and on the snippet sources of
  tests/test_analysis.py.
* The device and precision rules (SLU113/115/116) on torch
  transliterations of the JAX fixtures, line for line, give the (rule,
  line) the JAX linter gives on the originals.
* Port-only cases: the mesh tier's collectives in SLU101, the ops/
  exemption of SLU115, the torch spellings of the lattice, a host sync
  added to the stream executor's group loop.
* The CLI in a subprocess where jax cannot be imported; both linters
  over the port's tree; and the mesh tier's entry check on two gloo
  ranks.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

import superlu_dist_tpu.analysis as janalysis
import superlu_dist_tpu_torch.analysis as tanalysis
from superlu_dist_tpu.analysis.core import is_env_read
from superlu_dist_tpu.utils.options import KNOB_REGISTRY as JAX_KNOBS
from superlu_dist_tpu_torch.analysis import sarif
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils.options import KNOB_REGISTRY as PORT_KNOBS

import torch_mesh_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "slulint")
NEUTRAL = {"SLU101", "SLU103", "SLU104", "SLU108", "SLU109", "SLU110",
           "SLU118"}


def _neutral(mod):
    return [r for r in mod.default_rules() if r.rule_id in NEUTRAL]


def _snippets() -> dict:
    """The module-level string sources of tests/test_analysis.py, by
    name (read with ast: the module itself is not imported)."""
    with open(os.path.join(REPO, "tests", "test_analysis.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for st in tree.body:
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and st.targets[0].id.isupper() \
                and isinstance(st.value, ast.Constant) \
                and isinstance(st.value.value, str):
            out[st.targets[0].id] = st.value.value
    return out


def _fixtures() -> dict:
    return {name: open(os.path.join(FIXDIR, name)).read()
            for name in sorted(os.listdir(FIXDIR)) if name.endswith(".py")}


NEUTRAL_SOURCES = {**_fixtures(), **_snippets()}


def _same_registry_answer(source) -> bool:
    """True when every literal knob the source reads is registered in
    both packages' registries or in neither (SLU104 then has one
    answer)."""
    keys = {hit[0] for hit in map(is_env_read, ast.walk(ast.parse(source)))
            if hit is not None and hit[0]}
    return all((k in JAX_KNOBS) == (k in PORT_KNOBS) for k in keys)


def _keys(findings, rules=None, with_col=True):
    return sorted((f.rule, f.line, f.col) if with_col else (f.rule, f.line)
                  for f in findings if rules is None or f.rule in rules)


@pytest.mark.parametrize("name", sorted(NEUTRAL_SOURCES))
def test_neutral_rules_agree_with_jax(name):
    source = NEUTRAL_SOURCES[name]
    rules = set(NEUTRAL)
    if not _same_registry_answer(source):
        rules.discard("SLU104")
    want = _keys(janalysis.analyze_source(source, name,
                                          _neutral(janalysis)), rules)
    got = _keys(tanalysis.analyze_source(source, name,
                                         _neutral(tanalysis)), rules)
    assert got == want


def test_neutral_sources_cover_every_neutral_rule():
    """The agreement above is not vacuous: the JAX linter fires every
    neutral rule somewhere in the sources."""
    fired = set()
    for name, source in NEUTRAL_SOURCES.items():
        fired |= {f.rule for f in janalysis.analyze_source(
            source, name, _neutral(janalysis))}
    assert fired == NEUTRAL


# --------------------------------------------------------------------------
# torch transliterations of the JAX device / precision fixtures
# --------------------------------------------------------------------------

TORCH_FIXTURES = {
    "host_roundtrip_loop.py": '''\
"""slulint fixture: SLU113 host round-trips inside a dispatch loop.

The dispatch loop replays a captured CUDA graph per group and then
coerces the device result on the host EVERY iteration — a blocking D2H
round-trip per group that serializes the async dispatch stream.  The
device taint (dataflow lattice) must flag all three round-trip shapes:
float() coercion, np.asarray materialization, and the bool-coercion of
an `if` test on a device value.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _kernel(w):
    def step(x):
        return x * 2.0

    return capture(step, torch.ones(w, device="cuda"))


def dispatch(xs):
    out = []
    total = 0.0
    for x in xs:
        kern = _kernel(8)
        y = kern.replay()
        total += float(y[0])          # flagged: float() on device value
        host = np.asarray(y)          # flagged: implicit D2H per group
        if y[0] > 0:                  # flagged: bool-coercion of device test
            out.append(host)
    return out, total
''',
    "device_loop_clean.py": '''\
"""slulint fixture: the SLU113-clean twin of host_roundtrip_loop.py.

Same dispatch-loop shape, but the loop stays async: device results are
accumulated on the device, explicit syncs go through .cpu() /
torch.cuda.synchronize() (the sanctioned idiom — visibility is the
point), and all host coercions happen AFTER the loop.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _kernel(w):
    def step(x):
        return x * 2.0

    return capture(step, torch.ones(w, device="cuda"))


def dispatch(xs):
    ys = []
    for x in xs:
        kern = _kernel(8)
        y = kern.replay()
        ys.append(y)                          # stays async
        probe = y.cpu()                       # explicit sync: exempt
        if probe[0] > 0:                      # host value: clean
            ys[-1] = y
    total = float(np.asarray(ys[-1].cpu())[0])
    return ys, total
''',
    "narrowing_cast_flagged.py": '''\
"""SLU115 true-positive fixture (implicit downcast): a value-carrying
f32 panel is narrowed to bf16 and the narrowed tensor feeds a GEMM — the
compute dtype silently lost bits on the way to the tensor cores.  The
witness chain in the finding names both the cast line and the consumer."""
import torch


def schur_update(panel, piv):
    p32 = panel.to(torch.float32)
    lo = p32.to(torch.bfloat16)            # flagged: f32 -> bf16
    return gemm(lo, piv, "bf16")


def half_entry(vals, sel):
    # flagged even with no visible provenance: a 16-bit target is a
    # presumed downcast of the compute dtype
    return gemm(vals.half(), sel,
                "bf16")
''',
    "narrowing_cast_clean.py": '''\
"""SLU115 clean-negative fixture: widening casts and same-width
re-binds never narrow; a bf16 cast inside the sanctioned GEMM helper
(ops/dense.gemm is the ONE place the bf16 tier may narrow inputs) is
out of this rule's package scope by construction."""
import torch


def widen(panel, piv):
    p64 = panel.to(torch.float64)          # widening: never flagged
    return gemm(p64, piv, "highest")


def rebind(vals, sel):
    v = vals.float()
    w = v.to(torch.float32)                # same width: not a downcast
    return gemm(w, sel, "highest")
''',
    "pinned_accum_flagged.py": '''\
"""SLU116 true-positive fixture (unpinned tier): torch matmul-family
calls outside ops/dense.gemm run at whatever the global TF32 /
reduced-precision flags say at that moment — on the card that can be
TF32 products, silently costing the Schur updates their f32 sums."""
import torch
import numpy as np


def schur(l21, u12):
    return torch.matmul(l21, u12)          # flagged: no ladder tier


def gather_sum(oh, child):
    return torch.einsum("ij,jk->ik", oh,   # flagged: no ladder tier
                        child)


def fold(vals, seg):
    import torch
    return torch.bmm(vals, seg)            # flagged: no ladder tier
''',
    "pinned_accum_clean.py": '''\
"""SLU116 clean-negative fixture: every matmul-family product routes
through ops/dense.gemm, which pins the ladder tier; host-side numpy
contractions have no tier freedom and are exempt."""
import numpy as np
import torch
from superlu_dist_tpu_torch.ops.dense import gemm


def schur(l21, u12):
    return gemm(l21, u12, "highest")


def gather_sum(oh, child):
    return gemm(oh, child,
                "default")


def host_side(a, b):
    return np.matmul(a, b)                 # numpy: accumulates wide
''',
}


@pytest.mark.parametrize("name", sorted(TORCH_FIXTURES))
def test_torch_fixture_matches_jax_fixture(name):
    want = _keys(janalysis.analyze_paths([os.path.join(FIXDIR, name)]),
                 with_col=False)
    got = _keys(tanalysis.analyze_source(TORCH_FIXTURES[name], name,
                                         tanalysis.default_rules()),
                with_col=False)
    assert got == want
    # the pairs are a positive and a clean twin each
    assert bool(want) == ("flagged" in name or "roundtrip" in name)


def test_slu113_messages_name_the_device_source():
    fs = tanalysis.analyze_source(TORCH_FIXTURES["host_roundtrip_loop.py"],
                                  "fixture.py", tanalysis.default_rules())
    assert {f.rule for f in fs} == {"SLU113"}
    assert all("CUDA-graph replay" in f.message for f in fs)
    msgs = " ".join(f.message for f in fs)
    assert "`float()`" in msgs and "`np.asarray`" in msgs
    assert "bool-coercion" in msgs


# --------------------------------------------------------------------------
# port-only cases
# --------------------------------------------------------------------------

def _run(source, path="fixture.py"):
    return tanalysis.analyze_source(source, path, tanalysis.default_rules())


GRID_BRANCH = """
def ship(grid, t):
    if grid.rank == 0:
        t = grid.bcast_row(t, 0, t.shape, t.dtype)
    return t
"""


def test_slu101_flags_grid_collective_under_rank_branch():
    fs = _run(GRID_BRANCH)
    assert _keys(fs) == [("SLU101", 4, 13)]
    assert "rank-dependent control flow" in fs[0].message
    # the JAX linter's surface is TreeComm's alone
    assert janalysis.analyze_source(GRID_BRANCH, "fixture.py",
                                    janalysis.default_rules()) == []


GRID_EARLY_EXIT = """
def check(tc, grid, dev):
    if dev != grid.device:
        raise ValueError(dev)
    return tc.allreduce_sum_any(dev)
"""


def test_slu101_mesh_entry_check_shape():
    """The _pgssvx_mesh fault in small: a per-rank raise before the first
    collective is flagged when the test names the rank."""
    assert _run(GRID_EARLY_EXIT) == []
    src = GRID_EARLY_EXIT.replace("if dev != grid.device:",
                                  "if tc.rank != grid.rank:")
    assert _keys(_run(src)) == [("SLU101", 5, 12)]


def test_slu115_ops_is_exempt():
    src = TORCH_FIXTURES["narrowing_cast_flagged.py"]
    numeric = os.path.join("superlu_dist_tpu_torch", "numeric", "x.py")
    ops = os.path.join("superlu_dist_tpu_torch", "ops", "dense.py")
    assert _keys(_run(src, numeric), with_col=False) == [
        ("SLU115", 10), ("SLU115", 17)]
    assert _run(src, ops) == []


SYNCED_LOOP = """
import torch

def factor(groups, dev):
    tiny = torch.zeros((), dtype=torch.int64, device=dev)
    for g in groups:
        t = front_assemble_(g)
        tiny += t
        torch.cuda.synchronize()
        n = int(tiny)
        m = t.item()
    return n, m
"""


def test_slu113_explicit_sync_clears_the_device_taint():
    path = os.path.join("superlu_dist_tpu_torch", "numeric", "x.py")
    assert _run(SYNCED_LOOP, path) == []
    fs = _run(SYNCED_LOOP.replace("        torch.cuda.synchronize()\n", ""),
              path)
    assert _keys(fs, with_col=False) == [("SLU113", 9), ("SLU113", 10)]
    assert "kernel entry `front_assemble_" in fs[1].message
    # solve/ is in scope too; io/ is not
    assert _run(SYNCED_LOOP.replace("        torch.cuda.synchronize()\n",
                                    ""),
                os.path.join("superlu_dist_tpu_torch", "io", "x.py")) == []


COPIES = """
import numpy as np
import torch

def loop(xs, dev):
    host = torch.empty(8, pin_memory=True)
    for x in xs:
        up = torch.as_tensor(np.asarray(x)).to(dev)
        y = up * 2
        z = y.to(dev)
        host.copy_(y)
        y.cuda()
        w = y.to(torch.float64)
    return host
"""


def test_slu122_copies_of_device_values_in_a_loop():
    path = os.path.join("superlu_dist_tpu_torch", "numeric", "x.py")
    fs = _run(COPIES, path)
    # the host upload (line 8) and the dtype conversion (line 13) are not
    # copies of a device value between devices
    assert _keys(fs, with_col=False) == [
        ("SLU122", 10), ("SLU122", 11), ("SLU122", 12)]
    assert "into a host tensor" in fs[1].message


INDEX_TORCH = """
import torch

def build(counts, n, m):
    indptr = torch.cumsum(counts, 0, dtype=torch.int32)
    nnz = n.int() * m
    off = n.to(torch.int32)
    total = n.to(torch.int32).long()
    return indptr, nnz, off, total
"""


def test_slu103_torch_spellings():
    fs = _run(INDEX_TORCH)
    assert _keys(fs, with_col=False) == [
        ("SLU103", 5), ("SLU103", 6), ("SLU103", 7)]


LOCKED_SYNC = """
import threading
import torch

class Flusher:
    def __init__(self):
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()
        self._t = None

    def flush(self, dev):
        with self._lock:
            torch.cuda.synchronize(dev)
        self._done.wait()
"""


def test_slu109_wait_for_the_card_under_a_lock():
    fs = _run(LOCKED_SYNC)
    assert _keys(fs, with_col=False) == [("SLU109", 13)]
    assert "wait for the card" in fs[0].message


def _stream_sources():
    pkg = os.path.join(REPO, "superlu_dist_tpu_torch")
    return tanalysis.read_sources([os.path.join(pkg, "numeric"),
                                   os.path.join(pkg, "ops")])


def test_slu113_catches_a_sync_added_to_the_stream_group_loop():
    """The stream executor's group loop stays free of host syncs (the
    card's trace counts none in a FACT): an int() or .item() of the
    group's tiny count added to it is flagged, and an explicit sync
    before them clears it."""
    sources = _stream_sources()
    path = next(p for p in sources if p.endswith(
        os.path.join("numeric", "stream.py")))
    anchor = "                tiny += t\n"
    assert sources[path].count(anchor) == 1
    line = sources[path][:sources[path].index(anchor)].count("\n") + 1
    rules = [r for r in tanalysis.default_rules() if r.rule_id == "SLU113"]
    assert [f for f in tanalysis.analyze_sources(sources, rules)
            if f.path == path] == []
    added = ("                n_tiny = int(t)\n"
             "                t_host = t.item()\n")
    sources[path] = sources[path].replace(anchor, anchor + added)
    fs = [f for f in tanalysis.analyze_sources(sources, rules)
          if f.path == path]
    assert _keys(fs, with_col=False) == [("SLU113", line + 1),
                                         ("SLU113", line + 2)]
    sources[path] = sources[path].replace(
        anchor + added,
        anchor + "                torch.cuda.synchronize()\n" + added)
    assert [f for f in tanalysis.analyze_sources(sources, rules)
            if f.path == path] == []


# --------------------------------------------------------------------------
# the CLI, in a subprocess where jax cannot be imported
# --------------------------------------------------------------------------

_NO_JAX = """
import contextlib, io, json, sys
sys.modules["jax"] = None
sys.modules["superlu_dist_tpu"] = None
from superlu_dist_tpu_torch.analysis.__main__ import main
out = []
for step in json.loads(sys.argv[1]):
    if step[0] == "write":
        with open(step[1], "w") as fh:
            fh.write(step[2])
        continue
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            rc = main(step[1])
        except SystemExit as e:
            rc = e.code
    out.append({"rc": rc, "out": so.getvalue(), "err": se.getvalue()})
print(json.dumps(out))
assert "jax" not in {m.split(".")[0] for m in sys.modules
                     if sys.modules[m] is not None}
"""


def _cli_steps(steps, cwd=REPO):
    """Run CLI steps — ``("run", argv)`` through ``main(argv)`` or
    ``("write", path, text)`` — in ONE subprocess where jax and the JAX
    package cannot be imported; a list of {rc, out, err} per run."""
    r = subprocess.run([sys.executable, "-c", _NO_JAX, json.dumps(steps)],
                       capture_output=True, text=True, cwd=cwd,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return [type("Run", (), d) for d in json.loads(r.stdout)]


def test_cli_exit_codes_json_and_sarif(tmp_path):
    dirty = tmp_path / "dirty.py"
    dirty.write_text(INDEX_TORCH)
    clean = tmp_path / "clean.py"
    clean.write_text(TORCH_FIXTURES["pinned_accum_clean.py"])
    runs = _cli_steps([
        ("run", [str(clean), "--no-baseline"]),
        ("run", [str(dirty), "--no-baseline", "--json"]),
        ("run", [str(dirty), "--no-baseline", "--format", "sarif"]),
        ("run", ["--rules", "SLU102", str(clean)]),
        ("run", [str(tmp_path / "missing.py")]),
        ("run", ["--list-rules"]),
        ("run", ["--bogus-flag"])])
    r = runs[0]
    assert r.rc == 0, r.out + r.err
    assert "slulint: 0 finding(s) in 1 file(s)" in r.out
    r = runs[1]
    assert r.rc == 1, r.out + r.err
    doc = json.loads(r.out)
    assert [f["rule"] for f in doc["findings"]] == ["SLU103"] * 3
    r = runs[2]
    assert r.rc == 1, r.out + r.err
    sdoc = json.loads(r.out)
    driver = sdoc["runs"][0]["tool"]["driver"]
    assert driver["fullName"] == "superlu_dist_tpu_torch.analysis"
    assert {d["id"] for d in driver["rules"]} == {
        x.rule_id for x in tanalysis.default_rules()}
    back = sarif.from_sarif(sdoc)
    assert [(f.rule, f.path, f.line, f.col, f.message) for f in back] == [
        (f["rule"], f["path"], f["line"], f["col"], f["message"])
        for f in doc["findings"]]
    # unknown rule (SLU102 is the JAX package's), missing path, bad flag
    assert runs[3].rc == 2 and "SLU102" in runs[3].err
    assert runs[4].rc == 2 and "no such path" in runs[4].err
    assert runs[6].rc == 2
    r = runs[5]
    assert r.rc == 0
    assert [ln.split()[0] for ln in r.out.splitlines()] == [
        x.rule_id for x in tanalysis.default_rules()]


def test_cli_baseline_round_trip_and_cache(tmp_path):
    mod = str(tmp_path / "mod.py")
    bp = str(tmp_path / "b.json")
    cache = str(tmp_path / "cache.json")
    runs = _cli_steps([
        ("write", mod, INDEX_TORCH),
        ("run", [mod, "--baseline", bp, "--write-baseline"]),
        ("run", [mod, "--baseline", bp]),
        ("run", [mod, "--baseline", bp, "--no-baseline"]),
        # fixed: --update-baseline prunes; a new finding is never added
        ("write", mod, TORCH_FIXTURES["pinned_accum_clean.py"]),
        ("run", [mod, "--baseline", bp, "--update-baseline"]),
        ("write", mod, GRID_BRANCH),
        ("run", [mod, "--baseline", bp, "--update-baseline"]),
        # the content-hash cache: a second scan of the same tree hits
        ("run", [mod, "--no-baseline", "--cache", cache]),
        ("run", [mod, "--no-baseline", "--cache", cache])])
    assert runs[0].rc == 0, runs[0].out + runs[0].err
    assert "wrote 3 finding(s)" in runs[0].out
    assert runs[1].rc == 0 and "(3 baselined)" in runs[1].out, runs[1].out
    assert runs[2].rc == 1
    assert runs[3].rc == 0 and "3 stale pruned" in runs[3].out, runs[3].out
    assert runs[4].rc == 0 and "NEW finding" in runs[4].out, runs[4].out
    with open(bp) as fh:
        assert json.load(fh)["findings"] == []
    assert runs[5].rc == runs[6].rc == 1
    assert "[cache miss]" in runs[5].out and "[cache hit]" in runs[6].out


def test_cli_no_dataflow_is_the_lexical_tier():
    path = os.path.join("tests", "fixtures", "slulint",
                        "wrapped_collective.py")
    full, lexical = _cli_steps([("run", [path, "--no-baseline"]),
                                ("run", [path, "--no-baseline",
                                         "--no-dataflow"])])
    assert full.rc == 1 and lexical.rc == 0, full.out + lexical.out


# --------------------------------------------------------------------------
# the port's tree, under both linters
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_scan():
    return _cli_steps([("run", ["--no-cache"])])[0]


@pytest.fixture(scope="module")
def jax_scan():
    return subprocess.run(
        [sys.executable, "-m", "superlu_dist_tpu.analysis", "--no-cache",
         "--no-baseline", "--rules", "SLU101,SLU108,SLU109,SLU110",
         "superlu_dist_tpu_torch"],
        capture_output=True, text=True, cwd=REPO, timeout=600)


def test_port_tree_is_clean_under_its_linter(port_scan):
    assert port_scan.rc == 0, port_scan.out + port_scan.err
    tail = port_scan.out.strip().splitlines()[-1]
    assert tail.startswith("slulint: 0 finding(s) in "), tail
    # the default scope: the package, chip_smoke.py and the port's scripts
    n_files = int(tail.split(" in ")[1].split()[0])
    assert n_files >= 110, tail
    with open(os.path.join(REPO, ".slulint-torch-baseline.json")) as fh:
        assert json.load(fh)["findings"] == []


def test_port_tree_is_clean_under_the_jax_neutral_rules(jax_scan):
    assert jax_scan.returncode == 0, jax_scan.stdout + jax_scan.stderr
    assert "slulint: 0 finding(s)" in jax_scan.stdout


def test_mesh_entry_check_raises_on_every_rank():
    """Rank 1 asks for a device that is not its grid rank's: both ranks
    raise SuperLUError (no rank is left waiting in the mesh tier's first
    collective; the comm timeout bounds a regression)."""
    out = run_mesh_ranks(2, cases.mesh_entry_mismatch,
                         ("poisson2d", (6,), 0, None), timeout=120,
                         env={"SLU_TPU_COMM_TIMEOUT_S": "30"})
    for r in range(2):
        assert out[r].startswith("raised: mesh entry check failed on "
                                 "rank(s) [1]"), out[r]
    assert "device 'cuda'" in out[1] or "device cuda" in out[1], out[1]
