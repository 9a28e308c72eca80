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
# SLU102 / SLU105 / SLU107: the JAX jit fixtures as capture bodies and
# graph caches, line for line
# --------------------------------------------------------------------------

TRACE_RULES = {"SLU102", "SLU105", "SLU107"}
_GRAPH = 'Graph(body, "cuda", torch.cuda.Stream(), site="t", key="k")'

#: JAX snippet (tests/test_analysis.py) or fixture -> its torch form: a
#: jitted body becomes a body captured by numeric/fused.Graph, an
#: lru_cached jit factory an lru_cached graph factory
TRACE_PAIRS = {
    "SLU102_POSITIVE": f"""
import os
import torch
from superlu_dist_tpu_torch.numeric.fused import Graph

# captured by capture() below
def kernel(x):
    scale = float(os.environ.get("SLU_TPU_TRACE", "1"))
    return x.cpu() * scale

def capture(x, dev, stream):
    return Graph(lambda: kernel(x), dev, stream, site="t", key="k")
""",
    "SLU102_WRAPPED": """
import torch

def make(w, dev, stream):
    def step():
        return w * int(w.sum())
    return Graph(step, dev, stream, site="t", key="k")
""",
    "SLU102_CLEAN": """
import torch
from superlu_dist_tpu_torch.numeric.fused import Graph

# captured by capture() below
def kernel(x):
    return torch.as_tensor(x) * 2.0

def host_helper(x):
    return float(x.sum())

def capture(x, dev, stream):
    return Graph(lambda: kernel(x), dev, stream, site="t", key="k")
""",
    "SLU105_ENV": f"""
import functools
import os
import torch

@functools.lru_cache(maxsize=None)
def make_graph(m, w):
    passes = os.environ.get("SLU_TPU_PRECISION", "highest")
    def body():
        return torch.ones(m) * len(passes)
    return {_GRAPH}
""",
    "SLU105_CLOSURE": f"""
import functools
import torch

def build(plan, pad_width):
    @functools.lru_cache(maxsize=None)
    def make_graph(m):
        def body():
            return torch.zeros(64)[:m + pad_width]
        return {_GRAPH}
    return make_graph
""",
    "SLU105_CLEAN": f"""
import functools
import torch

from superlu_dist_tpu_torch.utils.options import env_str

def make_graph(m, w):
    # env resolved OUTSIDE the cached factory and passed as a key arg,
    # the ops/dense.make_front_kernel discipline
    return _make_graph(m, w, env_str("SLU_TPU_PRECISION"))

@functools.lru_cache(maxsize=None)
def _make_graph(m, w, precision):
    def body():
        return torch.zeros(m) * w if precision else None
    return {_GRAPH}
""",
    "SLU105_ENV_HELPER": f"""
import functools
import os
import torch

def _resolve():
    return os.environ.get("SLU_TPU_PRECISION", "highest")

@functools.lru_cache(maxsize=None)
def make_graph(m):
    passes = _resolve()
    def body():
        return torch.ones(m) * len(passes)
    return {_GRAPH}
""",
    "SLU105_LATCHED": f"""
import functools
import os
import torch

@functools.lru_cache(maxsize=None)
def _precision():
    return os.environ.get("SLU_TPU_PRECISION", "highest")

@functools.lru_cache(maxsize=None)
def make_graph(m):
    p = _precision()
    def body():
        return torch.ones(m) * len(p)
    return {_GRAPH}
""",
    "SLU107_INLINE": """
import functools, torch

@functools.lru_cache(maxsize=None)
def make(n):
    return Graph(lambda: torch.zeros(n), "cuda", None, site="t", key="k")

def a(x):
    return make(x.numel()).replay()   # raw .numel() -> flagged

def b(x):
    return make(_bucket_len(x.numel())).replay()   # rung-rounded -> clean
""",
}


def _torch_fixture(name) -> str:
    """A JAX slulint fixture file rewritten line for line: jax.jit of
    the body becomes a fused.Graph capture of it."""
    src = open(os.path.join(FIXDIR, name)).read()
    src = src.replace("import jax\nimport jax.numpy as jnp",
                      "import torch\nfrom superlu_dist_tpu_torch.numeric."
                      "fused import Graph")
    src = src.replace("return jax.jit(step)",
                      'return Graph(step, "cuda", None, site="t", key="k")')
    return src.replace("jnp.", "torch.")


for _name in ("raw_dim_key.py", "bucketed_dim_key.py"):
    TRACE_PAIRS[_name] = _torch_fixture(_name)


def _jax_trace_source(name) -> str:
    if name.endswith(".py"):
        return open(os.path.join(FIXDIR, name)).read()
    return _snippets()[name]


def _line_keys(findings) -> set:
    return {(f.rule, f.line) for f in findings if f.rule in TRACE_RULES}


@pytest.mark.parametrize("name", sorted(TRACE_PAIRS))
def test_trace_rules_match_jax_on_translated_fixtures(name):
    """The JAX linter on the jit original and the port's on the capture
    form give the same rules on the same lines (the JAX tests'
    SLU102 / SLU105 / SLU107 cases)."""
    want = _line_keys(janalysis.analyze_source(
        _jax_trace_source(name), name, janalysis.default_rules()))
    got = _line_keys(tanalysis.analyze_source(
        TRACE_PAIRS[name], name, tanalysis.default_rules()))
    assert got == want
    # positives and clean twins both (the agreement is not vacuous)
    assert bool(want) == ("CLEAN" not in name and "LATCHED" not in name
                          and "bucketed" not in name)


def test_trace_pairs_cover_every_trace_rule():
    fired = set()
    for name, src in TRACE_PAIRS.items():
        fired |= {r for r, _ in _line_keys(tanalysis.analyze_source(
            src, name, tanalysis.default_rules()))}
    assert fired == TRACE_RULES


def test_slu102_messages_name_the_capture():
    fs = [f for f in _run(TRACE_PAIRS["SLU102_POSITIVE"])
          if f.rule == "SLU102"]
    msgs = " ".join(f.message for f in fs)
    assert "os.environ read inside a capture body" in msgs
    assert "`.cpu()`" in msgs and "the capture at fixture.py:12" in msgs
    fs = [f for f in _run(TRACE_PAIRS["SLU102_WRAPPED"])
          if f.rule == "SLU102"]
    assert [(f.line, "`int()` of a tensor" in f.message) for f in fs] == \
        [(6, True)]


def test_slu102_scoped_to_hot_subpackages_in_tree():
    src = TRACE_PAIRS["SLU102_POSITIVE"]
    for sub, hot in (("numeric", True), ("parallel", True), ("io", False)):
        path = os.path.join("superlu_dist_tpu_torch", sub, "x.py")
        assert ("SLU102" in {f.rule for f in _run(src, path)}) == hot


SLU102_CAPTURE_BEGIN = """
import torch

def capture(graph, pool, x):
    graph.capture_begin(pool=pool)
    try:
        y = x * 2
        n = int(y.sum())
    finally:
        graph.capture_end()
    return float(x.sum()) + n
"""


def test_slu102_capture_begin_region():
    """Between capture_begin and capture_end (a try's body included) —
    after it, a coercion is host code again."""
    fs = [f for f in _run(SLU102_CAPTURE_BEGIN) if f.rule == "SLU102"]
    assert [f.line for f in fs] == [8]


GRAPH_DICT_CACHE = """
import torch
from superlu_dist_tpu_torch.numeric.fused import Graph

class Solver:
    def capture(self, direction, kb, scale):
        key = (direction, kb)
        x = self._buffers[kb]
        graph = Graph(lambda: self._sweep(direction, x, scale), "cuda",
                      torch.cuda.Stream(), site="t", key="k")
        self._graphs[key] = graph
        return graph
"""


def test_slu105_dict_cache_input_missing_from_the_key():
    """A DeviceSolver._graphs-style cache: ``scale`` shapes the graph
    but the key misses it (anchored at the store); with it in the key,
    clean; an env read that feeds the construction is flagged."""
    fs = [f for f in _run(GRAPH_DICT_CACHE) if f.rule == "SLU105"]
    assert [f.line for f in fs] == [11]
    assert "`scale`" in fs[0].message and "self._graphs" in fs[0].message
    fixed = GRAPH_DICT_CACHE.replace("key = (direction, kb)",
                                     "key = (direction, kb, scale)")
    assert [f for f in _run(fixed) if f.rule == "SLU105"] == []
    env = fixed.replace("self._sweep(direction, x, scale)",
                        "self._sweep(direction, x, os.environ['K'])")
    assert [f.line for f in _run(env) if f.rule == "SLU105"] == [9]


EXECUTOR_CACHE = """
from superlu_dist_tpu_torch.numeric.fused import Graph

class Executor:
    def run(self):
        self.g = Graph(lambda: None, "cuda", None, site="t", key="k")

def get_executor(plan, dtype, device, lag):
    key = (str(dtype), str(device))
    cache = plan.__dict__.setdefault("_fns", {})
    fn = cache.get(key)
    if fn is None:
        fn = Executor(plan, dtype, device, lag)
        cache[key] = fn
    return fn
"""


def test_slu105_executor_cache_of_a_capturing_class():
    """get_executor's shape: the constructor of a class that captures
    builds the cached value; ``lag`` is missing from the key, ``plan``
    owns the cache."""
    fs = [f for f in _run(EXECUTOR_CACHE) if f.rule == "SLU105"]
    assert [(f.line, "`lag`" in f.message) for f in fs] == [(14, True)]
    fixed = EXECUTOR_CACHE.replace("key = (str(dtype), str(device))",
                                   "key = (str(dtype), str(device), lag)")
    assert [f for f in _run(fixed) if f.rule == "SLU105"] == []


def test_slu107_raw_size_in_a_dict_cache_key():
    src = GRAPH_DICT_CACHE.replace("key = (direction, kb)",
                                   "key = (direction, x.shape[0], scale)")
    fs = [f for f in _run(src) if f.rule == "SLU107"]
    assert [f.line for f in fs] == [7] and ".shape" in fs[0].message
    rung = src.replace("x.shape[0]", "bucket_rung(x.shape[0])")
    assert [f for f in _run(rung) if f.rule == "SLU107"] == []


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
        ("run", ["--rules", "SLU117", str(clean)]),
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
    # unknown rule (SLU117 is the JAX package's), missing path, bad flag
    assert runs[3].rc == 2 and "SLU117" in runs[3].err
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


# --------------------------------------------------------------------------
# a grid's collectives inside a capture (parallel/mesh_graphs.py on NCCL)
# --------------------------------------------------------------------------

CAPTURED_GRID = """
import torch
from superlu_dist_tpu_torch.numeric.fused import Graph
from superlu_dist_tpu_torch.parallel.grid import ProcessGrid


def unit(grid: ProcessGrid, t, counts, dev, stream):
    with grid.recording() as tape:
        graph = Graph(lambda: grid.exchange(
            grid.bcast_row(t, 0, t.shape, t.dtype).reshape(-1), counts,
            counts), dev, stream, site="t", key="k")
    grid.check_tape(tape)
    return graph
"""


def _with_grid(source):
    """``source`` as a module of the port's parallel/ beside the real
    parallel/grid.py and numeric/fused.py, so that the capture body's
    calls resolve into ProcessGrid's collectives."""
    pkg = os.path.join(REPO, "superlu_dist_tpu_torch")
    sources = {os.path.join(pkg, "parallel", "unit_fixture.py"): source}
    for rel in (("parallel", "grid.py"), ("numeric", "fused.py")):
        path = os.path.join(pkg, *rel)
        with open(path) as fh:
            sources[path] = fh.read()
    return tanalysis.analyze_sources(sources)


def test_grid_collectives_inside_a_capture_are_clean():
    """A broadcast over the row and the exchange inside a capture body
    (a unit graph on an NCCL grid) reach ProcessGrid's collectives, whose
    verify checks and host reads wait for check_tape outside the
    capture: no SLU101 / SLU102 / SLU105 / SLU107 finding anywhere."""
    assert _with_grid(CAPTURED_GRID) == []


def test_a_host_sync_inside_a_grid_capture_is_still_flagged():
    """The same capture body with a coercion of a tensor in it: SLU102
    flags the coercion where it is written, and only it."""
    src = CAPTURED_GRID.replace("t.shape, t.dtype)",
                                "t.shape, t.dtype) * int(t.sum())")
    fs = _with_grid(src)
    assert [(f.rule, os.path.basename(f.path), f.line) for f in fs] == [
        ("SLU102", "unit_fixture.py", 10)]
    assert "`int()` of a tensor inside a capture body" in fs[0].message


def test_grid_collectives_in_a_capture_outside_recording_are_flagged():
    """The same capture body outside ``grid.recording()``: the grid's
    collectives run their verify checks and host reads on the host there,
    so SLU102 follows the capture into parallel/grid.py and flags them,
    each reached from the fixture's capture."""
    src = CAPTURED_GRID.replace(
        "    with grid.recording() as tape:\n        graph = Graph(",
        "    tape = []\n    if True:\n        graph = Graph(")
    assert "recording" not in src
    fs = _with_grid(src)
    assert fs and {f.rule for f in fs} == {"SLU102"}, fs
    assert {os.path.basename(f.path) for f in fs} == {"grid.py"}, fs
    assert all("unit_fixture.py" in f.message for f in fs), fs
