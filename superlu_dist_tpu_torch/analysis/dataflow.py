"""Forward abstract interpretation for the dataflow-aware slulint rules.

A deliberately small lattice — each variable carries a set of *taints*,
each taint a kind plus a one-line provenance used verbatim in findings:

* ``i32``  — the value is (or derives from) a 32-bit integer array:
  a ctor/``astype``/``cumsum`` with a 32-bit dtype (including the
  env-selected ``INT`` alias), or the return of a function whose returns
  are i32-tainted.  ``.astype(np.int64)`` *clears* the taint — promotion
  is exactly the fix the rule asks for.
* ``rank`` — the value derives from the caller's rank / grid coordinate
  (``.rank``/``.iam``/``.myrow``/``.mycol`` attribute reads, the lexical
  rank names, or the return of a rank-deriving function like an
  ``is_root(tc)`` predicate).
* ``env``  — the value derives from ``os.environ`` (directly or via the
  registry helpers ``env_int``/``env_float``/``env_str``/``env_flag``).
* ``device`` — the value may live on the card (torch's device lattice,
  below; SLU113 / SLU122).
* ``f64`` / ``f32`` — the float width a value is known to carry (the
  precision rules SLU115).

Propagation is a single in-order forward pass per function (loop bodies
run twice for loop-carried taint), through assignments, augmented
assignments, tuple unpacking, subscripts, a small set of
shape-preserving numpy passthroughs, and — via the call graph — function
returns, iterated to a fixpoint across the project.

Per-function :class:`Summary` records feed the rules: direct + transitive
collective reachability (SLU101, SLU109), return taints (SLU101 rank
predicates, SLU103 i32-through-return, the device taint through
helpers), and whether a function's own body waits for the card (a call
to it is then an explicit sync, like ``StreamExecutor``'s offload wait).

Port of the JAX package's ``analysis/dataflow.py``: the device taint is
torch's instead of the jnp / jitted-call one, the collective surface
adds ProcessGrid's, and the df64 error-free-transform taint is gone (the
port runs df64 as float64).
"""

from __future__ import annotations

import ast
import dataclasses

from superlu_dist_tpu_torch.analysis.core import dotted_name, is_env_read

TAINT_I32 = "i32"
TAINT_RANK = "rank"
TAINT_ENV = "env"
# rules_program.SLU113 / rules_sharding.SLU122: a value that may live on
# the card — torch's device lattice.  Sources: a torch factory call given
# a device (``torch.zeros(..., device=dev)``), ``.to(dev)`` / ``.cuda()``,
# any torch op or tensor method taking a device value, the port's kernel
# entry points (numeric/kernels.py, parallel/dist.csr_spmv) and CUDA-graph
# replays.  The explicit host reads clear it — ``.cpu()``, ``.to("cpu")``
# and, for every value at once, ``torch.cuda.synchronize()`` and an
# ``Event`` / ``Stream`` ``.synchronize()`` — as ``jax.device_get`` /
# ``block_until_ready`` do in the JAX package's lattice: the wait is
# then spelled where it happens, which is the fix SLU113 asks for.
TAINT_DEVICE = "device"
# the other side of the device lattice: a value lexically placed on the
# host (``.cpu()``, ``.to("cpu")``, ``.pin_memory()``, a torch factory
# given a host device or ``pin_memory=True``) — what tells SLU122 that a
# ``dst.copy_(src)`` of a device value leaves the card
TAINT_HOST = "host"
# rules_precision: the precision-flow component.  Width taints say what
# FLOAT width a value is KNOWN to carry (an explicit ctor dtype, a
# ``.to(dtype)`` / ``.astype``, ``.double()`` / ``.float()``, a
# ``np.float64(x)`` cast, or — via the return-taint fixpoint — the
# return of a function producing one); two separate kinds so the width
# survives the provenance-string wrapping of summarized returns.  16-bit
# floats get no kind of their own — width 16 is the lattice floor.
TAINT_F64 = "f64"
TAINT_F32 = "f32"

#: taints that do not survive a comparison (comparisons yield bools)
_NONBOOL_TAINTS = (TAINT_I32, TAINT_F64, TAINT_F32)

#: explicit waits for the card: a statement calling one makes every
#: value computed before it host-readable without a further wait
SYNC_CALLS = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
#: methods whose call is an explicit wait (``ev.synchronize()``,
#: ``stream.synchronize()``)
SYNC_METHODS = frozenset({"synchronize"})

#: the port's kernel entry points (numeric/kernels.py and
#: parallel/dist.py), recognized by call tail: their results and the
#: tensors they write live where the launch ran
KERNEL_ENTRIES = frozenset({
    "front_assemble_", "extend_add_", "assemble_", "panel_lu_",
    "panel_launch_", "launch_", "csr_spmv"})

#: tensor methods that read metadata, never the device buffer
_META_METHODS = frozenset({
    "numel", "dim", "size", "element_size", "stride", "data_ptr",
    "is_contiguous", "nelement", "ndimension", "get_device",
    "storage_offset", "untyped_storage", "is_pinned", "record_stream"})

#: host placements: their results are on the host (the coercions SLU113
#: flags inside a loop are in rules_program; these are the explicit ones)
_HOST_METHODS = frozenset({"cpu", "pin_memory"})

#: torch factories that take ``device=``
_TORCH_FACTORIES = frozenset({
    "zeros", "ones", "empty", "full", "arange", "tensor", "as_tensor",
    "zeros_like", "ones_like", "empty_like", "full_like", "eye",
    "linspace", "rand", "randn", "randint", "empty_strided"})

#: TreeComm's collective surface (parallel/treecomm.py) and ProcessGrid's
#: (parallel/grid.py); rules_collective re-exports this.
COLLECTIVE_METHODS = frozenset({
    # TreeComm
    "bcast", "reduce_sum", "allreduce_sum", "bcast_bytes", "bcast_obj",
    "bcast_any", "reduce_sum_any", "allreduce_sum_any",
    # ProcessGrid
    "all_gather", "bcast_row", "all_reduce_row", "exchange", "gather_rows",
    "all_reduce_sum",
})

_RANK_ATTRS = frozenset({"rank", "iam", "myrow", "mycol"})
_RANK_NAMES = frozenset({"rank", "iam", "myrank", "my_rank"})

_ENV_HELPER_SUFFIXES = tuple(
    f"options.{n}" for n in ("env_int", "env_float", "env_str", "env_flag"))

# ---- 32-bit dtype recognition (shared with rules_index) -------------------

_I32_DOTTED = frozenset({"np.int32", "numpy.int32", "np.intc",
                         "numpy.intc", "int32", "torch.int32", "torch.int"})
# formats.INT is int32 unless SLU_TPU_INT64 is set — treat it as 32-bit
# for accumulator purposes (the whole point of the alias is that callers
# must not feed it to arithmetic that can exceed 2^31)
_I32_ALIASES = frozenset({"INT"})
_I64_NAMES = frozenset({"np.int64", "numpy.int64", "int64", "np.intp",
                        "numpy.intp", "torch.int64", "torch.long"})

_ARRAY_CTORS = frozenset({"zeros", "empty", "full", "arange", "array",
                          "asarray", "ones", "tensor", "as_tensor",
                          "zeros_like", "ones_like", "empty_like",
                          "full_like"})

# ---- float dtype recognition (the precision lattice) ----------------------
# Complex dtypes resolve to their COMPONENT width: narrowing c128 -> c64
# loses exactly the bits narrowing f64 -> f32 does.

_F64_DOTTED = frozenset({"np.float64", "numpy.float64", "float64",
                         "np.double", "numpy.double", "np.complex128",
                         "numpy.complex128", "complex128", "torch.float64",
                         "torch.double", "torch.complex128",
                         "torch.cdouble"})
_F32_DOTTED = frozenset({"np.float32", "numpy.float32", "float32",
                         "np.single", "numpy.single", "np.complex64",
                         "numpy.complex64", "complex64", "torch.float32",
                         "torch.float", "torch.complex64", "torch.cfloat"})
_F16_DOTTED = frozenset({"np.float16", "numpy.float16", "float16",
                         "bfloat16", "ml_dtypes.bfloat16", "torch.float16",
                         "torch.half", "torch.bfloat16"})

#: tensor methods that cast to a fixed float width
TORCH_CAST_METHODS = {"double": 64, "float": 32, "half": 16, "bfloat16": 16}


def float_width_name(name: str) -> int | None:
    """64/32/16 when ``name`` lexically names a float/complex dtype
    (complex -> component width), else None."""
    if name in _F64_DOTTED:
        return 64
    if name in _F32_DOTTED:
        return 32
    if name in _F16_DOTTED:
        return 16
    return None


def float_width_node(node) -> int | None:
    """Float width of a dtype EXPRESSION: ``np.float32`` / ``'float32'``
    / ``torch.bfloat16`` ... — None for dynamic dtypes (``x.dtype``),
    which the precision rules deliberately cannot see through."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return float_width_name(node.value.strip())
    return float_width_name(dotted_name(node))


def width_taint_kind(width) -> str | None:
    return {64: TAINT_F64, 32: TAINT_F32}.get(width)


def taint_width(taints: dict) -> int | None:
    """The widest float width a taint set attests (promotion picks the
    wider operand, so after a BinOp merge the max is the result width)."""
    if TAINT_F64 in taints:
        return 64
    if TAINT_F32 in taints:
        return 32
    return None


# calls through which an i32 taint survives unchanged
_PASSTHROUGH = frozenset({"cumsum", "asarray", "ascontiguousarray",
                          "array", "copy", "ravel", "reshape",
                          "concatenate"})


def is_i32_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "int32":
        return True
    name = dotted_name(node)
    return name in _I32_DOTTED or name in _I32_ALIASES


def is_i64_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "int64":
        return True
    return dotted_name(node) in _I64_NAMES


def dtype_kw(call: ast.Call):
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def to_dtype_arg(call: ast.Call):
    """The dtype a ``.to(...)`` / ``.astype(...)`` call converts to: its
    ``dtype=`` keyword, or a positional argument that lexically names a
    dtype; None otherwise."""
    dt = dtype_kw(call)
    if dt is not None:
        return dt
    for arg in call.args:
        if is_i32_dtype(arg) or is_i64_dtype(arg) \
                or float_width_node(arg) is not None:
            return arg
    return None


def is_explicit_i32_expr(node: ast.AST) -> bool:
    """np.int32(x), x.astype(np.int32) / x.astype('int32'), x.int() and
    x.to(torch.int32)."""
    if not isinstance(node, ast.Call):
        return False
    if is_i32_dtype(node.func) and dotted_name(node.func) not in \
            _I32_ALIASES:
        return True
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr == "astype" and node.args and is_i32_dtype(node.args[0]):
        return True
    if fn.attr == "int" and not node.args and not node.keywords:
        return True
    if fn.attr == "to":
        dt = to_dtype_arg(node)
        return dt is not None and is_i32_dtype(dt)
    return False


# ---- device recognition (the torch lattice) -------------------------------

def is_host_device(node) -> bool:
    """A device expression that lexically names the host: ``"cpu"``,
    ``torch.device("cpu")`` or a constant named ``CPU`` / ``cpu``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "torch.device", "device") and node.args:
        return is_host_device(node.args[0])
    name = dotted_name(node)
    return bool(name) and name.rsplit(".", 1)[-1] in ("CPU", "cpu")


def _device_kw(call: ast.Call):
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def to_device_arg(call: ast.Call):
    """The device a ``.to(...)`` call moves to (its ``device=`` keyword,
    or a positional argument that is not a dtype), or None for a
    dtype-only conversion."""
    dev = _device_kw(call)
    if dev is not None:
        return dev
    for arg in call.args:
        if is_i32_dtype(arg) or is_i64_dtype(arg) \
                or float_width_node(arg) is not None:
            continue
        name = dotted_name(arg)
        if name.startswith("torch.") and name != "torch.device":
            continue                    # another torch dtype (torch.bool)
        last = name.rsplit(".", 1)[-1]
        if "dtype" in last or last == "dt" or last.endswith("_dt"):
            continue                    # x.to(y.dtype), x.to(wdtype)
        return arg
    return None


def is_sync_call(node) -> bool:
    """``torch.cuda.synchronize(...)`` or ``<event/stream>.synchronize()``:
    an explicit wait for the card."""
    if not isinstance(node, ast.Call):
        return False
    if dotted_name(node.func) in SYNC_CALLS:
        return True
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr in SYNC_METHODS


# --------------------------------------------------------------------------
# per-function summaries
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Summary:
    """What the rest of the project needs to know about one function."""

    return_taints: dict = dataclasses.field(default_factory=dict)
    # per-element return taints by tuple arity ({2: [{kind: prov}, ...]}):
    # ``(lp, up), t = group_step(...)`` binds each name to its own
    # element's taint instead of smearing the whole return over it
    return_elts: dict = dataclasses.field(default_factory=dict)
    collective: str | None = None       # direct witness "op at path:line"
    env: str | None = None              # direct witness
    latched_env: bool = False           # zero-arg lru_cached env reader
    # the function's own body waits for the card (an explicit sync
    # statement): calling it is an explicit sync too
    syncs: bool = False
    # transitive: (qname of the function owning the witness, witness)
    reaches_collective: tuple | None = None
    reaches_env: tuple | None = None
    # concurrency lattice facts (analysis/concurrency.py resolves them):
    # raw with-statement lock-acquisition candidates
    # ("self"|"name", text, line) and raw blocking-operation witnesses
    # (kind, receiver-text, line) lexically in this function's own body
    acquires_raw: list = dataclasses.field(default_factory=list)
    blocking_raw: list = dataclasses.field(default_factory=list)


def _site(path: str, node: ast.AST) -> str:
    return f"{path}:{getattr(node, 'lineno', 0)}"


def _own_body_nodes(fn):
    """Nodes lexically in `fn`'s own body — nested defs/lambdas excluded
    (they execute in their own context and carry their own Summary)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def is_env_helper(target: str | None) -> bool:
    return bool(target) and target.endswith(_ENV_HELPER_SUFFIXES)


def _direct_collective(fi) -> str | None:
    for node in _own_body_nodes(fi.node):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in COLLECTIVE_METHODS:
            return f"{node.func.attr} at {_site(fi.path, node)}"
    return None


def _direct_env(proj, fi) -> str | None:
    for node in _own_body_nodes(fi.node):
        env = is_env_read(node)
        if env is not None:
            key = env[0] or "<dynamic>"
            return f"os.environ[{key!r}] at {_site(fi.path, env[1])}"
        if isinstance(node, ast.Call):
            target = proj.call_target(fi.path, node)
            if is_env_helper(target):
                return (f"{target.rsplit('.', 1)[-1]}(...) at "
                        f"{_site(fi.path, node)}")
    return None


def _direct_sync(fi) -> bool:
    return any(isinstance(node, ast.Expr) and is_sync_call(node.value)
               for node in _own_body_nodes(fi.node))


def _is_lru_decorated(fn) -> bool:
    for d in fn.decorator_list:
        if isinstance(d, ast.Call):
            d = d.func
        if dotted_name(d) in ("lru_cache", "functools.lru_cache",
                              "cache", "functools.cache"):
            return True
    return False


# ---- concurrency lattice: raw lock/blocking facts -------------------------
# The concurrency rules (SLU108-SLU110, analysis/concurrency.py) need two
# lexical facts per function: which locks its body acquires via
# ``with`` statements, and which blocking operations it performs while
# they may be held.  Collected here — alongside the other Summary facts,
# so the transitive fixpoints ride the same call-graph edges — as RAW
# (unresolved) records; identity resolution (which class attr is a Lock,
# which module global) needs the project-wide attr tables that
# concurrency.Model builds.

_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "add", "update", "pop", "popleft",
    "remove", "discard", "clear", "insert", "setdefault", "sort"})


def _acquire_candidate(item: ast.withitem):
    """("self"|"name", text, line) for a with-item whose context is a
    bare name/attribute (locks are with-ed directly; context-manager
    CALLS — tracer spans, nullcontext — are not lock acquisitions)."""
    ctx = item.context_expr
    if isinstance(ctx, ast.Attribute) and isinstance(ctx.value, ast.Name) \
            and ctx.value.id == "self":
        return ("self", ctx.attr, ctx.lineno)
    if isinstance(ctx, ast.Name):
        return ("name", ctx.id, ctx.lineno)
    return None


def _blocking_candidate(node: ast.Call):
    """(kind, receiver-text, line) when `node` is a recognized blocking
    call: file open, a no-timeout ``.wait()`` / ``.join()``, a wait for
    the card (``torch.cuda.synchronize()``, ``<event>.synchronize()``),
    or ``time.sleep``."""
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id == "open":
        return ("open", "open", node.lineno)
    if not isinstance(fn, ast.Attribute):
        return None
    recv = dotted_name(fn.value) or "<expr>"
    if fn.attr == "synchronize":
        return ("synchronize", recv, node.lineno)
    if fn.attr in ("wait", "join") and not node.args and not node.keywords:
        return (fn.attr, recv, node.lineno)
    if fn.attr == "sleep" and recv == "time":
        return ("sleep", recv, node.lineno)
    return None


def _concurrency_facts(fi, summary: Summary) -> None:
    for node in _own_body_nodes(fi.node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                cand = _acquire_candidate(item)
                if cand is not None:
                    summary.acquires_raw.append(cand)
        elif isinstance(node, ast.Call):
            cand = _blocking_candidate(node)
            if cand is not None:
                summary.blocking_raw.append(cand)


def _is_latched_const(fi, direct_env) -> bool:
    """Zero-argument lru_cached env reader: reads once per process, so
    its value is a process constant."""
    a = fi.node.args
    n_args = len(a.posonlyargs) + len(a.args) + len(a.kwonlyargs) \
        + (1 if a.vararg else 0) + (1 if a.kwarg else 0)
    return bool(direct_env) and n_args == 0 and _is_lru_decorated(fi.node)


def summarize(proj) -> None:
    """Fill proj.summaries for every function in the project."""
    sums = {q: Summary() for q in proj.functions}
    proj.summaries = sums
    for q, fi in proj.functions.items():
        s = sums[q]
        s.collective = _direct_collective(fi)
        s.env = _direct_env(proj, fi)
        s.latched_env = _is_latched_const(fi, s.env)
        s.syncs = _direct_sync(fi)
        _concurrency_facts(fi, s)
        if s.collective:
            s.reaches_collective = (q, s.collective)
        if s.env and not s.latched_env:
            s.reaches_env = (q, s.env)

    # transitive reachability over resolved call edges (cycle-safe)
    changed = True
    while changed:
        changed = False
        for q, fi in proj.functions.items():
            s = sums[q]
            for callee in fi.calls:
                cs = sums.get(callee)
                if cs is None:
                    continue
                if s.reaches_collective is None \
                        and cs.reaches_collective is not None:
                    s.reaches_collective = cs.reaches_collective
                    changed = True
                if s.reaches_env is None and not s.latched_env \
                        and cs.reaches_env is not None:
                    s.reaches_env = cs.reaches_env
                    changed = True

    # return-taint fixpoint (i32/rank/env/device/width through returns
    # and call edges)
    for _ in range(4):
        changed = False
        for q, fi in proj.functions.items():
            flow = FnFlow.for_function(proj, fi)
            flow.run()
            if flow.returns != sums[q].return_taints \
                    or flow.return_elts != sums[q].return_elts:
                sums[q].return_taints = flow.returns
                sums[q].return_elts = flow.return_elts
                changed = True
        if not changed:
            break


# --------------------------------------------------------------------------
# the forward pass
# --------------------------------------------------------------------------

class FnFlow:
    """One function (or module) body, interpreted in order."""

    def __init__(self, body, path, resolve, summaries):
        self.body = body
        self.path = path
        self.resolve = resolve          # Call node -> qname | None
        self.summaries = summaries
        self.env: dict = {}             # var -> {kind: provenance}
        self.assigns: dict = {}         # (line, col) -> (names, node, taints)
        self.returns: dict = {}         # {kind: provenance}
        self.return_elts: dict = {}     # arity -> [{kind: provenance}]
        self.loop_depth = 0             # lexical For/While nesting (SLU113)

    @classmethod
    def for_function(cls, proj, fi):
        resolve = (lambda call: proj.call_target(fi.path, call))
        return cls(fi.node.body, fi.path, resolve, proj.summaries)

    @classmethod
    def for_module(cls, proj, path, tree):
        resolve = (lambda call: proj.call_target(path, call))
        return cls(tree.body, path, resolve, proj.summaries)

    def run(self):
        self._exec(self.body)
        return self

    def rank_tainted(self, expr) -> str | None:
        """Provenance if `expr` is rank-dependent: lexical rank names,
        rank-tainted locals, or calls returning rank-derived values."""
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and sub.attr in _RANK_ATTRS:
                return f"`{dotted_name(sub) or sub.attr}`"
            if isinstance(sub, ast.Name):
                if sub.id in _RANK_NAMES:
                    return f"`{sub.id}`"
                t = self.env.get(sub.id)
                if t and TAINT_RANK in t:
                    return f"`{sub.id}` ({t[TAINT_RANK]})"
            if isinstance(sub, ast.Call):
                s = self._call_summary(sub)
                if s is not None and TAINT_RANK in s.return_taints:
                    return (f"`{dotted_name(sub.func)}()` returns "
                            f"{s.return_taints[TAINT_RANK]}")
        return None

    # ---- expression taint ----------------------------------------------
    def _call_summary(self, call):
        target = self.resolve(call)
        return self.summaries.get(target) if target else None

    def taint(self, node) -> dict:
        if node is None or isinstance(node, ast.Constant):
            return {}
        if isinstance(node, ast.Name):
            t = dict(self.env.get(node.id, ()))
            if node.id in _RANK_NAMES:
                t.setdefault(TAINT_RANK, f"`{node.id}`")
            return t
        if isinstance(node, ast.Attribute):
            if node.attr in _RANK_ATTRS:
                return {TAINT_RANK: f"`{dotted_name(node) or node.attr}`"}
            if node.attr in ("mT", "T", "H", "mH", "real", "imag"):
                # views of the same buffer
                return {k: p for k, p in self.taint(node.value).items()
                        if k in (TAINT_DEVICE, TAINT_HOST)}
            return {}
        if isinstance(node, ast.Subscript):
            return self.taint(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BinOp):
            lt, rt = self.taint(node.left), self.taint(node.right)
            out = {}
            # numpy promotes int32 op int64 -> int64: only keep i32 when
            # no operand is known-promoted (a constant keeps the taint)
            if TAINT_I32 in lt and (TAINT_I32 in rt or _const_like(
                    node.right)):
                out[TAINT_I32] = lt[TAINT_I32]
            elif TAINT_I32 in rt and _const_like(node.left):
                out[TAINT_I32] = rt[TAINT_I32]
            for t in (lt, rt):
                for k in (TAINT_RANK, TAINT_ENV, TAINT_DEVICE,
                          TAINT_HOST, TAINT_F64, TAINT_F32):
                    if k in t:
                        out.setdefault(k, t[k])
            return out
        if isinstance(node, (ast.BoolOp, ast.Compare)):
            vals = (node.values if isinstance(node, ast.BoolOp)
                    else [node.left] + list(node.comparators))
            out = {}
            for v in vals:
                for k, p in self.taint(v).items():
                    if k not in _NONBOOL_TAINTS:  # comparisons yield bools
                        out.setdefault(k, p)
            return out
        if isinstance(node, ast.IfExp):
            out = dict(self.taint(node.body))
            for k, p in self.taint(node.orelse).items():
                out.setdefault(k, p)
            return out
        if isinstance(node, (ast.Tuple, ast.List)):
            out = {}
            for e in node.elts:
                for k, p in self.taint(e).items():
                    out.setdefault(k, p)
            return out
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        return {}

    def _args_device(self, node: ast.Call) -> str | None:
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Starred):
                arg = arg.value
            p = self.taint(arg).get(TAINT_DEVICE)
            if p is not None:
                return p
        return None

    def _call_taint(self, node: ast.Call) -> dict:
        t = self._call_taint_base(node)
        fn = node.func
        name = dotted_name(fn)
        where = f"line {node.lineno}"

        def host(taints, prov=None):
            taints = {k: p for k, p in taints.items()
                      if k not in (TAINT_DEVICE, TAINT_HOST)}
            if prov is not None:
                taints[TAINT_HOST] = prov
            return taints

        def device(taints, prov):
            taints = {k: p for k, p in taints.items() if k != TAINT_HOST}
            taints.setdefault(TAINT_DEVICE, prov)
            return taints

        # ---- device lattice (SLU113 / SLU122) ------------------------------
        if name.startswith(("np.", "numpy.")):
            # a numpy result lives on the host (np.asarray(t) is itself
            # the host round trip SLU113 flags in a loop)
            return host(t)
        if isinstance(fn, ast.Attribute):
            recv = self.taint(fn.value)
            if fn.attr in _HOST_METHODS:
                return host(t if t else recv, f"`.{fn.attr}()` at {where}")
            if fn.attr in ("item", "tolist", "numpy"):
                return host(t)
            if fn.attr == "to":
                dev = to_device_arg(node)
                base = dict(recv)
                base.update(t)
                if dev is None:
                    return base
                if is_host_device(dev):
                    return host(base, f"`.to(<host>)` at {where}")
                return device(base, f"`.to(...)` at {where}")
            if fn.attr == "cuda":
                return device(recv, f"`.cuda()` at {where}")
            if fn.attr == "replay":
                return device(t, f"CUDA-graph replay `{name or 'replay'}()`"
                                 f" at {where}")
        tail = name.rsplit(".", 1)[-1]
        if tail in KERNEL_ENTRIES:
            return device(t, f"kernel entry `{tail}(...)` at {where}")
        if name.startswith("torch.") and not name.startswith("torch.cuda."):
            if tail in _TORCH_FACTORIES:
                dev = _device_kw(node)
                if dev is not None and not is_host_device(dev):
                    return device(t, f"`{name}(..., device=...)` at {where}")
                if (dev is not None and is_host_device(dev)) or any(
                        kw.arg == "pin_memory" for kw in node.keywords):
                    return host(t, f"`{name}(...)` on the host at {where}")
            prov = self._args_device(node)
            if prov is not None:
                return device(t, f"`{name}(...)` on a device value ({prov})")
            return t
        if isinstance(fn, ast.Attribute) and fn.attr not in _META_METHODS:
            prov = self.taint(fn.value).get(TAINT_DEVICE)
            if prov is not None:
                return device(t, prov)
        return t

    def _call_taint_base(self, node: ast.Call) -> dict:
        env = is_env_read(node)
        if env is not None:
            return {TAINT_ENV: f"os.environ[{env[0]!r}]"}
        fn = node.func
        name = dotted_name(fn)
        # x.astype(D) / x.to(D): promotion clears, demotion taints; a
        # lexical float dtype rebinds the width kinds (and clears the
        # stale one)
        if isinstance(fn, ast.Attribute) and fn.attr in ("astype", "to") \
                and (node.args or node.keywords):
            base = dict(self.taint(fn.value))
            dt = to_dtype_arg(node)
            if dt is None:
                return base
            if is_i32_dtype(dt):
                base[TAINT_I32] = (f"`.{fn.attr}("
                                   f"{dotted_name(dt) or 'int32'})` at "
                                   f"line {node.lineno}")
            else:
                base.pop(TAINT_I32, None)
            w = float_width_node(dt)
            if w is not None:
                base.pop(TAINT_F64, None)
                base.pop(TAINT_F32, None)
                k = width_taint_kind(w)
                if k is not None:
                    base[k] = (f"`.{fn.attr}("
                               f"{dotted_name(dt) or dt.value})` "
                               f"at line {node.lineno}")
            return base
        # x.double() / x.float() / x.half() / x.bfloat16(); x.int() /
        # x.long()
        if isinstance(fn, ast.Attribute) and not node.args \
                and not node.keywords:
            if fn.attr in TORCH_CAST_METHODS:
                base = dict(self.taint(fn.value))
                base.pop(TAINT_I32, None)
                base.pop(TAINT_F64, None)
                base.pop(TAINT_F32, None)
                k = width_taint_kind(TORCH_CAST_METHODS[fn.attr])
                if k is not None:
                    base[k] = f"`.{fn.attr}()` at line {node.lineno}"
                return base
            if fn.attr == "long":
                base = dict(self.taint(fn.value))
                base.pop(TAINT_I32, None)
                return base
        # np.int32(x), x.int() and friends
        if is_explicit_i32_expr(node):
            return {TAINT_I32: f"`{name or '.int'}()` cast at line "
                               f"{node.lineno}"}
        tail = name.rsplit(".", 1)[-1]
        # np.float64(x) explicit width casts
        if (node.args or node.keywords) and not isinstance(
                node.func, ast.Call):
            k = width_taint_kind(float_width_name(name))
            if k is not None:
                return {k: f"`{name}()` cast at line {node.lineno}"}
        # array ctors / cumsum with an explicit 32-bit dtype
        if tail in _ARRAY_CTORS or tail == "cumsum":
            dt = dtype_kw(node)
            if dt is None and tail in _ARRAY_CTORS and len(node.args) >= 2 \
                    and is_i32_dtype(node.args[-1]):
                dt = node.args[-1]
            if dt is not None:
                if is_i32_dtype(dt):
                    return {TAINT_I32: f"`{name}(dtype="
                                       f"{dotted_name(dt) or 'int32'})` "
                                       f"at line {node.lineno}"}
                k = width_taint_kind(float_width_node(dt))
                if k is not None:
                    return {k: f"`{name}(dtype="
                               f"{dotted_name(dt) or 'float'})` "
                               f"at line {node.lineno}"}
                return {}
            if tail in _PASSTHROUGH and node.args:
                return dict(self.taint(node.args[0]))
            return {}
        if tail in _PASSTHROUGH and node.args:
            return dict(self.taint(node.args[0]))
        target = self.resolve(node)
        if is_env_helper(target):
            return {TAINT_ENV: f"`{name}(...)`"}
        s = self.summaries.get(target) if target else None
        if s is not None and s.return_taints:
            return {k: f"return of `{target}` ({p})"
                    for k, p in s.return_taints.items()}
        return {}

    # ---- statements -----------------------------------------------------
    def _bind(self, target, taints):
        if isinstance(target, ast.Name):
            self.env[target.id] = dict(taints)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, taints)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, taints)

    def _elt_taints(self, value) -> dict:
        """arity -> per-element taints of a returned / assigned value: a
        tuple literal's elements, or a call's summarized elements."""
        if isinstance(value, ast.Tuple) and not any(
                isinstance(e, ast.Starred) for e in value.elts):
            return {len(value.elts): [self.taint(e) for e in value.elts]}
        if isinstance(value, ast.Call):
            s = self._call_summary(value)
            if s is not None and s.return_elts:
                target = self.resolve(value)
                return {n: [{k: f"return of `{target}` ({p})"
                             for k, p in elt.items()} for elt in elts]
                        for n, elts in s.return_elts.items()}
        return {}

    def _bind_elts(self, target, value) -> bool:
        """Bind a tuple target element-wise when the value's per-element
        taints are known for its arity."""
        if not isinstance(target, (ast.Tuple, ast.List)) or any(
                isinstance(e, ast.Starred) for e in target.elts):
            return False
        elts = self._elt_taints(value).get(len(target.elts))
        if elts is None:
            return False
        for e, t in zip(target.elts, elts):
            self._bind(e, t)
        return True

    def _record(self, targets, node, taints):
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names:
            return
        key = (node.lineno, node.col_offset)
        prev = self.assigns.get(key)
        if prev is not None:
            merged = dict(prev[2])
            for k, p in taints.items():
                merged.setdefault(k, p)
            taints = merged
            names = sorted(set(prev[0]) | set(names))
        self.assigns[key] = (names, node, taints)

    def _is_sync_stmt(self, st) -> bool:
        """An expression statement that waits for the card: the explicit
        syncs, or a call to a function whose own body does one."""
        if not isinstance(st, ast.Expr) or not isinstance(st.value,
                                                          ast.Call):
            return False
        if is_sync_call(st.value):
            return True
        s = self._call_summary(st.value)
        return s is not None and s.syncs

    def _clear_device(self) -> None:
        for var, t in self.env.items():
            if TAINT_DEVICE in t:
                self.env[var] = {k: p for k, p in t.items()
                                 if k != TAINT_DEVICE}

    def visit_stmt(self, st) -> None:
        """Hook for rule subclasses: called once per statement, in
        execution order, with the taint environment up to date (loop
        bodies re-run for loop-carried taints, so dedupe by position)."""

    def _exec(self, stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            self.visit_stmt(st)
            if self._is_sync_stmt(st):
                self._clear_device()
            elif isinstance(st, ast.Assign):
                t = self.taint(st.value)
                for target in st.targets:
                    if self._bind_elts(target, st.value):
                        continue
                    # tuple-unpacking a summarized return whose
                    # elements are not known for this arity would smear
                    # one element's device taint over host scalars in
                    # the same tuple (start, fronts, pool = helper()),
                    # so stay false-negative-leaning and drop DEVICE
                    # across such unpacks.  Direct results (a graph
                    # replay, a kernel entry) keep it.
                    if isinstance(target, (ast.Tuple, ast.List)) \
                            and TAINT_DEVICE in t \
                            and t[TAINT_DEVICE].startswith("return of "):
                        t2 = {k: p for k, p in t.items()
                              if k != TAINT_DEVICE}
                        self._bind(target, t2)
                    else:
                        self._bind(target, t)
                self._record(st.targets, st.value, t)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                t = self.taint(st.value)
                self._bind(st.target, t)
                self._record([st.target], st.value, t)
            elif isinstance(st, ast.AugAssign):
                t = self.taint(st.value)
                if isinstance(st.target, ast.Name):
                    merged = dict(self.env.get(st.target.id, ()))
                    for k, p in t.items():
                        merged.setdefault(k, p)
                    self.env[st.target.id] = merged
            elif isinstance(st, ast.Return):
                for k, p in self.taint(st.value).items():
                    self.returns.setdefault(k, p)
                for n, elts in self._elt_taints(st.value).items():
                    mine = self.return_elts.setdefault(
                        n, [{} for _ in range(n)])
                    for acc, t in zip(mine, elts):
                        for k, p in t.items():
                            acc.setdefault(k, p)
            elif isinstance(st, (ast.If,)):
                self._exec(st.body)
                self._exec(st.orelse)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._bind(st.target, self.taint(st.iter))
                self.loop_depth += 1
                self._exec(st.body)
                self._exec(st.body)       # loop-carried taints
                self.loop_depth -= 1
                self._exec(st.orelse)
            elif isinstance(st, ast.While):
                self.loop_depth += 1
                self._exec(st.body)
                self._exec(st.body)
                self.loop_depth -= 1
                self._exec(st.orelse)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    if item.optional_vars is not None:
                        self._bind(item.optional_vars,
                                   self.taint(item.context_expr))
                self._exec(st.body)
            elif isinstance(st, ast.Try):
                self._exec(st.body)
                for h in st.handlers:
                    self._exec(h.body)
                self._exec(st.orelse)
                self._exec(st.finalbody)


def _const_like(node) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _const_like(node.operand)
    if isinstance(node, ast.BinOp):
        return _const_like(node.left) and _const_like(node.right)
    return False
