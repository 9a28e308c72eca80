"""SLU102 capture purity, SLU105 graph-cache-key hygiene, SLU107
graph-key shape diversity.

Port of the JAX package's ``analysis/rules_trace.py``.  There the rules
watch jitted bodies and ``lru_cache``d jit factories; the port has no
jit, but its counterpart is the CUDA graph: a body captured once and
replayed for every later call, kept in a cache keyed by a Python tuple.
The same three bugs carry over.

SLU102 — host coercions inside a capture body.  ``.item()``,
``.cpu()``, ``.numpy()``, ``.tolist()`` and ``float()`` / ``int()`` /
``bool()`` on a tensor (a torch call or a tensor reduction) wait for the
card, which a capture cannot do: the capture fails, or the value is read
once and baked into the graph.  An ``os.environ`` read (or a
``utils.options.env_*`` call) inside a capture body is read once, at
the capture, and every replay keeps it.  A capture body is a callable
passed to ``fused.Graph(...)``, the statements between
``capture_begin`` and ``capture_end``, and the body of ``with
torch.cuda.graph(...)``; the rule follows the call graph from there
into every function the body reaches, within numeric/, solve/, ops/ and
parallel/ of the package tree (everywhere outside it), and flags the
coercion where it is written.  A capture written inside ``with
grid.recording()`` stops at ``ProcessGrid``'s collectives
(parallel/grid.py): a capture on an NCCL grid holds them, and while the
grid records they do no host work; outside ``recording`` the rule
follows them into their verify checks and host reads.

SLU105 — inputs of a cached graph's construction that its key misses.
A graph cache is an ``lru_cache``d factory that captures a graph (the JAX rule:
env reads, enclosing-function locals and helpers that reach an env read
are flagged), or a dict store ``cache[key] = value`` whose value builds
graphs — a capture, a call of a function that captures, or the
constructor of a class that does (``numeric/factor.get_executor``'s
executors, ``DeviceSolver._graphs``, mega's ``_buckets``, the grid's
segment lists).  Flagged: an env read that feeds the construction, and
a local of the storing function that it reads but that neither
the key, the container, nor a value derived only from them covers — two
configurations then share one graph, and the second replays the first's.

SLU107 — raw (unbucketed) sizes in a graph-cache key.  A key fed
``len(x)``, ``x.shape``, ``x.numel()`` or ``x.size`` captures one graph
per distinct size, so the graph count grows with the data.  Flagged: a
call of an ``lru_cache``d capturing factory, or a dict-cache key, whose
expression holds such a size with no bucketing call (a name containing
"bucket" / "rung" / "ladder") in the same expression.

Lexical and false-negative-leaning like every slulint rule; a finding
that is not a bug gets a pragma with its reason.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import (PACKAGE, Rule, _norm_parts,
                                                  dotted_name, is_env_read)
from superlu_dist_tpu_torch.analysis.dataflow import is_env_helper

_COERCIONS = frozenset({"float", "int", "bool"})
_HOST_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})
#: methods whose result is a tensor (a coercion of it waits for the card)
_TENSOR_METHODS = frozenset({"sum", "max", "min", "amax", "amin", "any",
                             "all", "abs", "norm", "mean", "prod",
                             "count_nonzero", "isfinite", "isnan"})
_HOT_DIRS = ("numeric", "solve", "ops", "parallel")
#: ProcessGrid's collectives (parallel/grid.py), which a capture may hold
#: on an NCCL grid: inside ``ProcessGrid.recording`` each does no host
#: work (verify mode's checks wait for ``check_tape``, outside the
#: capture), so the reach of a capture written in that block stops at
#: them
_CAPTURED_COLLECTIVES = frozenset(
    f"{PACKAGE}.parallel.grid.ProcessGrid.{m}"
    for m in ("all_gather", "bcast_row", "all_reduce_row", "exchange",
              "gather_rows", "all_reduce_sum"))
_BUCKETIZER_HINTS = ("bucket", "rung", "ladder")


# ---------------------------------------------------------------------------
# what a capture is
# ---------------------------------------------------------------------------

def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _is_graph_ctor(node: ast.AST) -> bool:
    """``Graph(...)`` (numeric/fused.Graph) or ``torch.cuda.CUDAGraph()``."""
    return isinstance(node, ast.Call) \
        and _last(dotted_name(node.func)) in ("Graph", "CUDAGraph")


def _is_capture_call(node: ast.AST) -> bool:
    """A node that captures a graph: a graph constructor, a
    ``capture_begin``, a ``torch.cuda.graph(...)`` context."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return (_last(name) in ("Graph", "CUDAGraph", "capture_begin")
            or name in ("torch.cuda.graph", "cuda.graph"))


def _walk_no_defs(node: ast.AST):
    """Nodes under ``node``, nested defs and classes excluded (lambdas
    included: a capture body is often one)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(sub))


def _contains_capture(fn) -> bool:
    return any(_is_capture_call(n) for n in ast.walk(fn))


def _has_call(node: ast.AST, attr: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == attr for n in ast.walk(node))


def _stmt_lists(fn):
    """Every statement list in ``fn``'s own body (nested defs excluded)."""
    todo = [fn.body]
    while todo:
        body = todo.pop()
        yield body
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    todo.append(sub)
            for h in getattr(st, "handlers", ()):
                todo.append(h.body)


def capture_regions(fn) -> list:
    """The capture bodies written in ``fn``: [(anchor, [nodes])] — the
    statements between a ``capture_begin`` and the statement that ends
    it (a ``try``'s body included), the body of ``with
    torch.cuda.graph(...)``, and a lambda passed to ``Graph(...)``."""
    out = []
    for body in _stmt_lists(fn):
        for i, st in enumerate(body):
            if isinstance(st, ast.Expr) and _has_call(st, "capture_begin"):
                region = []
                for nxt in body[i + 1:]:
                    if _has_call(nxt, "capture_end"):
                        if isinstance(nxt, ast.Try):
                            region += nxt.body
                        break
                    region.append(nxt)
                out.append((st, region))
            elif isinstance(st, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and dotted_name(it.context_expr.func)
                    in ("torch.cuda.graph", "cuda.graph")
                    for it in st.items):
                out.append((st, list(st.body)))
    for node in _walk_no_defs(fn):
        if isinstance(node, ast.Call) \
                and _last(dotted_name(node.func)) == "Graph":
            body = _graph_fn(node)
            if isinstance(body, ast.Lambda):
                out.append((node, [body.body]))
    return out


def _graph_fn(call: ast.Call):
    """The callable argument of a ``Graph(...)`` call."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "fn":
            return kw.value
    return None


def _hot(path: str) -> bool:
    parts = _norm_parts(path)
    if PACKAGE not in parts:
        return True
    inner = parts[parts.index(PACKAGE) + 1:]
    return any(d in inner for d in _HOT_DIRS)


def _recorded(fn) -> set:
    """ids of the nodes of ``fn`` (nested defs excluded) written inside a
    ``with <grid>.recording()`` block."""
    out = set()
    for node in _walk_no_defs(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and _last(dotted_name(it.context_expr.func)) == "recording"
                for it in node.items):
            for st in node.body:
                out.add(id(st))
                out.update(id(n) for n in _walk_no_defs(st))
    return out


def _region_nodes(region):
    for st in region:
        yield st
        yield from _walk_no_defs(st)


def capture_reach(project) -> tuple:
    """(reached, regions): the functions a capture body reaches, {qname:
    witness}, and the capture bodies written in each file, {path:
    [(witness, [nodes])]} — computed once per project."""
    hit = getattr(project, "_capture_reach", None)
    if hit is not None:
        return hit
    regions, reached, todo = {}, {}, []
    for q, fi in project.functions.items():
        mod = project.by_path.get(fi.path)
        recorded = _recorded(fi.node)
        for anchor, region in capture_regions(fi.node):
            witness = (f"the capture at {fi.path}:"
                       f"{getattr(anchor, 'lineno', 0)}")
            regions.setdefault(fi.path, []).append((witness, region))
            rec = id(anchor) in recorded
            for node in _region_nodes(region):
                if isinstance(node, ast.Call):
                    t = project.call_target(fi.path, node)
                    if t in project.functions:
                        todo.append((t, witness, rec))
        for node in _walk_no_defs(fi.node):
            if isinstance(node, ast.Call) \
                    and _last(dotted_name(node.func)) == "Graph":
                body = _graph_fn(node)
                name = dotted_name(body) if body is not None else ""
                if body is not None and isinstance(body, ast.Call) \
                        and _last(dotted_name(body.func)) == "partial" \
                        and body.args:
                    name = dotted_name(body.args[0])
                if name and not isinstance(body, ast.Lambda):
                    t = fi.children.get(name) or (
                        mod.functions.get(name) if mod else None)
                    if t in project.functions:
                        todo.append((t, f"the capture at {fi.path}:"
                                        f"{node.lineno}",
                                     id(node) in recorded))
    # a function reached from a recording capture and from one that does
    # not record is walked for each: only the latter follows it into the
    # grid's collectives
    walked = set()
    while todo:
        q, witness, rec = todo.pop()
        if (q, rec) in walked or (rec and q in _CAPTURED_COLLECTIVES) \
                or not _hot(project.functions[q].path):
            continue
        walked.add((q, rec))
        reached.setdefault(q, witness)
        todo.extend((c, witness, rec) for c in project.functions[q].calls
                    if c in project.functions and (c, rec) not in walked)
    project._capture_reach = (reached, regions)
    return reached, regions


def _tensorish(node: ast.AST) -> bool:
    """The argument of a coercion evidently is a tensor: a torch call or
    a tensor reduction."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name.startswith("torch."):
        return True
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr in _TENSOR_METHODS


# ---------------------------------------------------------------------------
# SLU102
# ---------------------------------------------------------------------------

class CapturePurityRule(Rule):
    rule_id = "SLU102"
    title = "capture-purity"
    hint = ("keep host coercions and env reads OUT of captured code: "
            "resolve configuration before the capture and close over the "
            "value, and keep results on the card — a coercion waits for "
            "the card, which a capture cannot hold (it fails, or bakes "
            "the value into every replay)")
    package_dirs = _HOT_DIRS

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        reached, regions = capture_reach(project)
        out = []
        for q, fi in project.functions.items():
            if fi.path == path and q in reached:
                out += self._scan(project, path, _walk_no_defs(fi.node),
                                  f"`{fi.name}`, reached from "
                                  f"{reached[q]}")
        for witness, region in regions.get(path, ()):
            out += self._scan(project, path, _region_nodes(region),
                              witness)
        seen, uniq = set(), []
        for f in out:
            if (f.line, f.col) not in seen:
                seen.add((f.line, f.col))
                uniq.append(f)
        return uniq

    def _scan(self, project, path, nodes, where):
        out = []
        for node in nodes:
            env = is_env_read(node)
            if env is not None:
                out.append(self.finding(
                    path, env[1],
                    f"os.environ read inside a capture body ({where}) — "
                    "read once at the capture, kept by every replay"))
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if is_env_helper(project.call_target(path, node)):
                out.append(self.finding(
                    path, node,
                    f"`{_last(name)}()` env read inside a capture body "
                    f"({where}) — read once at the capture, kept by "
                    "every replay"))
            elif name in _COERCIONS and node.args \
                    and _tensorish(node.args[0]):
                out.append(self.finding(
                    path, node,
                    f"`{name}()` of a tensor inside a capture body "
                    f"({where}) — a host sync the capture cannot hold"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_METHODS:
                out.append(self.finding(
                    path, node,
                    f"`.{node.func.attr}()` inside a capture body "
                    f"({where}) — a device-to-host copy the capture "
                    "cannot hold"))
        return out


# ---------------------------------------------------------------------------
# SLU105 / SLU107: the graph caches
# ---------------------------------------------------------------------------

def _is_lru_decorator(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        node = node.func
    return dotted_name(node) in ("lru_cache", "functools.lru_cache",
                                 "cache", "functools.cache")


def _capturing_factory(fn) -> bool:
    return isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
        and any(_is_lru_decorator(d) for d in fn.decorator_list) \
        and _contains_capture(fn)


def _bound_names(fn) -> set:
    """Names bound in a function's own scope (its locals)."""
    bound = set()
    a = fn.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs
                + ([a.vararg] if a.vararg else [])
                + ([a.kwarg] if a.kwarg else [])):
        bound.add(arg.arg)
    for node in _walk_no_defs(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            bound.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound.add((alias.asname or alias.name).split(".")[0])
    return bound


def _lambda_params(node: ast.AST) -> set:
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Lambda):
            a = sub.args
            out |= {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    return out


def _loads(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _siblings(fn) -> dict:
    """{name: the other names bound by the same for-loop target}: one
    item of the iterable binds them together."""
    out = {}
    for node in _walk_no_defs(fn):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            names = {n.id for n in ast.walk(node.target)
                     if isinstance(n, ast.Name)}
            for n in names:
                out.setdefault(n, set()).update(names - {n})
    return out


def _imported(fn) -> set:
    out = set()
    for node in _walk_no_defs(fn):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
    return out


def _definitions(fn) -> dict:
    """{local name: [expressions it is bound from]} in ``fn``'s own body:
    assignments (a tuple target binds each of its names to the whole
    value) and for loops (each target name to the iterable)."""
    defs = {}

    def bind(target, value):
        if isinstance(target, ast.Name):
            defs.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                bind(elt, value)
        elif isinstance(target, ast.Starred):
            bind(target.value, value)

    for node in _walk_no_defs(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bind(t, node.value)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None:
            bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            bind(node.target, node.iter)
        elif isinstance(node, ast.comprehension):
            bind(node.target, node.iter)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for it in node.items:
                if it.optional_vars is not None:
                    bind(it.optional_vars, it.context_expr)
    return defs


def _graph_capturers(project) -> tuple:
    """(functions, classes) that capture graphs: functions whose own body
    captures, classes with such a method (or a base that has one)."""
    hit = getattr(project, "_graph_capturers", None)
    if hit is not None:
        return hit
    fns = {q for q, fi in project.functions.items()
           if any(_is_capture_call(n) for n in _walk_no_defs(fi.node))}
    classes = {fi.cls for q, fi in project.functions.items()
               if q in fns and fi.cls}
    changed = True
    while changed:
        changed = False
        for cq, ci in project.classes.items():
            if cq in classes:
                continue
            mod = project.modules.get(ci.module)
            for base in ci.bases:
                bq = None
                if mod is not None:
                    bq = mod.classes.get(base) or mod.imports.get(base)
                if bq in classes:
                    classes.add(cq)
                    changed = True
                    break
    project._graph_capturers = (fns, classes)
    return fns, classes


def _is_bucketized(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = _last(dotted_name(sub.func)).lower()
            if any(h in name for h in _BUCKETIZER_HINTS):
                return True
    return False


def _raw_dim(node: ast.AST):
    """The first raw size read in the expression: ``len()``, ``.shape``,
    ``.numel()``, ``.size`` — (label, anchor) or None."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and dotted_name(sub.func) == "len":
            return "len(...)", sub
        if isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Load):
            if sub.attr in ("shape", "size"):
                return f".{sub.attr}", sub
            if sub.attr == "numel":
                return ".numel()", sub
    return None


def _dict_caches(fn, path, project):
    """The graph-cache stores of ``fn``: [(Assign node, container expr,
    key expr, capture-body nodes)] — ``C[K] = V`` where V, or what the
    names V holds are bound from, builds graphs: it captures, or calls a
    function or constructs a class that does.  The capture bodies are
    ``fn``'s, for a V that is a ``CUDAGraph`` captured in place."""
    defs = _definitions(fn)
    fns, classes = _graph_capturers(project) if project is not None \
        else (set(), set())
    out = []
    stores = [(node, t) for node in _walk_no_defs(fn)
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Subscript)]
    for node, store in stores:
        exprs = [node.value] + [d for name in _held(node.value)
                                for d in defs.get(name, ())]
        calls = [sub for e in exprs for sub in ast.walk(e)
                 if isinstance(sub, ast.Call)]
        builds = any(_is_graph_ctor(c) for c in calls) or (
            project is not None
            and any(project.call_target(path, c) in fns | classes
                    for c in calls))
        if not builds:
            continue
        regions = []
        if any(_last(dotted_name(c.func)) == "CUDAGraph" for c in calls):
            regions = [n for _, region in capture_regions(fn)
                       for n in _region_nodes(region)]
        out.append((node, store.value, store.slice, regions))
    return out


def _held(value) -> set:
    """The names a stored value is, or holds as a tuple's elements."""
    if isinstance(value, ast.Name):
        return {value.id}
    if isinstance(value, ast.Tuple):
        return {e.id for e in value.elts if isinstance(e, ast.Name)}
    return set()


class GraphCacheKeyRule(Rule):
    rule_id = "SLU105"
    title = "graph-cache-key-hygiene"
    hint = ("everything a cached graph's construction reads must be in "
            "the cache key (or come from the container that owns the cache): "
            "resolve env and configuration before the cache and put the "
            "value in the key, as numeric/factor.get_executor keys its "
            "executors")

    def __init__(self, interprocedural: bool = True):
        self.interprocedural = interprocedural

    def check(self, tree, source, path, project=None):
        proj = project if self.interprocedural else None
        findings = []
        self._scan(tree.body, [], path, findings, proj)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for cache in _dict_caches(fn, path, proj):
                    findings += self._check_store(fn, cache, path, proj)
        return findings

    # ---- lru_cache factories (the JAX rule) ------------------------------
    def _scan(self, stmts, enclosing, path, findings, project):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _capturing_factory(st):
                    self._check_factory(st, enclosing, path, findings,
                                        project)
                self._scan(st.body, enclosing + [st], path, findings,
                           project)
            elif isinstance(st, ast.ClassDef):
                self._scan(st.body, enclosing, path, findings, project)
            elif isinstance(st, (ast.If, ast.For, ast.AsyncFor, ast.While)):
                self._scan(st.body, enclosing, path, findings, project)
                self._scan(st.orelse, enclosing, path, findings, project)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                self._scan(st.body, enclosing, path, findings, project)
            elif isinstance(st, ast.Try):
                for block in ([st.body, st.orelse, st.finalbody]
                              + [h.body for h in st.handlers]):
                    self._scan(block, enclosing, path, findings, project)

    def _env(self, node, project, path, what):
        """A finding for an env read at ``node`` (direct, or a call that
        reaches one through the call graph), or None."""
        env = is_env_read(node)
        if env is not None:
            return self.finding(
                path, env[1],
                f"env read inside {what} — the value selects the "
                "captured graph but is not part of the cache key")
        if project is not None and isinstance(node, ast.Call):
            target = project.call_target(path, node)
            s = project.summaries.get(target) if target else None
            if s is not None and s.reaches_env is not None:
                owner, witness = s.reaches_env
                return self.finding(
                    path, node,
                    f"{what} calls `{target.rsplit('.', 2)[-1]}` which "
                    f"reaches an env read ({witness} via `{owner}`) — the "
                    "value selects the captured graph but is not part of "
                    "the cache key")
        return None

    def _check_factory(self, fn, enclosing, path, findings, project):
        what = f"lru_cached graph factory `{fn.name}`"
        for node in ast.walk(fn):
            f = self._env(node, project, path, what)
            if f is not None:
                findings.append(f)
        if not enclosing:
            return
        outer = set()
        for e in enclosing:
            outer |= _bound_names(e)
        own = _bound_names(fn) | _lambda_params(fn)
        flagged = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)\
                    and node.id in outer and node.id not in own \
                    and node.id not in flagged:
                flagged.add(node.id)
                findings.append(self.finding(
                    path, node,
                    f"{what} closes over `{node.id}` from an enclosing "
                    "function — it shapes the captured graph but is "
                    "missing from the cache key"))

    # ---- dict caches -------------------------------------------------------
    def _check_store(self, fn, cache, path, project):
        node, container, key, regions = cache
        defs, sibs = _definitions(fn), _siblings(fn)
        local = _bound_names(fn) - _imported(fn)
        # the key and the container cover what their names are bound
        # from and the names a for-loop binds with them (``keyed``); a
        # name bound only from covered names is covered too
        keyed = (_loads(key) | _loads(container)) & local | {"self"}
        todo = list(keyed)
        while todo:
            name = todo.pop()
            new = set(sibs.get(name, ()))
            for s in defs.get(name, ()):
                new |= _loads(s) & local
            todo += new - keyed
            keyed |= new
        covered = set(keyed)
        changed = True
        while changed:
            changed = False
            for name in local - covered:
                srcs = defs.get(name)
                if srcs and all((_loads(s) & local) <= covered
                                for s in srcs):
                    covered.add(name)
                    changed = True
        # what builds the stored value: the value, the definitions of the
        # names it holds that the key does not hold, the capture bodies
        held = _held(node.value)
        sources = [node.value] + [d for name in held - keyed
                                   for d in defs.get(name, ())] + regions
        label = dotted_name(container) or "<cache>"
        what = f"the graph cache `{label}` in `{fn.name}`"
        out, seen = [], set()
        for b in sources:
            for sub in ast.walk(b):
                f = self._env(sub, project, path, what)
                if f is not None and (f.line, f.col) not in seen:
                    seen.add((f.line, f.col))
                    out.append(f)
        lparams = set()
        for b in sources:
            lparams |= _lambda_params(b)
        missing = []
        for b in sources:
            for sub in ast.walk(b):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load) \
                        and sub.id in local and sub.id not in covered \
                        and sub.id not in lparams | held \
                        and sub.id not in {m.id for m in missing}:
                    missing.append(sub)
        for sub in missing:
            # anchored at the store: the cache's one place for a pragma
            out.append(self.finding(
                path, node,
                f"{what} builds from `{sub.id}`, which the key "
                f"`{ast.unparse(key)[:60]}` does not hold — two calls "
                "that differ in it share one graph"))
        return out


class GraphKeyShapeDiversityRule(Rule):
    rule_id = "SLU107"
    title = "graph-key-shape-diversity"
    hint = ("round raw sizes onto the canonical bucket ladder before they "
            "enter a graph-cache key (numeric/plan.bucket_rung, "
            "solve/plan's nrhs buckets): a key fed len(x) / x.shape / "
            "x.numel() captures one graph per distinct size")

    def check(self, tree, source, path, project=None):
        factories = {fn.name for fn in ast.walk(tree)
                     if _capturing_factory(fn)}
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and factories \
                    and _last(dotted_name(node.func)) in factories:
                fname = _last(dotted_name(node.func))
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    findings += self._raw(
                        path, arg, f"lru_cached graph factory `{fname}` "
                                   "called with")
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defs = _definitions(fn)
            for _, container, key, _ in _dict_caches(fn, path, project):
                exprs = [key]
                if isinstance(key, ast.Name):
                    exprs += [d for d in defs.get(key.id, ())
                              if d is not key]
                label = dotted_name(container) or "<cache>"
                for e in exprs:
                    findings += self._raw(
                        path, e, f"the graph cache `{label}` in "
                                 f"`{fn.name}` keyed with")
        return findings

    def _raw(self, path, expr, what):
        if _is_bucketized(expr):
            return []
        raw = _raw_dim(expr)
        if raw is None:
            return []
        return [self.finding(
            path, raw[1],
            f"{what} a raw (unbucketed) dimension `{raw[0]}` — every "
            "distinct size captures a fresh graph, so the graph count "
            "grows with the data instead of staying a closed bucket set")]
