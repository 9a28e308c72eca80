"""Package-wide call graph for the dataflow-aware slulint rules.

Purely lexical rules see little: SLU101 only a collective call
spelled directly inside the rank-conditioned branch, SLU103 only a
32-bit constructor assigned straight into an accumulator name.  The
deadly instances in a real tree hide behind one level of indirection —
a `_ship(tc, x)` wrapper whose body does the `bcast_any`, an `_alloc(n)`
helper whose `return np.zeros(n, dtype=np.int32)` flows into an indptr.
MPI tooling (MUST) long ago established that collective matching needs
whole-program reasoning; this module provides the static half.

The graph is *module-qualified*: every function definition in the
scanned tree gets a dotted qname (``superlu_dist_tpu_torch.parallel.pgssvx.
pgssvx``, ``bench._main``, nested defs as ``mod.outer.inner``, methods
as ``mod.Class.method``), imports are resolved to qnames, and every
``Call`` node is resolved where a sound target exists:

* plain names — nested defs in scope, module-level functions, imported
  names (``from m import f`` / ``import m as alias`` + ``alias.f``);
* ``self.method(...)`` — the enclosing class, then its bases
  (project-resolved, e.g. ``FaultyTreeComm`` -> ``TreeComm``);
* ``obj.method(...)`` — when ``obj``'s class is known from a parameter
  annotation (``tc: TreeComm``), a local ``obj = ClassName(...)``
  constructor, or a call to a function whose returns are a single known
  class (``make_treecomm`` -> ``TreeComm``).

Unresolvable calls stay unresolved — the rules treat them as opaque
(false-negative-leaning, the slulint contract).  Resolution results are
stored per path keyed by the Call node's (line, col), so rules can look
up *their own* parse of the same source without sharing AST objects.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from superlu_dist_tpu_torch.analysis.core import dotted_name


@dataclasses.dataclass
class FuncInfo:
    """One function/method definition in the project."""

    qname: str
    name: str
    path: str
    module: str
    node: object                       # ast.FunctionDef | AsyncFunctionDef
    cls: str | None = None             # owning class qname for methods
    parent: str | None = None          # enclosing function qname (nested)
    children: dict = dataclasses.field(default_factory=dict)  # name->qname
    calls: list = dataclasses.field(default_factory=list)     # callee qnames

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 0)


@dataclasses.dataclass
class ClassInfo:
    qname: str
    name: str
    module: str
    bases: list = dataclasses.field(default_factory=list)     # raw dotted
    methods: dict = dataclasses.field(default_factory=dict)   # name->qname


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: str
    tree: object
    imports: dict = dataclasses.field(default_factory=dict)   # local->qname
    import_modules: dict = dataclasses.field(default_factory=dict)
    functions: dict = dataclasses.field(default_factory=dict)  # name->qname
    classes: dict = dataclasses.field(default_factory=dict)    # name->qname


def module_name_for_path(path: str) -> str:
    """Dotted module name for a scanned file.  Files under the package
    tree get their importable name; scripts/examples/bench get a
    path-derived one; anything else falls back to the stem (single-file
    fixture scans)."""
    parts = list(os.path.normpath(path).split(os.sep))
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if "superlu_dist_tpu_torch" in parts:
        parts = parts[parts.index("superlu_dist_tpu_torch"):]
    else:
        parts = [p for p in parts if p not in ("", ".", "..", os.sep)][-2:]
    return ".".join(parts) or "module"


class Project:
    """The call graph + per-path call resolution + dataflow summaries
    (the summaries themselves are filled in by analysis.dataflow)."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}
        self.by_path: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        # per-path {(line, col) of a Call node: callee qname}
        self.call_sites: dict[str, dict] = {}
        # per-path {(line, col) of a FunctionDef: qname}
        self.func_sites: dict[str, dict] = {}
        # filled by dataflow.summarize(project)
        self.summaries: dict = {}

    # ---- lookups used by the rules -------------------------------------
    def call_target(self, path: str, call: ast.Call):
        """Resolved callee qname for a Call node of the rule's own parse
        of `path` (position-keyed), or None."""
        return self.call_sites.get(path, {}).get(
            (call.lineno, call.col_offset))

    def func_at(self, path: str, fn: ast.AST):
        qn = self.func_sites.get(path, {}).get(
            (fn.lineno, fn.col_offset))
        return self.functions.get(qn) if qn else None

    def summary(self, qname: str):
        return self.summaries.get(qname)

    def call_summary(self, path: str, call: ast.Call):
        qn = self.call_target(path, call)
        return self.summaries.get(qn) if qn else None


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def build_project(sources: dict) -> Project:
    """sources: {path: source} or {path: (source, tree)} — parse errors
    are skipped (the driver reports them as SLU100 separately)."""
    proj = Project()
    for path, src in sources.items():
        if isinstance(src, tuple):
            source, tree = src
        else:
            source, tree = src, None
        if tree is None:
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError:
                continue
        _index_module(proj, path, tree)
    for mod in proj.modules.values():
        _resolve_imports(proj, mod)
    by_module: dict = {}
    for fi in proj.functions.values():
        by_module.setdefault(fi.module, []).append(fi)
    for mod in proj.modules.values():
        _resolve_calls(proj, mod, by_module.get(mod.name, ()))
    from superlu_dist_tpu_torch.analysis import dataflow
    dataflow.summarize(proj)
    return proj


def _index_module(proj: Project, path: str, tree: ast.AST) -> None:
    name = module_name_for_path(path)
    if name in proj.modules:        # same-named module: last one wins for
        name = name + "@" + path    # by-name lookup, keep both by path
    mod = ModuleInfo(name=name, path=path, tree=tree)
    proj.modules[name] = mod
    proj.by_path[path] = mod
    proj.call_sites.setdefault(path, {})
    proj.func_sites.setdefault(path, {})

    def add_func(node, parent_q, cls_q):
        q = f"{parent_q}.{node.name}"
        fi = FuncInfo(qname=q, name=node.name, path=path, module=name,
                      node=node, cls=cls_q)
        proj.functions[q] = fi
        proj.func_sites[path][(node.lineno, node.col_offset)] = q
        return fi

    def walk_body(body, parent_q, cls_q=None, parent_fi=None):
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = add_func(st, parent_q, cls_q)
                if parent_fi is not None:
                    fi.parent = parent_fi.qname
                    parent_fi.children[st.name] = fi.qname
                if cls_q is not None:
                    proj.classes[cls_q].methods[st.name] = fi.qname
                elif parent_fi is None:
                    mod.functions[st.name] = fi.qname
                walk_body(st.body, fi.qname, None, fi)
            elif isinstance(st, ast.ClassDef):
                cq = f"{parent_q}.{st.name}"
                ci = ClassInfo(qname=cq, name=st.name, module=name,
                               bases=[dotted_name(b) for b in st.bases
                                      if dotted_name(b)])
                proj.classes[cq] = ci
                if parent_fi is None and cls_q is None:
                    mod.classes[st.name] = cq
                walk_body(st.body, cq, cq, None)

    walk_body(tree.body, name)


def _resolve_imports(proj: Project, mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                mod.import_modules[local] = target
        elif isinstance(node, ast.ImportFrom):
            if node.level:      # relative: anchor on this module's package
                base_parts = mod.name.split(".")[:-node.level]
                base = ".".join(base_parts + ([node.module]
                                              if node.module else []))
            else:
                base = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                mod.imports[local] = f"{base}.{alias.name}" if base \
                    else alias.name


def _class_of_callable(proj: Project, qname: str):
    """If `qname` names a class, or a function whose returns are all one
    known class's constructor, that class's qname."""
    if qname in proj.classes:
        return qname
    fi = proj.functions.get(qname)
    if fi is None:
        return None
    rets = set()
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Call):
                t = _lookup_name(proj, proj.modules[fi.module], fi,
                                 dotted_name(node.value.func))
                rets.add(t if t in proj.classes else None)
            else:
                rets.add(None)
    rets.discard(None)
    return rets.pop() if len(rets) == 1 else None


def _lookup_name(proj: Project, mod: ModuleInfo, fi, dotted: str):
    """Resolve a dotted name used inside function `fi` (or at module
    level when fi is None) to a project qname, or None."""
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    # nested defs visible in the enclosing-function chain
    cur = fi
    while cur is not None:
        if head in cur.children and not rest:
            return cur.children[head]
        cur = proj.functions.get(cur.parent) if cur.parent else None
    # module-level defs
    if head in mod.functions and not rest:
        return mod.functions[head]
    if head in mod.classes:
        cq = mod.classes[head]
        return _class_member(proj, cq, rest) if rest else cq
    # imported names
    if head in mod.imports:
        target = mod.imports[head]
        return _qualify(proj, target, rest)
    if head in mod.import_modules:
        target = mod.import_modules[head]
        return _qualify(proj, target, rest) if rest else None
    return None


def _qualify(proj: Project, base: str, rest: str):
    q = f"{base}.{rest}" if rest else base
    if q in proj.functions or q in proj.classes:
        return q
    # `import pkg.mod` + `pkg.mod.Class.method`-style chains
    if rest and q.rsplit(".", 1)[0] in proj.classes:
        return _class_member(proj, q.rsplit(".", 1)[0], q.rsplit(".", 1)[1])
    # target module might itself re-export; give the dotted name back so
    # semantic special-cases (env helpers) can match by suffix
    return q


def _class_member(proj: Project, cls_q: str, member: str, _depth=0):
    """Method lookup with base-class resolution (bounded)."""
    if _depth > 8 or not member:
        return None
    ci = proj.classes.get(cls_q)
    if ci is None:
        return None
    head, _, rest = member.partition(".")
    if head in ci.methods and not rest:
        return ci.methods[head]
    mod = proj.modules.get(ci.module)
    for base in ci.bases:
        bq = _lookup_name(proj, mod, None, base) if mod else None
        if bq and bq in proj.classes:
            hit = _class_member(proj, bq, member, _depth + 1)
            if hit:
                return hit
    return None


def _annotation_class(proj, mod, fi, ann):
    """Class qname for a parameter/variable annotation node."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value
    else:
        name = dotted_name(ann)
    if not name:
        return None
    q = _lookup_name(proj, mod, fi, name)
    return q if q in proj.classes else None


def _var_classes(proj: Project, mod: ModuleInfo, fi: FuncInfo) -> dict:
    """Local-variable -> class-qname map for one function: parameter
    annotations, `x = ClassName(...)` constructors, and calls to
    functions returning a single known class."""
    out = {}
    node = fi.node
    a = node.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs):
        cq = _annotation_class(proj, mod, fi, arg.annotation)
        if cq:
            out[arg.arg] = cq
    if fi.cls is not None and (a.posonlyargs + a.args):
        out.setdefault((a.posonlyargs + a.args)[0].arg, fi.cls)
    for st in ast.walk(node):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and st is not node:
            continue
        targets = []
        value = None
        if isinstance(st, ast.Assign):
            targets = [t.id for t in st.targets if isinstance(t, ast.Name)]
            value = st.value
        elif isinstance(st, ast.AnnAssign) and isinstance(st.target,
                                                          ast.Name):
            targets = [st.target.id]
            cq = _annotation_class(proj, mod, fi, st.annotation)
            if cq:
                out[st.target.id] = cq
            value = st.value
        if not targets or not isinstance(value, ast.Call):
            continue
        callee = _lookup_name(proj, mod, fi, dotted_name(value.func))
        cq = _class_of_callable(proj, callee) if callee else None
        if cq:
            for t in targets:
                out[t] = cq
    return out


def _resolve_calls(proj: Project, mod: ModuleInfo, fns) -> None:
    for fi in fns:
        var_cls = _var_classes(proj, mod, fi)
        for node in _own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            target = _resolve_one_call(proj, mod, fi, var_cls, node)
            if target is None:
                continue
            fi.calls.append(target)
            proj.call_sites[fi.path][(node.lineno, node.col_offset)] = \
                target
    # module-level calls (scripts run them)
    for node in _module_level_nodes(mod.tree):
        if isinstance(node, ast.Call):
            target = _resolve_one_call(proj, mod, None, {}, node)
            if target is not None:
                proj.call_sites[mod.path][(node.lineno,
                                           node.col_offset)] = target


def _own_nodes(fn):
    """Every node lexically inside `fn`, nested defs included (calls in
    a nested def still resolve in the enclosing module scope)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _module_level_nodes(tree):
    stack = [st for st in tree.body
             if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


def _resolve_one_call(proj, mod, fi, var_cls, call: ast.Call):
    func = call.func
    if isinstance(func, ast.Name):
        return _lookup_name(proj, mod, fi, func.id)
    if isinstance(func, ast.Attribute):
        # receiver-typed method call: self/annotated/constructed var
        if isinstance(func.value, ast.Name):
            recv = func.value.id
            cq = var_cls.get(recv)
            if cq is None and recv == "self" and fi is not None \
                    and fi.cls is not None:
                cq = fi.cls
            if cq is not None:
                hit = _class_member(proj, cq, func.attr)
                if hit:
                    return hit
        # dotted module path (mod.f / pkg.mod.Class(...))
        return _lookup_name(proj, mod, fi, dotted_name(func))
    return None
