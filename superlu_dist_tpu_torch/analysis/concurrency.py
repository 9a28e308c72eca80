"""Concurrency lattice for the slulint thread-safety rules (SLU108-110).

The serving and reliability tiers run a real thread population —
heartbeat daemon, ``SolveServer`` dispatcher, background scrubber — and
their correctness rests on the same disciplined shared-state access the
reference trusts its process grid and atomics with (PAPER.md L0/L8).
This module resolves the raw lock/blocking facts the dataflow pass
collects (``Summary.acquires_raw`` / ``blocking_raw``) into a
project-wide model the three concurrency rules share:

* **class tables** — per class: which ``self.X`` attributes are locks /
  conditions / events / threads (recognized by their constructor:
  ``threading.Lock()``, ``Condition(...)``, the instrumented
  ``utils.lockwatch.make_lock(...)`` twins), with a ``Condition(lock)``
  aliased onto the lock it wraps so both guard ONE identity;
* **module tables** — module-level lock globals (``_REG_LOCK = ...``);
* **thread sides** — ``threading.Thread(target=...)`` targets resolved
  through the call graph, plus their transitive same-class callees:
  the set of methods that execute on a background thread;
* **lock-context methods** — methods whose every in-class call site is
  under a guard (or whose name carries the ``*_locked`` convention):
  their bodies are effectively guarded even without their own ``with``;
* **the global lock-acquisition graph** — edge ``A -> B`` whenever B is
  acquired (directly, or transitively through a resolved call) while A
  is held, each edge carrying its witness sites.  SLU109 reports its
  cycles; the runtime twin (``utils/lockwatch.py``,
  ``SLU_TPU_VERIFY_LOCKS=1``) checks the same graph on live executions.

Everything stays false-negative-leaning (the slulint contract): an
unresolvable thread target, lock identity, or call edge is dropped, not
guessed.

Port of the JAX package's ``analysis/concurrency.py``; a
``torch.cuda.Event`` is not a thread event here.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import dotted_name
from superlu_dist_tpu_torch.analysis.dataflow import _MUTATOR_METHODS

#: constructor-name tail -> lock kind ("lock" and "cond" attrs guard
#: shared state; "event" attrs are their own synchronization)
LOCK_CTORS = {
    "Lock": "lock", "RLock": "lock", "Semaphore": "lock",
    "BoundedSemaphore": "lock", "make_lock": "lock", "make_rlock": "lock",
    "Condition": "cond", "make_condition": "cond",
    "Event": "event", "make_event": "event",
}


def lock_ctor_kind(call: ast.AST):
    if not isinstance(call, ast.Call):
        return None
    name = dotted_name(call.func)
    if name.startswith(("torch.", "cuda.")):
        return None          # torch.cuda.Event orders streams, not threads
    return LOCK_CTORS.get(name.rsplit(".", 1)[-1])


def _is_thread_ctor(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and \
        dotted_name(call.func).rsplit(".", 1)[-1] == "Thread"


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _site(path: str, line: int) -> str:
    return f"{path}:{line}"


class ClassModel:
    """Lock / event / thread attribute tables for one class."""

    def __init__(self, qname: str):
        self.qname = qname
        self.lock_attrs: dict = {}      # attr -> "lock" | "cond"
        self.event_attrs: set = set()
        self.cond_alias: dict = {}      # cond attr -> wrapped lock attr
        self.thread_attrs: dict = {}    # attr -> (target qname|None,
                                        #          daemon, path, line)
        self.thread_entries: dict = {}  # target qname -> (path, line)
        self.thread_side: set = set()   # qnames running on a thread
        self.methods: dict = {}         # name -> qname
        self.joined_attrs: set = set()  # thread attrs .join()ed somewhere

    def guard_attrs(self) -> set:
        return set(self.lock_attrs)

    def lock_id(self, attr: str) -> str:
        """Canonical lock identity: a Condition wrapping a lock shares
        the wrapped lock's identity (one mutex underneath)."""
        return f"{self.qname}.{self.cond_alias.get(attr, attr)}"


class Model:
    """The resolved project-wide concurrency model (built once per
    Project and cached on it — every rule shares one instance)."""

    def __init__(self, proj):
        self.proj = proj
        self.classes: dict[str, ClassModel] = {}
        self.module_locks: dict = {}    # module -> {var: kind}
        self.lock_context: set = set()  # method qnames effectively guarded
        # transitive lock acquisitions per function:
        # qname -> {lock_id: (site, via-description)}
        self.t_acquires: dict = {}
        # the global lock graph: (a, b) -> (site_of_b_acquire, via)
        self.edges: dict = {}
        self._build()

    # ------------------------------------------------------------------
    def class_functions(self, cq: str) -> list:
        """The functions whose owning class (:meth:`class_for`) is class
        ``cq`` — its methods and their nested defs — in project order."""
        table = getattr(self, "_class_functions", None)
        if table is None:
            table = {}
            for q, fi in self.proj.functions.items():
                cm = self.class_for(fi)
                if cm is not None and q.startswith(cm.qname + "."):
                    table.setdefault(cm.qname, []).append(fi)
            self._class_functions = table
        return table.get(cq, [])

    def class_for(self, fi) -> ClassModel | None:
        """The owning ClassModel for a function (methods and their
        nested defs both resolve to the enclosing class)."""
        cur = fi
        while cur is not None:
            if cur.cls is not None:
                return self.classes.get(cur.cls)
            cur = self.proj.functions.get(cur.parent) if cur.parent \
                else None
        return None

    # ------------------------------------------------------------------
    def _build(self) -> None:
        proj = self.proj
        for cq in proj.classes:
            self.classes[cq] = ClassModel(cq)
        for cq, ci in proj.classes.items():
            self.classes[cq].methods = dict(ci.methods)
        for mod in proj.modules.values():
            self._scan_module_locks(mod)
        for fi in proj.functions.values():
            if fi.cls is not None:
                self._scan_class_method(self.classes[fi.cls], fi)
        self._resolve_thread_sides()
        self._compute_lock_contexts()
        self._compute_acquires()
        self._build_edges()

    def _scan_module_locks(self, mod) -> None:
        table = {}
        for st in mod.tree.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                kind = lock_ctor_kind(st.value)
                if kind in ("lock", "cond"):
                    table[st.targets[0].id] = kind
        if table:
            self.module_locks[mod.name] = table

    def _scan_class_method(self, cm: ClassModel, fi) -> None:
        from superlu_dist_tpu_torch.analysis.callgraph import (_class_member,
                                                               _lookup_name)
        mod = self.proj.modules.get(fi.module)

        def resolve_target(expr):
            if isinstance(expr, ast.Attribute) \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self":
                return _class_member(self.proj, cm.qname, expr.attr)
            name = dotted_name(expr)
            if name and mod is not None:
                return _lookup_name(self.proj, mod, fi, name)
            return None

        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    kind = lock_ctor_kind(node.value)
                    if kind in ("lock", "cond"):
                        cm.lock_attrs[tgt.attr] = kind
                        if kind == "cond":
                            # Condition(self._lock) — and the
                            # make_condition(name, self._lock) twin —
                            # share the wrapped lock's identity
                            cands = list(node.value.args) + \
                                [kw.value for kw in node.value.keywords]
                            for arg in cands:
                                if isinstance(arg, ast.Attribute) \
                                        and isinstance(arg.value,
                                                       ast.Name) \
                                        and arg.value.id == "self":
                                    cm.cond_alias[tgt.attr] = arg.attr
                                    break
                    elif kind == "event":
                        cm.event_attrs.add(tgt.attr)
                    elif _is_thread_ctor(node.value):
                        target = _kw(node.value, "target")
                        tq = resolve_target(target) if target is not None \
                            else None
                        daemon = _kw(node.value, "daemon")
                        cm.thread_attrs[tgt.attr] = (
                            tq,
                            bool(getattr(daemon, "value", False)),
                            fi.path, node.lineno)
                        if tq:
                            cm.thread_entries[tq] = (fi.path, node.lineno)
            elif isinstance(node, ast.Call):
                if _is_thread_ctor(node):
                    target = _kw(node, "target")
                    tq = resolve_target(target) if target is not None \
                        else None
                    if tq:
                        cm.thread_entries.setdefault(
                            tq, (fi.path, node.lineno))
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr == "join" \
                        and isinstance(fn.value, ast.Attribute) \
                        and isinstance(fn.value.value, ast.Name) \
                        and fn.value.value.id == "self":
                    cm.joined_attrs.add(fn.value.attr)

    def _resolve_thread_sides(self) -> None:
        """BFS from each class's thread entries over resolved call edges,
        restricted to functions lexically inside the class (only they
        can touch ``self.*`` state)."""
        for cm in self.classes.values():
            if not cm.thread_entries:
                continue
            seen = set()
            work = [q for q in cm.thread_entries if q in
                    self.proj.functions]
            prefix = cm.qname + "."
            while work:
                q = work.pop()
                if q in seen or not q.startswith(prefix):
                    continue
                seen.add(q)
                fi = self.proj.functions.get(q)
                if fi is None:
                    continue
                work.extend(fi.calls)
                work.extend(fi.children.values())
            cm.thread_side = seen

    def _compute_lock_contexts(self) -> None:
        """Methods whose every in-class call site sits under a guard (or
        under another lock-context method) are effectively guarded —
        the ``_take_batch`` / ``*_locked`` caller-holds-the-lock idiom."""
        # seed: the naming convention is an explicit assertion
        for q in self.proj.functions:
            if q.rsplit(".", 1)[-1].endswith("_locked"):
                self.lock_context.add(q)
        # call sites of class methods: qname -> [(caller, guarded)]
        sites: dict = {}
        for fi in self.proj.functions.values():
            cm = self.class_for(fi)
            for node, locks in self._held_spans(cm, fi):
                if not isinstance(node, ast.Call):
                    continue
                target = self.proj.call_target(fi.path, node)
                tfi = self.proj.functions.get(target)
                if tfi is not None and tfi.cls is not None:
                    sites.setdefault(target, []).append(
                        (fi.qname, bool(locks)))
        changed = True
        while changed:
            changed = False
            for q, callers in sites.items():
                if q in self.lock_context:
                    continue
                if callers and all(g or c in self.lock_context
                                   for c, g in callers):
                    self.lock_context.add(q)
                    changed = True

    def _held_spans(self, cm: ClassModel | None, fi):
        """[(node, held-lock-ids)] for every node in `fi`'s own body
        (nested defs excluded — they run in their own context)."""
        out = []

        def walk(node, held):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    acquired = list(held)
                    for item in child.items:
                        lid = self._lock_identity(cm, fi,
                                                  item.context_expr)
                        if lid is not None:
                            acquired = acquired + [lid]
                    out.append((child, list(held)))
                    walk(child, acquired)
                    continue
                out.append((child, list(held)))
                walk(child, held)

        walk(fi.node, [])
        return out

    def _lock_identity(self, cm: ClassModel | None, fi, ctx):
        """Canonical id for a with-ed lock expression, or None."""
        if isinstance(ctx, ast.Attribute) and isinstance(ctx.value,
                                                         ast.Name) \
                and ctx.value.id == "self" and cm is not None \
                and ctx.attr in cm.lock_attrs:
            return cm.lock_id(ctx.attr)
        if isinstance(ctx, ast.Name):
            table = self.module_locks.get(fi.module, {})
            if ctx.id in table:
                return f"{fi.module}.{ctx.id}"
        return None

    # ------------------------------------------------------------------
    def _compute_acquires(self) -> None:
        """Transitive lock acquisitions per function (fixpoint over call
        edges): what does calling this function acquire, directly or
        through its callees?"""
        proj = self.proj
        acq: dict = {}
        for q, fi in proj.functions.items():
            cm = self.class_for(fi)
            s = proj.summaries.get(q)
            direct = {}
            for scope, text, line in (s.acquires_raw if s else ()):
                if scope == "self" and cm is not None \
                        and text in cm.lock_attrs:
                    direct[cm.lock_id(text)] = (
                        _site(fi.path, line), f"`with self.{text}`")
                elif scope == "name":
                    table = self.module_locks.get(fi.module, {})
                    if text in table:
                        direct[f"{fi.module}.{text}"] = (
                            _site(fi.path, line), f"`with {text}`")
            acq[q] = direct
        changed = True
        while changed:
            changed = False
            for q, fi in proj.functions.items():
                mine = acq[q]
                for callee in fi.calls:
                    cq = self._callable_fn(callee)
                    for lid, (site, via) in acq.get(cq, {}).items():
                        if lid not in mine:
                            mine[lid] = (site, f"via `{cq}` ({via})")
                            changed = True
        self.t_acquires = acq

    def _callable_fn(self, qname: str) -> str:
        """Calling a class calls its __init__ (the flight-recorder-dump-
        at-construction errors make this edge matter)."""
        if qname in self.proj.classes:
            ci = self.proj.classes[qname]
            return ci.methods.get("__init__", qname)
        return qname

    def _build_edges(self) -> None:
        """The global lock graph: while A is held, acquiring B (by a
        nested ``with`` or through a resolved call) adds edge A -> B."""
        for q, fi in self.proj.functions.items():
            cm = self.class_for(fi)
            for node, held in self._held_spans(cm, fi):
                if not held:
                    continue
                inner = {}
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lid = self._lock_identity(cm, fi,
                                                  item.context_expr)
                        if lid is not None:
                            inner[lid] = (_site(fi.path, node.lineno),
                                          "nested `with`")
                elif isinstance(node, ast.Call):
                    target = self.proj.call_target(fi.path, node)
                    if target:
                        cq = self._callable_fn(target)
                        inner = {
                            lid: (_site(fi.path, node.lineno),
                                  f"call to `{cq.rsplit('.', 1)[-1]}` "
                                  f"({via})")
                            for lid, (site, via) in
                            self.t_acquires.get(cq, {}).items()}
                if not inner:
                    continue
                for a in held:
                    for b, wit in inner.items():
                        if a != b and (a, b) not in self.edges:
                            self.edges[(a, b)] = wit

    def cycles(self):
        """Minimal lock-order cycles in the global graph: pairs (and
        longer cycles) of edges that can deadlock.  Returns a list of
        [(a, b, site, via), ...] cycles, each reported once."""
        adj: dict = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        out = []
        seen_cycles = set()
        for start in sorted(adj):
            # DFS back to start
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key in seen_cycles:
                            continue
                        seen_cycles.add(key)
                        cyc = []
                        hops = path + [start]
                        for i in range(len(hops) - 1):
                            a, b = hops[i], hops[i + 1]
                            site, via = self.edges[(a, b)]
                            cyc.append((a, b, site, via))
                        out.append(cyc)
                    elif nxt not in path and len(path) < 6:
                        stack.append((nxt, path + [nxt]))
        return out


def get_model(project) -> Model:
    """The per-project model, built once and cached on the Project."""
    model = getattr(project, "_concurrency_model", None)
    if model is None:
        model = Model(project)
        project._concurrency_model = model
    return model


# ---------------------------------------------------------------------------
# shared access-classification helpers (SLU108 and SLU110 both need
# "which self attributes does this method read/write")
# ---------------------------------------------------------------------------

def attr_accesses(fi):
    """[(attr, is_write, node)] for every ``self.X`` touch lexically in
    `fi`'s body (nested defs excluded — they carry their own Summary and
    thread context).  Writes: plain/aug assignment, subscript stores,
    and calls of known container mutators (``self.q.append(...)``)."""
    out = []
    stack = list(ast.iter_child_nodes(fi.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            out.append((node.attr,
                        isinstance(node.ctx, (ast.Store, ast.Del)), node))
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Store) and \
                isinstance(node.value, ast.Attribute) and \
                isinstance(node.value.value, ast.Name) and \
                node.value.value.id == "self":
            out.append((node.value.attr, True, node))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATOR_METHODS and \
                isinstance(node.func.value, ast.Attribute) and \
                isinstance(node.func.value.value, ast.Name) and \
                node.func.value.value.id == "self":
            out.append((node.func.value.attr, True, node))
        stack.extend(ast.iter_child_nodes(node))
    return out


def attr_reads_transitive(model: Model, cm: ClassModel, entry: str) -> set:
    """Attributes READ by `entry` and its transitive same-class callees
    (the dependency set of a thread target, for SLU110's started-before-
    assigned check)."""
    proj = model.proj
    seen, reads = set(), set()
    work = [entry]
    prefix = cm.qname + "."
    while work:
        q = work.pop()
        if q in seen or not q.startswith(prefix):
            continue
        seen.add(q)
        fi = proj.functions.get(q)
        if fi is None:
            continue
        for attr, is_write, _ in attr_accesses(fi):
            if not is_write:
                reads.add(attr)
        work.extend(fi.calls)
        work.extend(fi.children.values())
    return reads
