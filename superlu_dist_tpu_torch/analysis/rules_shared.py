"""SLU108 — unguarded shared-mutable access.

The serving tier's correctness rests on every cross-thread touch of a
``SolveServer``/detector attribute happening under the owning lock (a
submit/close race is exactly one missed case).  The rule encodes
that contract: for every class that spawns a ``threading.Thread``, an
attribute *written on the thread side* (the target method or any of its
transitive same-class callees, resolved through the call graph) must
only be touched on the public-API side under the class's lock.

What counts as guarded (analysis/concurrency.py):

* lexically inside ``with self._lock:`` / ``with self._cond:`` (a
  ``Condition(self._lock)`` aliases onto the lock it wraps — one mutex);
* inside a method whose every in-class call site is under the guard
  (the ``*_locked`` caller-holds-the-lock idiom, verified — the naming
  convention alone is also honored as an explicit assertion).

Exempt: lock/condition/event/thread attributes themselves (events are
their own synchronization), methods, and attributes never written
outside ``__init__`` (immutable-after-construction state needs no
lock).  False-negative-leaning: an unresolvable thread target drops the
class from the scan entirely.
"""

from __future__ import annotations

from superlu_dist_tpu_torch.analysis.concurrency import (attr_accesses,
                                                         get_model)
from superlu_dist_tpu_torch.analysis.core import Finding, Rule


class SharedMutableRule(Rule):
    rule_id = "SLU108"
    title = "unguarded shared-mutable access"
    hint = ("guard every cross-thread access with the owning lock "
            "(`with self._lock:`), move it into a *_locked helper called "
            "under the lock, or make the attribute immutable before the "
            "thread starts")

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        model = get_model(project)
        out = []
        for cq, cm in model.classes.items():
            if not cm.thread_side:
                continue
            fns = model.class_functions(cq)
            if not any(fi.path == path for fi in fns):
                continue
            out.extend(self._check_class(model, cm, fns, path))
        return out

    # ------------------------------------------------------------------
    def _check_class(self, model, cm, fns, path):
        exempt = (cm.guard_attrs() | cm.event_attrs
                  | set(cm.thread_attrs) | set(cm.methods))
        # (attr -> [(fi, node, guarded, is_write)]) split by side
        thread_acc: dict = {}
        public_acc: dict = {}
        for fi in fns:
            if fi.name == "__init__":
                continue
            held_at = {id(n): locks
                       for n, locks in model._held_spans(cm, fi)}
            base = fi.qname in model.lock_context
            side = thread_acc if fi.qname in cm.thread_side \
                else public_acc
            for attr, is_write, node in attr_accesses(fi):
                if attr in exempt:
                    continue
                guarded = base or bool(held_at.get(id(node)))
                side.setdefault(attr, []).append(
                    (fi, node, guarded, is_write))
        out = []
        for attr, taccs in sorted(thread_acc.items()):
            twrites = [a for a in taccs if a[3]]
            if not twrites:
                continue
            pubs = public_acc.get(attr, ())
            if not pubs:
                continue
            wfi, wnode, _, _ = twrites[0]
            witness = (f"`{wfi.qname.rsplit('.', 1)[-1]}` at "
                       f"{wfi.path}:{wnode.lineno}")
            for fi, node, guarded, is_write in pubs:
                if guarded:
                    continue
                verb = "written" if is_write else "read"
                out.append(Finding(
                    self.rule_id, path, node.lineno,
                    node.col_offset + 1,
                    f"`self.{attr}` is {verb} here without the owning "
                    f"lock, but a background thread of `{cm.qname}` "
                    f"writes it ({witness}) — cross-thread data race",
                    self.hint))
            if not all(g for _, _, g, _ in twrites):
                fi, node, _, _ = next(a for a in twrites if not a[2])
                if fi.path == path:
                    out.append(Finding(
                        self.rule_id, path, node.lineno,
                        node.col_offset + 1,
                        f"thread-side write of `self.{attr}` (thread "
                        f"target side of `{cm.qname}`) without the "
                        "owning lock, while the public API also touches "
                        "it — cross-thread data race",
                        self.hint))
        return out
