"""SLU110 — thread lifecycle discipline.

Three shapes around the *edges* of a background thread's life — exactly
where the daemons (heartbeat, dispatcher, scrubber) can race
construction and interpreter teardown:

* **started-before-dependencies** — a thread started in ``__init__``
  whose target (or a transitive same-class callee, via the call graph)
  reads an attribute first assigned LATER in ``__init__``: the thread
  can observe a half-constructed object (``AttributeError`` at best, a
  stale-state decision at worst);
* **daemon-without-join** — a ``daemon=True`` thread stored on ``self``
  that no method ever ``join()``s: interpreter shutdown races the live
  daemon against module teardown (the canonical fix: a bounded-timeout
  join in ``close()``, after setting the stop event);
* **set-never-waited events** — a ``threading.Event`` that is ``set()``
  but never ``wait()``ed or ``is_set()``-polled in the class: dead
  signaling — a stop flag no one checks is a thread no one stops.

Class-scoped and false-negative-leaning: anonymous fire-and-forget
threads (``threading.Thread(target=..., daemon=True).start()`` without a
``self`` binding — the bench watchdog idiom) are intentionally out of
scope; a thread a class OWNS must have an owned lifecycle.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.concurrency import (attr_reads_transitive,
                                                         get_model)
from superlu_dist_tpu_torch.analysis.core import Finding, Rule


class ThreadLifecycleRule(Rule):
    rule_id = "SLU110"
    title = "thread lifecycle discipline"
    hint = ("assign every attribute the target reads before start(); "
            "pair each daemon with a stop event + bounded-timeout join "
            "in close(); delete events nothing waits on")

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        model = get_model(project)
        out = []
        for cq, cm in model.classes.items():
            fns = model.class_functions(cq)
            if not any(fi.path == path for fi in fns):
                continue
            out.extend(self._daemon_joins(cm, path))
            out.extend(self._init_ordering(model, cm, fns, path))
            out.extend(self._dead_events(cm, fns, path))
        return out

    # ------------------------------------------------------------------
    def _daemon_joins(self, cm, path):
        out = []
        for attr, (tq, daemon, apath, line) in sorted(
                cm.thread_attrs.items()):
            if not daemon or apath != path:
                continue
            if attr in cm.joined_attrs:
                continue
            out.append(Finding(
                self.rule_id, path, line, 1,
                f"daemon thread `self.{attr}` of `{cm.qname}` is never "
                "join()ed — interpreter shutdown races the live daemon "
                "against module teardown",
                "signal the stop event, then `self."
                f"{attr}.join(timeout)` (bounded) in close()"))
        return out

    # ------------------------------------------------------------------
    def _init_ordering(self, model, cm, fns, path):
        init = next((fi for fi in fns if fi.name == "__init__"
                     and fi.cls == cm.qname), None)
        if init is None or init.path != path:
            return []
        # source-ordered attribute assignments and thread starts
        assign_line: dict = {}
        starts = []          # (line, thread attr or None, target qname)
        for node in ast.walk(init.node):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        assign_line.setdefault(tgt.attr, node.lineno)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "start":
                recv = node.func.value
                if isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self" \
                        and recv.attr in cm.thread_attrs:
                    starts.append((node.lineno, recv.attr,
                                   cm.thread_attrs[recv.attr][0], node))
        out = []
        for line, attr, tq, node in starts:
            if not tq:
                continue
            reads = attr_reads_transitive(model, cm, tq)
            late = sorted(a for a in reads
                          if assign_line.get(a, 0) > line)
            if late:
                out.append(Finding(
                    self.rule_id, path, line, node.col_offset + 1,
                    f"thread `self.{attr}` started in __init__ before "
                    "dependent attribute(s) "
                    f"{', '.join('`self.%s`' % a for a in late)} "
                    f"are assigned — the target "
                    f"(`{tq.rsplit('.', 1)[-1]}`) can observe a "
                    "half-constructed object",
                    "assign everything the target reads before "
                    "start(), or start from a separate start() method"))
        return out

    # ------------------------------------------------------------------
    def _dead_events(self, cm, fns, path):
        if not cm.event_attrs:
            return []
        sets: dict = {}
        used: set = set()
        for fi in fns:
            for node in ast.walk(fi.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Attribute)
                        and isinstance(node.func.value.value, ast.Name)
                        and node.func.value.value.id == "self"):
                    continue
                attr = node.func.value.attr
                if attr not in cm.event_attrs:
                    continue
                if node.func.attr == "set":
                    sets.setdefault(attr, (fi.path, node.lineno))
                elif node.func.attr in ("wait", "is_set", "clear"):
                    used.add(attr)
        out = []
        for attr, (apath, line) in sorted(sets.items()):
            if attr in used or apath != path:
                continue
            out.append(Finding(
                self.rule_id, path, line, 1,
                f"event `self.{attr}` of `{cm.qname}` is set() but "
                "never wait()ed or is_set()-polled — dead signaling "
                "(a stop flag no thread checks stops nothing)",
                "make the thread loop poll/wait the event, or delete "
                "it"))
        return out
