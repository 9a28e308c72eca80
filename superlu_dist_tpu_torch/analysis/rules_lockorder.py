"""SLU109 — lock-order and hold-discipline.

Two families of finding over the package-wide lock-acquisition graph
(analysis/concurrency.py — nodes are class-qualified lock identities,
edges ``A -> B`` mean "B acquired while holding A", directly or through
a resolved call chain):

* **ordering** — a cycle in the graph is a potential deadlock: two
  threads entering the cycle from different ends block forever.  Each
  edge of the cycle is reported at its acquisition site, naming the
  witness for the inverse order.  Lexical re-acquisition of the SAME
  (non-reentrant) lock inside its own ``with`` is the degenerate cycle
  and flagged too.
* **blocking-while-holding** — operations with unbounded or external
  latency inside a held lock stall every contending thread and, when
  the blocked-on party needs the same lock, deadlock outright.  Flagged
  inside a ``with <lock>:`` body: TreeComm / ProcessGrid collectives (direct or
  call-graph-reachable — the other ranks may be blocked on THIS rank's
  lock holder), a wait for the card (``torch.cuda.synchronize()``,
  ``<event or stream>.synchronize()``), no-timeout
  ``Condition``/``Event`` ``.wait()``, no-timeout ``Thread.join()``,
  ``time.sleep``, and file I/O (a direct ``open`` or a call whose
  callee chain reaches one — the shape of a close storm that stalls
  every caller).

The runtime twin is ``utils/lockwatch.py`` (``SLU_TPU_VERIFY_LOCKS=1``):
the same order graph maintained on live acquisitions, raising
``LockOrderError`` at the first cycle — SLU106's mold, for locks.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.concurrency import get_model
from superlu_dist_tpu_torch.analysis.core import Finding, Rule
from superlu_dist_tpu_torch.analysis.dataflow import (COLLECTIVE_METHODS,
                                                      _blocking_candidate)

#: blocking kinds that propagate through the call graph (file I/O hides
#: behind helpers routinely; the interactive kinds are flagged only
#:  where they are spelled — false-negative-leaning)
_TRANSITIVE_KINDS = ("open",)


def _reaches_blocking(model):
    """qname -> (kind, witness-site, owner) fixpoint for the transitive
    blocking kinds, cached on the model."""
    cached = getattr(model, "_reaches_blocking", None)
    if cached is not None:
        return cached
    proj = model.proj
    out = {}
    for q, s in proj.summaries.items():
        for kind, recv, line in s.blocking_raw:
            if kind in _TRANSITIVE_KINDS:
                fi = proj.functions[q]
                out[q] = (kind, f"{fi.path}:{line}", q)
                break
    changed = True
    while changed:
        changed = False
        for q, fi in proj.functions.items():
            if q in out:
                continue
            for callee in fi.calls:
                hit = out.get(model._callable_fn(callee))
                if hit is not None:
                    out[q] = hit
                    changed = True
                    break
    model._reaches_blocking = out
    return out


class LockOrderRule(Rule):
    rule_id = "SLU109"
    title = "lock-order + hold-discipline"
    hint = ("acquire locks in one global order (document it where the "
            "locks are created), and move blocking work — collectives, "
            "waits for the card, unbounded waits, file I/O — outside the "
            "`with` block: snapshot state under the lock, block outside")

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        model = get_model(project)
        out = []
        out.extend(self._cycle_findings(model, path))
        out.extend(self._hold_findings(model, path))
        return out

    # ---- ordering ------------------------------------------------------
    def _cycle_findings(self, model, path):
        out = []
        for cyc in model.cycles():
            for i, (a, b, site, via) in enumerate(cyc):
                fpath, _, line = site.rpartition(":")
                if fpath != path:
                    continue
                others = "; ".join(
                    f"`{b2}` -> `{a2}` at {s2}" for j, (b2, a2, s2, _)
                    in enumerate(cyc) if j != i) or "inverse order"
                out.append(Finding(
                    self.rule_id, path, int(line), 1,
                    f"lock-order inversion: `{b}` acquired while "
                    f"holding `{a}` ({via}), but the inverse order "
                    f"exists — {others} — two threads entering from "
                    "different ends deadlock",
                    self.hint))
        return out

    # ---- hold discipline -----------------------------------------------
    def _hold_findings(self, model, path):
        proj = model.proj
        reaches = _reaches_blocking(model)
        out = []
        for q, fi in proj.functions.items():
            if fi.path != path:
                continue
            cm = model.class_for(fi)
            for node, held in model._held_spans(cm, fi):
                if isinstance(node, (ast.With, ast.AsyncWith)) and held:
                    for item in node.items:
                        lid = model._lock_identity(cm, fi,
                                                   item.context_expr)
                        if lid is not None and lid in held:
                            out.append(Finding(
                                self.rule_id, path, node.lineno,
                                node.col_offset + 1,
                                f"re-acquisition of non-reentrant lock "
                                f"`{lid}` inside its own `with` — "
                                "guaranteed self-deadlock",
                                self.hint))
                if not held or not isinstance(node, ast.Call):
                    continue
                desc = self._blocking_desc(model, cm, fi, node, reaches)
                if desc is None:
                    continue
                out.append(Finding(
                    self.rule_id, path, node.lineno,
                    node.col_offset + 1,
                    f"{desc} while holding `{held[-1]}` — blocks every "
                    "thread contending for the lock (deadlock when the "
                    "blocked-on party needs it)",
                    self.hint))
        return out

    def _blocking_desc(self, model, cm, fi, node, reaches):
        fn = node.func
        # collectives: direct or call-graph-reachable
        if isinstance(fn, ast.Attribute) and fn.attr in COLLECTIVE_METHODS:
            return f"collective `{fn.attr}`"
        target = model.proj.call_target(fi.path, node)
        if target:
            tq = model._callable_fn(target)
            s = model.proj.summaries.get(tq)
            if s is not None and s.reaches_collective is not None:
                owner, witness = s.reaches_collective
                return (f"call to `{tq.rsplit('.', 1)[-1]}` reaching "
                        f"collective `{witness}`")
            hit = reaches.get(tq)
            if hit is not None:
                kind, site, owner = hit
                return (f"call to `{tq.rsplit('.', 1)[-1]}` reaching "
                        f"file I/O (`{kind}` at {site})")
        cand = _blocking_candidate(node)
        if cand is None:
            return None
        kind, recv, _ = cand
        if kind == "open":
            return "file I/O (`open`)"
        if kind == "synchronize":
            return f"wait for the card (`{recv}.synchronize()`)"
        if kind == "sleep":
            return "`time.sleep`"
        # wait/join: only when the receiver is a known sync/thread attr
        # of this class (arbitrary .wait()/.join() receivers are opaque)
        if cm is not None and isinstance(fn.value, ast.Attribute) \
                and isinstance(fn.value.value, ast.Name) \
                and fn.value.value.id == "self":
            attr = fn.value.attr
            if kind == "wait" and (attr in cm.event_attrs
                                   or cm.lock_attrs.get(attr) == "cond"):
                return f"unbounded `self.{attr}.wait()` (no timeout)"
            if kind == "join" and attr in cm.thread_attrs:
                return f"unbounded `self.{attr}.join()` (no timeout)"
        return None
