"""SLU101 — collective-consistency (interprocedural).

Every rank attached to a TreeComm domain must execute the same collective
sequence (treecomm.py's contract; the reference's per-supernode Bc/Rd
trees are likewise matched, TreeBcast_slu.hpp).  The deadly shapes:

* a collective call INSIDE a branch (or loop) whose condition depends on
  the caller's rank / grid coordinates — only some ranks reach it;
* a collective call AFTER a rank-conditioned early exit (`return` /
  `raise` / `break` / `continue` under a rank test, or an `assert` whose
  predicate involves the rank) earlier in the same function — some ranks
  left before reaching it;
* a collective call inside an `except` handler — exceptions raise on a
  strict subset of ranks by construction (the project-blessed pattern is
  pgssvx.bcast_result, which ships the exception THROUGH a collective
  every rank reaches).

A lexical scan sees only a call spelled `*.bcast_any(...)` inside the
branch.  The interprocedural tier closes the two indirection gaps
MUST-style dynamic tools showed matter in practice:

* *transitive* collectives — a call to any function that REACHES a
  collective through the call graph (`_ship(tc, x)` wrapping the
  `bcast_any`) is treated exactly like the collective itself, with the
  finding naming both the wrapper and the witness site it reaches;
* *dataflow rank predicates* — a branch condition is rank-dependent not
  only when it lexically names a rank, but when it uses a local the
  forward pass proved rank-tainted (`r = tc.rank; if r == 0:`) or calls
  a function whose returns are rank-derived (`if is_root(tc):`).

The scan remains per function; nested `def`s start a fresh context
(their bodies run at call time, not at definition time).

Port of the JAX package's ``analysis/rules_collective.py``.  The
collective surface (dataflow.COLLECTIVE_METHODS) holds TreeComm's and
the mesh tier's ProcessGrid collectives (``all_gather``, ``bcast_row``,
``all_reduce_row``, ``exchange``, ``gather_rows``, ``all_reduce_sum``,
``allreduce_sum_any``): a grid collective under ``if grid.rank == 0:``
strands the other ranks in torch.distributed exactly as a tree one does.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Rule
from superlu_dist_tpu_torch.analysis.dataflow import COLLECTIVE_METHODS, FnFlow

_RANK_ATTRS = frozenset({"rank", "iam", "myrow", "mycol"})
_RANK_NAMES = frozenset({"rank", "iam", "myrank", "my_rank"})


def _is_rank_expr_lexical(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _RANK_ATTRS:
            return True
        if isinstance(sub, ast.Name) and sub.id in _RANK_NAMES:
            return True
    return False


def _has_early_exit(stmts) -> bool:
    for st in stmts:
        for sub in ast.walk(st):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                continue
            if isinstance(sub, (ast.Return, ast.Raise, ast.Break,
                                ast.Continue)):
                return True
    return False


class _FunctionScan:
    """One function body, scanned statement-by-statement in order."""

    def __init__(self, rule, path, findings, project=None, flow=None):
        self.rule = rule
        self.path = path
        self.findings = findings
        self.project = project
        self.flow = flow               # FnFlow of THIS function body
        self.diverged_at = None        # line of the earliest rank-dep. exit

    def _sub_scan(self, fn_node):
        flow = None
        if self.project is not None:
            flow = FnFlow(fn_node.body, self.path,
                          lambda c: self.project.call_target(self.path, c),
                          self.project.summaries).run()
        return _FunctionScan(self.rule, self.path, self.findings,
                             self.project, flow)

    def _is_rank_expr(self, node: ast.AST) -> bool:
        if _is_rank_expr_lexical(node):
            return True
        if self.flow is not None and self.flow.rank_tainted(node):
            return True
        return False

    def flag(self, call, why, indirect=None):
        if indirect is not None:
            via, (owner, witness) = indirect
            why = (f"call to `{via}` reaches collective `{witness}` "
                   f"(via `{owner}`); {why}")
        self.findings.append(self.rule.finding(self.path, call, why))

    def scan(self, stmts, in_rank_branch=False, in_except=False):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._sub_scan(st).scan(st.body)
                continue
            if isinstance(st, ast.ClassDef):
                self.scan(st.body, in_rank_branch, in_except)
                continue

            rank_cond = isinstance(st, (ast.If, ast.While)) \
                and self._is_rank_expr(st.test)

            # flag the collectives this statement directly owns (for
            # compound statements that is the header expression, which
            # every rank still evaluates — so rank_cond alone does not
            # flag it; only an ENCLOSING rank branch does)
            for call, indirect in self.direct_collectives(st):
                if in_except:
                    self.flag(call,
                              "collective inside an `except` handler — "
                              "the exception raised on a subset of ranks, "
                              "so the others never reach this call",
                              indirect)
                elif in_rank_branch:
                    self.flag(call,
                              "collective under rank-dependent control "
                              "flow — only some ranks reach it", indirect)
                elif self.diverged_at is not None:
                    self.flag(call,
                              "collective after a rank-dependent early "
                              f"exit (line {self.diverged_at}) — ranks "
                              "that exited never reach this call", indirect)

            # recurse into compound statements with updated context
            if isinstance(st, (ast.If, ast.While)):
                branch = in_rank_branch or rank_cond
                self.scan(st.body, branch, in_except)
                self.scan(st.orelse, branch, in_except)
                if rank_cond and not in_rank_branch \
                        and self.diverged_at is None \
                        and (_has_early_exit(st.body)
                             or _has_early_exit(st.orelse)):
                    self.diverged_at = st.lineno
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self.scan(st.body, in_rank_branch, in_except)
                self.scan(st.orelse, in_rank_branch, in_except)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                self.scan(st.body, in_rank_branch, in_except)
            elif isinstance(st, ast.Try):
                self.scan(st.body, in_rank_branch, in_except)
                for h in st.handlers:
                    self.scan(h.body, in_rank_branch, True)
                self.scan(st.orelse, in_rank_branch, in_except)
                self.scan(st.finalbody, in_rank_branch, in_except)
            elif isinstance(st, ast.Assert) and self._is_rank_expr(st.test) \
                    and not in_rank_branch and self.diverged_at is None:
                # an assert on a rank-dependent predicate is a
                # conditional raise on a subset of ranks
                self.diverged_at = st.lineno

    def _classify(self, call: ast.Call):
        """(call, indirect-info) when `call` is collective-bearing:
        directly (attribute named like a collective) or transitively
        (resolved callee whose summary reaches a collective)."""
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in COLLECTIVE_METHODS:
            return call, None
        if self.project is not None:
            target = self.project.call_target(self.path, call)
            s = self.project.summaries.get(target) if target else None
            if s is not None and s.reaches_collective is not None:
                via = target.rsplit(".", 2)
                return call, (".".join(via[-2:]), s.reaches_collective)
        return None

    def _collective_calls(self, node: ast.AST):
        """Collective-bearing Call nodes lexically inside `node`,
        excluding nested function/class bodies (those execute in their
        own context)."""
        stack = [node]
        while stack:
            cur = stack.pop()
            for child in ast.iter_child_nodes(cur):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    hit = self._classify(child)
                    if hit is not None:
                        yield hit
                stack.append(child)

    def direct_collectives(self, st):
        """Collectives in `st`'s own expressions — for compound
        statements, only the header (test/iter/items), since the body is
        scanned recursively with its own context."""
        if isinstance(st, (ast.If, ast.While)):
            roots = [st.test]
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            roots = [st.iter]
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            roots = [i.context_expr for i in st.items]
        elif isinstance(st, ast.Try):
            roots = []
        else:
            roots = [st]
        out = []
        for r in roots:
            if isinstance(r, ast.Call):
                hit = self._classify(r)
                if hit is not None:
                    out.append(hit)
            out.extend(self._collective_calls(r))
        return out


class CollectiveRule(Rule):
    rule_id = "SLU101"
    title = "collective-consistency"
    hint = ("make every rank reach the collective: hoist it out of the "
            "rank branch, allreduce the predicate first, or ship the "
            "root-side work through pgssvx.bcast_result (which carries "
            "exceptions to every rank)")

    def __init__(self, interprocedural: bool = True):
        # interprocedural=False restores the lexical behavior (used by
        # the tests proving the dataflow tier catches what it misses)
        self.interprocedural = interprocedural

    def check(self, tree, source, path, project=None):
        findings = []
        proj = project if self.interprocedural else None
        flow = None
        if proj is not None:
            flow = FnFlow.for_module(proj, path, tree).run()
        # module level counts as one function body (scripts run it)
        _FunctionScan(self, path, findings, proj, flow).scan(tree.body)
        # findings inside compound headers can be discovered twice (once
        # as the header root, once in the generic walk) — dedupe by site
        seen, out = set(), []
        for f in findings:
            key = (f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                out.append(f)
        return out
