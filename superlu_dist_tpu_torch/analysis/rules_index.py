"""SLU103 — index-width discipline (flow-based).

The GESP analog of the reference's ``int_t`` audit (superlu_defs.h:80-93
/ XSDK_INDEX_SIZE): pattern indices may be 32-bit (``sparse.formats.INT``
— bounded by n), but anything that ACCUMULATES — indptr/offset cumsums,
nnz totals, dimension products — overflows int32 exactly in the n≈10^6
regime the config4 targets run at (nnz(L) > 2^31 long before n does).

Flagged, in symbolic/ sparse/ numeric/ inside the project tree (and
everywhere outside it, e.g. test fixtures):

* ``np.cumsum(..., dtype=D)`` with a possibly-32-bit D (``np.int32``,
  ``"int32"``, ``np.intc``, or the env-selected ``INT`` alias) — a
  running prefix sum is the canonical nnz accumulator;
* arithmetic (`*`, `+`) where an operand is an EXPLICIT int32 cast
  (``np.int32(x)``, ``x.astype(np.int32)``) — products of dimension-like
  quantities must be promoted before they multiply, not after;
* any assignment to an accumulator-named target (indptr / *off* / *ptr*
  / nnz* / *cnt* / count / total) whose value the forward dataflow pass
  (analysis/dataflow.py) proves int32-typed.  The lexical tier only matches a
  32-bit constructor written *directly* on the assignment; the flow tier
  follows the taint
  through temporaries (``tmp = np.zeros(n, np.int32); indptr = tmp``)
  and through function returns (``indptr = _alloc(n)`` where ``_alloc``
  returns an int32 array — resolved through the package call graph).
  ``.astype(np.int64)`` clears the taint: promotion is the fix.

Port of the JAX package's ``analysis/rules_index.py``; torch's spellings
count too: ``torch.int32``, ``x.int()`` and ``x.to(torch.int32)`` are
32-bit, ``x.long()`` / ``x.to(torch.int64)`` promote.
"""

from __future__ import annotations

import ast
import re

from superlu_dist_tpu_torch.analysis.core import Rule, dotted_name
from superlu_dist_tpu_torch.analysis.dataflow import (FnFlow, TAINT_I32,
                                                      dtype_kw,
                                                      is_explicit_i32_expr,
                                                      is_i32_dtype,
                                                      to_dtype_arg)

_ACCUM_TARGET = re.compile(
    r"(^|_)(indptr|offs?|offsets?|ptr|rows_ptr|nnz\w*|cnt|counts?|total)"
    r"(_|$)|(_ptr|_offs?|_cnt)$")

_ARRAY_CTORS = frozenset({"zeros", "empty", "full", "arange", "array",
                          "asarray", "ones", "tensor", "as_tensor"})


class IndexWidthRule(Rule):
    rule_id = "SLU103"
    title = "index-width"
    hint = ("accumulators must be int64 regardless of the pattern-index "
            "width: use formats.counts_to_indptr / symbfact.supernode_nnz "
            "or an explicit dtype=np.int64, and promote operands BEFORE "
            "products (.astype(np.int64) * ...)")
    package_dirs = ("symbolic", "sparse", "numeric")

    def __init__(self, interprocedural: bool = True):
        self.interprocedural = interprocedural

    def check(self, tree, source, path, project=None):
        findings = []
        flagged = set()       # (line, col) dedup across lexical + flow

        def add(node, message):
            key = (getattr(node, "lineno", 0), getattr(node, "col_offset",
                                                       0))
            if key in flagged:
                return
            flagged.add(key)
            findings.append(self.finding(path, node, message))

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._check_call(node, add)
            elif isinstance(node, ast.Assign) \
                    and not (self.interprocedural and project is not None):
                self._check_assign(node, add)
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Mult, ast.Add)):
                for side in (node.left, node.right):
                    if is_explicit_i32_expr(side):
                        add(node,
                            "int32-cast operand in arithmetic — the "
                            "product/sum wraps at 2^31 before any later "
                            "promotion can save it")
                        break

        if self.interprocedural and project is not None:
            self._check_flow(tree, path, project, add)
        return findings

    # ---- the dataflow pass ---------------------------------------------
    def _check_flow(self, tree, path, project, add):
        """Run the forward pass over the module body and every function
        body; flag accumulator-named targets receiving i32-tainted
        values (direct ctors, temporaries, and resolved returns)."""
        scopes = [FnFlow.for_module(project, path, tree)]
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(FnFlow(
                    node.body, path,
                    lambda c: project.call_target(path, c),
                    project.summaries))
        for flow in scopes:
            flow.run()
            for names, value_node, taints in flow.assigns.values():
                accum = [n for n in names if _ACCUM_TARGET.search(n)]
                if not accum or TAINT_I32 not in taints:
                    continue
                add(value_node,
                    f"accumulator `{', '.join(accum)}` receives an "
                    f"int32-typed value ({taints[TAINT_I32]}) — "
                    "offset/nnz accumulators must be int64")

    # ---- lexical checks (still the base tier) ---------------------------
    def _check_call(self, node, add):
        name = dotted_name(node.func)
        if name.endswith("cumsum"):
            dt = dtype_kw(node)
            if dt is not None and is_i32_dtype(dt):
                add(node,
                    f"cumsum with 32-bit dtype `{dotted_name(dt) or 'int32'}`"
                    " — a prefix-sum accumulator overflows at nnz > 2^31")

    def _check_assign(self, node, add):
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any(_ACCUM_TARGET.search(t) for t in targets):
            return
        val = node.value
        if not isinstance(val, ast.Call):
            return
        dt = None
        fn = val.func
        if isinstance(fn, ast.Attribute) and fn.attr in _ARRAY_CTORS:
            dt = dtype_kw(val)
            if dt is None and len(val.args) >= 2 \
                    and fn.attr in _ARRAY_CTORS:
                dt = val.args[-1] if is_i32_dtype(val.args[-1]) else None
        elif isinstance(fn, ast.Attribute) and fn.attr in ("astype", "to") \
                and (val.args or val.keywords):
            dt = to_dtype_arg(val)
        elif isinstance(fn, ast.Attribute) and fn.attr == "int" \
                and not val.args:
            add(node.value,
                f"accumulator `{', '.join(targets)}` constructed with a "
                "32-bit dtype — offset/nnz accumulators must be int64")
            return
        if dt is not None and is_i32_dtype(dt):
            add(node.value,
                f"accumulator `{', '.join(targets)}` constructed with a "
                "32-bit dtype — offset/nnz accumulators must be int64")
