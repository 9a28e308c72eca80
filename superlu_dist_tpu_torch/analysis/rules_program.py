"""SLU113 — host round trip in a per-group dispatch loop.

``float()`` / ``int()`` / ``bool()`` / ``.item()`` / ``.tolist()`` /
``.numpy()`` / ``np.asarray(t)`` on a DEVICE value — or an ``if`` /
``while`` test on one — inside a per-group dispatch loop makes the host
wait for the card once per group: the silent serializer of the streamed
executors, whose FACT is paced by the host issuing launches.  Found via
the dataflow lattice's ``device`` taint (analysis/dataflow.py: torch
factories given a device, ``.to(dev)`` / ``.cuda()``, torch ops on device
values, the kernel entry points, CUDA-graph replays).  The explicit
syncs — ``.cpu()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
``<event or stream>.synchronize()`` — clear the taint: a wait spelled
where it happens is exactly the fix.

Port of the SLU113 half of the JAX package's
``analysis/rules_program.py``.  Its jaxpr rules (SLU111 donation,
SLU112 baked constants, SLU114 SPMD collective lockstep) audit traced
XLA programs, which the port does not build.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Rule, dotted_name
from superlu_dist_tpu_torch.analysis.dataflow import TAINT_DEVICE, FnFlow

RULE_HOST_ROUNDTRIP = "SLU113"

_COERCIONS = frozenset({"float", "int", "bool"})
_COERCION_METHODS = frozenset({"item", "tolist", "numpy"})
_NP_MATERIALIZERS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array"})


class _DispatchFlow(FnFlow):
    """FnFlow with the SLU113 in-loop coercion scan attached."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.hits: dict = {}     # (line, col) -> (anchor node, message)

    def _device(self, expr) -> str | None:
        t = self.taint(expr)
        return t.get(TAINT_DEVICE)

    def _scan_expr(self, expr) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            prov = None
            what = None
            if name in _COERCIONS and node.args:
                prov = self._device(node.args[0])
                what = f"`{name}()`"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _COERCION_METHODS:
                prov = self._device(node.func.value)
                what = f"`.{node.func.attr}()`"
            elif name in _NP_MATERIALIZERS and node.args:
                prov = self._device(node.args[0])
                what = f"`{name}`"
            if prov is not None:
                self._hit(node, what, prov)

    def _hit(self, node, what, prov) -> None:
        key = (node.lineno, node.col_offset)
        if key not in self.hits:
            self.hits[key] = (node, f"{what} on a device value ({prov}) "
                              "inside the dispatch loop — a blocking "
                              "host round-trip once per group, "
                              "serializing the async dispatch stream")

    def visit_stmt(self, st) -> None:
        if self.loop_depth == 0:
            return
        if isinstance(st, (ast.If, ast.While)):
            prov = self._device(st.test)
            if prov is not None:
                self._hit(st.test, "bool-coercion of the branch test",
                          prov)
            self._scan_expr(st.test)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._scan_expr(st.iter)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._scan_expr(item.context_expr)
            return
        if isinstance(st, ast.Try):
            return
        self._scan_expr(st)


class HostRoundTripRule(Rule):
    rule_id = RULE_HOST_ROUNDTRIP
    title = "host-round-trip-in-dispatch-loop"
    hint = ("keep the dispatch loop async: keep the value on the card and "
            "read it AFTER the loop, or make the wait explicit with "
            ".cpu() / torch.cuda.synchronize() / <event>.synchronize() "
            "(explicit syncs are exempt — visibility is the point)")
    package_dirs = ("numeric", "solve")

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        out = []
        for qname, fi in project.functions.items():
            if fi.path != path:
                continue
            flow = _DispatchFlow.for_function(project, fi)
            flow.run()
            for key in sorted(flow.hits):
                node, msg = flow.hits[key]
                out.append(self.finding(path, node, msg))
        return out
