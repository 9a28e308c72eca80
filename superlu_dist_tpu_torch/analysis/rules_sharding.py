"""SLU122 — cross-device copy in a per-group dispatch loop.

Extends SLU113's device taint: ``.to(<device>)`` or ``.cuda()`` of a
DEVICE value, or a ``dst.copy_(src)`` of a device value into a HOST
tensor (the lattice's host taint: ``.cpu()``, ``.pin_memory()``, a
factory given the host), inside a per-group For/While dispatch loop in
numeric/ or solve/ is a whole-buffer copy once per group — the transfer
analog of SLU113's host round trip.  Host-side uploads (a host tensor
``.to(dev)``, a device tensor ``.copy_`` from the host) are exempt: the
taint gate only fires when the value already lives on a device.

Port of the SLU122 half of the JAX package's
``analysis/rules_sharding.py`` (there: ``jax.device_put`` /
``.reshard`` of a device value).  Its jaxpr rules (SLU119 implicit
replication, SLU121 peak memory) audit traced XLA programs, and SLU120
checks mesh-axis names against the JAX package's axis registry; the port
has neither.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Rule
from superlu_dist_tpu_torch.analysis.dataflow import (TAINT_DEVICE, TAINT_HOST,
                                                      FnFlow, is_host_device,
                                                      to_device_arg)

RULE_LOOP_TRANSFER = "SLU122"


class _TransferFlow(FnFlow):
    """FnFlow with the SLU122 in-loop transfer scan attached (the
    device-taint machinery of SLU113's _DispatchFlow, hunting copies
    instead of host coercions)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.hits: dict = {}     # (line, col) -> (anchor node, message)

    def _device(self, expr) -> str | None:
        t = self.taint(expr)
        return t.get(TAINT_DEVICE)

    def _scan_expr(self, expr) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            prov = None
            what = None
            if attr == "to":
                dev = to_device_arg(node)
                if dev is not None and not is_host_device(dev):
                    prov = self._device(node.func.value)
                    what = "`.to(<device>)`"
            elif attr == "cuda":
                prov = self._device(node.func.value)
                what = "`.cuda()`"
            elif attr == "copy_" and node.args \
                    and TAINT_HOST in self.taint(node.func.value):
                prov = self._device(node.args[0])
                what = "`.copy_()` into a host tensor"
            if prov is not None:
                self._hit(node, what, prov)

    def _hit(self, node, what, prov) -> None:
        key = (node.lineno, node.col_offset)
        if key not in self.hits:
            self.hits[key] = (node, f"{what} on a device value ({prov}) "
                              "inside the dispatch loop — a whole-buffer "
                              "cross-device copy once per group (the "
                              "transfer analog of SLU113's host round "
                              "trip)")

    def visit_stmt(self, st) -> None:
        if self.loop_depth == 0:
            return
        if isinstance(st, (ast.If, ast.While)):
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


class CrossDeviceCopyRule(Rule):
    rule_id = RULE_LOOP_TRANSFER
    title = "cross-device-copy-in-dispatch-loop"
    hint = ("move buffers to their device ONCE before the loop (the "
            "prologue upload of StreamExecutor.__call__), or copy inside "
            "the captured graph / kernel; host uploads (host -> device) "
            "are exempt")
    package_dirs = ("numeric", "solve")

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        out = []
        for qname, fi in project.functions.items():
            if fi.path != path:
                continue
            flow = _TransferFlow.for_function(project, fi)
            flow.run()
            for key in sorted(flow.hits):
                node, msg = flow.hits[key]
                out.append(self.finding(path, node, msg))
        return out
