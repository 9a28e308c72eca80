"""SLU122 — cross-device copy in a per-group dispatch loop.

Extends SLU113's device taint: ``.to(<device>)`` or ``.cuda()`` of a
DEVICE value, or a ``dst.copy_(src)`` of a device value into a HOST
tensor (the lattice's host taint: ``.cpu()``, ``.pin_memory()``, a
factory given the host), inside a per-group For/While dispatch loop in
numeric/ or solve/ is a whole-buffer copy once per group — the transfer
analog of SLU113's host round trip.  Host-side uploads (a host tensor
``.to(dev)``, a device tensor ``.copy_`` from the host) are exempt: the
taint gate only fires when the value already lives on a device.

Two rules run over RECORDED PROGRAMS (``analysis/program.py``, under
``SLU_TPU_VERIFY_SHARDING=1`` or a positive ``SLU_TPU_MEM_BUDGET_BYTES``):

SLU119 — implicit replication.  A gathering grid collective
(``ProcessGrid.all_gather`` / ``gather_rows``) that delivers at least
1 MiB to every rank: the whole buffer on each, so the per-rank footprint
stops shrinking with the grid.  Stats: ``replicated_bytes``,
``n_gathers``.

SLU121 — peak memory.  The walk's high-water live bytes (the arguments,
tensors from outside them, every op output from its op until Python
drops it, the kernels' scratch) is ``peak_bytes_est``; above the budget
the submit raises ``MemoryBudgetError`` naming the largest buffers live
at the peak.

Port of the SLU119 / SLU121 / SLU122 halves of the JAX package's
``analysis/rules_sharding.py`` (SLU122 there: ``jax.device_put`` /
``.reshard`` of a device value).  SLU120 checks mesh-axis names against
the JAX package's axis registry, which the port does not have.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Rule
from superlu_dist_tpu_torch.analysis.dataflow import (TAINT_DEVICE, TAINT_HOST,
                                                      FnFlow, is_host_device,
                                                      to_device_arg)

RULE_IMPLICIT_RESHARD = "SLU119"
RULE_PEAK_MEMORY = "SLU121"
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


# --------------------------------------------------------------------------
# the program halves (recorded programs, analysis/program.py)
# --------------------------------------------------------------------------

def audit_resharding(spec, min_bytes: int):
    """SLU119: findings for gathering collectives delivering at least
    ``min_bytes``, plus {replicated_bytes, n_gathers}."""
    from superlu_dist_tpu_torch.analysis.program import GATHERING_COLLECTIVES
    from superlu_dist_tpu_torch.analysis.rules_program import program_finding
    findings = []
    replicated = n = 0
    for c in spec.collectives:
        if c.op not in GATHERING_COLLECTIVES:
            continue
        n += 1
        replicated += c.nbytes
        if c.nbytes < min_bytes:
            continue
        findings.append(program_finding(
            RULE_IMPLICIT_RESHARD, spec,
            f"`{c.op}` over axis {','.join(map(repr, c.axes))} "
            f"materializes {c.nbytes} gathered bytes on every rank — the "
            "implicit-replication blowup (a gathered Schur pool is an "
            "OOM at scale, not a slowdown)",
            "keep the operand rank-resident: reduce instead of gathering, "
            "or send each block only to the rank that extend-adds it (the "
            "2-D executor's exchange)"))
    return findings, {"replicated_bytes": int(replicated),
                      "n_gathers": int(n)}


def audit_peak_memory(spec, budget_bytes: int):
    """SLU121: the walk's high-water live bytes; a finding when a
    positive budget is exceeded.  Returns (findings, {peak_bytes_est,
    args_bytes, n_ops})."""
    from superlu_dist_tpu_torch.analysis.rules_program import program_finding
    peak = int(spec.peak_bytes)
    findings = []
    if budget_bytes and budget_bytes > 0 and peak > budget_bytes:
        top = ", ".join(f"{what} ({nb} B)" for nb, what in spec.peak_buffers)
        findings.append(program_finding(
            RULE_PEAK_MEMORY, spec,
            f"peak live bytes {peak} exceed the SLU_TPU_MEM_BUDGET_BYTES "
            f"budget of {budget_bytes} (largest live at the peak: "
            f"{top or 'none'})",
            "shrink the padded rung or the batch, update dead buffers in "
            "place, or raise the budget — the estimate frees each tensor "
            "when Python drops it, so anything above it is structural"))
    return findings, {"peak_bytes_est": peak,
                      "args_bytes": int(spec.args_bytes),
                      "n_ops": len(spec.ops)}


# --------------------------------------------------------------------------
# catalog stubs (their checks run over recorded programs only)
# --------------------------------------------------------------------------

class ImplicitReshardRule(Rule):
    rule_id = RULE_IMPLICIT_RESHARD
    title = "implicit-replication-blowup"
    hint = ("keep large operands rank-resident; the program walk "
            "(audit_resharding) runs under SLU_TPU_VERIFY_SHARDING=1 — "
            "the source scan has nothing to check")

    def check(self, tree, source, path, project=None):
        return []


class PeakMemoryRule(Rule):
    rule_id = RULE_PEAK_MEMORY
    title = "static-peak-memory-budget"
    hint = ("the program walk (audit_peak_memory) runs under "
            "SLU_TPU_VERIFY_SHARDING=1 / SLU_TPU_MEM_BUDGET_BYTES — the "
            "source scan has nothing to check")

    def check(self, tree, source, path, project=None):
        return []
