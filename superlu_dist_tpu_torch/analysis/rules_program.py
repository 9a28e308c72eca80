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

Three rules run over RECORDED PROGRAMS (``analysis/program.py``'s fake
walk, under the ``SLU_TPU_VERIFY_PROGRAMS=1`` runtime twin in
``utils/programaudit.py``) — the torch halves of the JAX package's jaxpr
rules:

SLU111 — in-place discipline.  Torch has no donation; its hazard is a
declared-DEAD argument of at least 1 MiB that the program copies out of
place — an op that reads it, writes nothing into it and returns a new
tensor at least as large — instead of updating it in place: the Schur
pool doubled at the moment it is largest.  Gathers (``index``,
``index_select``, ``gather``, ``take``) and the kernels (``slu::*``)
read addressed parts of an input, not a copy of it.  Stats: the dead
bytes, the in-place bytes (dead arguments never copied out of place) and
their share.

SLU112 — baked tensors.  A tensor of at least 256 KiB that the program
reads but that is not among its arguments (a closure's, an attribute's):
a CUDA graph holds its address, so a replay after it is rebound reads
stale data — the torch form of a program that identifies its matrix.
The error path names the capturing build site through the call graph.

SLU114 — collective lockstep.  Every collective's axes must be the
grid's (``parallel/grid.AXES``); and every rank must record the same
(op, axes) sequence for the same program — a Python branch is resolved
per rank, so a divergence shows between ranks, and the auditor compares
the ranks' digests in one exchange (``utils/programaudit.py``).

Port of the JAX package's ``analysis/rules_program.py``.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Finding, Rule, dotted_name
from superlu_dist_tpu_torch.analysis.dataflow import TAINT_DEVICE, FnFlow

RULE_INPLACE = "SLU111"
RULE_BAKED_CONST = "SLU112"
RULE_HOST_ROUNDTRIP = "SLU113"
RULE_COLLECTIVE_LOCKSTEP = "SLU114"

#: ops that read addressed parts of an input rather than copying it (an
#: output as large as the input is then a gather, not a copy)
GATHER_OPS = frozenset({"index", "index_select", "gather", "take",
                        "embedding"})

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


# --------------------------------------------------------------------------
# the program halves (recorded programs, analysis/program.py)
# --------------------------------------------------------------------------

def program_finding(rule: str, spec, message: str, hint: str) -> Finding:
    """A finding anchored at the program: there is no source line for a
    recorded program, but (site, label) identifies its build site."""
    return Finding(rule, f"<program:{spec.site}[{spec.label}]>", 0, 1,
                   message, hint)


def _reads_not_copies(op) -> bool:
    return op.op.startswith("slu.") or op.name in GATHER_OPS


def audit_inplace(spec, min_bytes: int):
    """SLU111: findings for declared-dead arguments of at least
    ``min_bytes`` copied out of place, plus {dead_bytes, inplace_bytes,
    inplace_coverage_pct}."""
    dead = {}                       # storage serial -> (position, TensorRec)
    for pos, t in spec.args:
        if pos in spec.dead:
            dead.setdefault(t.storage, (pos, t))
    copied = {}                     # storage serial -> the copying op
    for op in spec.ops:
        if _reads_not_copies(op):
            continue
        for i, t in enumerate(op.inputs):
            if t.storage not in dead or i in op.writes \
                    or t.storage in copied:
                continue
            whole = dead[t.storage][1].nbytes
            if any(op.outputs[k].nbytes >= whole for k in op.fresh):
                copied[t.storage] = op
    dead_bytes = sum(t.nbytes for _, t in dead.values())
    inplace_bytes = sum(t.nbytes for s, (_, t) in dead.items()
                        if s not in copied)
    findings = []
    for s, op in copied.items():
        pos, t = dead[s]
        if t.nbytes < min_bytes:
            continue
        findings.append(program_finding(
            RULE_INPLACE, spec,
            f"argument {pos} ({t.short()}, {t.nbytes} bytes) is dead after "
            f"the call but `{op.op}` copies it out of place — the new "
            "tensor lives beside the still-live argument, doubling this "
            "buffer's peak footprint",
            "update a dead argument in place (``x[idx] = v``, "
            "``index_add_``, ``copy_``, an ``out=``) — the Schur pool "
            "discipline of numeric/factor.group_step"))
    coverage = 100.0 if not dead_bytes else round(
        100.0 * inplace_bytes / dead_bytes, 2)
    return findings, {"dead_bytes": int(dead_bytes),
                      "inplace_bytes": int(inplace_bytes),
                      "inplace_coverage_pct": coverage}


def audit_baked_consts(spec, max_bytes: int):
    """SLU112: findings for tensors of at least ``max_bytes`` read from
    outside the arguments, plus {baked_const_bytes, n_consts}."""
    seen = {}                       # storage serial -> largest TensorRec
    for op in spec.ops:
        for t in op.inputs:
            if t.source == "outside" and (
                    t.storage not in seen or t.nbytes > seen[t.storage].nbytes):
                seen[t.storage] = t
    findings = []
    for t in seen.values():
        if t.nbytes < max_bytes:
            continue
        findings.append(program_finding(
            RULE_BAKED_CONST, spec,
            f"tensor {t.short()} ({t.nbytes} bytes) is read but is not "
            "among the program's arguments — a CUDA graph of it bakes "
            "the address, so a replay after the tensor is rebound reads "
            "stale data, and the program identifies its matrix",
            "pass large tensors as ARGUMENTS of the submitted program "
            "(the executors pass their maps and static buffers): program "
            "shapes may encode buckets, baked tensors must not encode "
            "matrices"))
    return findings, {"baked_const_bytes": int(sum(t.nbytes
                                                   for t in seen.values())),
                      "n_consts": len(seen)}


def audit_collective_lockstep(spec):
    """SLU114 (a): every recorded collective's axes must be the mesh's.
    Part (b), the ranks' sequences, needs the ranks: the runtime auditor
    exchanges one digest of :meth:`ProgramSpec.collective_sequence`."""
    if not spec.collectives or not spec.mesh_axes:
        return []
    valid = set(spec.mesh_axes)
    findings = []
    for c in spec.collectives:
        bad = [a for a in c.axes if a not in valid]
        if bad:
            findings.append(program_finding(
                RULE_COLLECTIVE_LOCKSTEP, spec,
                f"collective `{c.op}` runs over axis "
                f"{','.join(map(repr, bad))}, which is not an axis of the "
                f"grid ({sorted(valid)}) — the program cannot run in "
                "lockstep on the grid it was built for",
                "collectives must name the grid's axes "
                "(parallel/grid.AXES)"))
    return findings


def rank_divergence_finding(spec, mine: int, others: dict):
    """SLU114 (b): the finding every rank raises when the ranks recorded
    different collective sequences for one program (``others``: rank ->
    digest, this rank's ``mine``)."""
    ranks = sorted(r for r, d in others.items() if d != mine)
    return program_finding(
        RULE_COLLECTIVE_LOCKSTEP, spec,
        f"ranks recorded DIVERGENT collective sequences for this program "
        f"(this rank: {len(spec.collectives)} collective(s), "
        f"{[f'{c.op}@{list(c.axes)}' for c in spec.collectives][:6]}; "
        f"rank(s) {ranks} differ) — some ranks would enter a collective "
        "their peers never reach (the in-program SLU101 deadlock)",
        "make every rank run the identical collective sequence: hoist "
        "collectives out of rank-dependent branches")


# --------------------------------------------------------------------------
# catalog stubs: the program rules have no source half, but they need
# Rule identities so ``--rules`` selects them and ``--list-rules`` and
# the SARIF catalog describe them
# --------------------------------------------------------------------------

class InPlaceRule(Rule):
    rule_id = RULE_INPLACE
    title = "dead-argument-copied-out-of-place"
    hint = ("the program walk (audit_inplace) runs under "
            "SLU_TPU_VERIFY_PROGRAMS=1 — the source scan has nothing to "
            "check")

    def check(self, tree, source, path, project=None):
        return []


class BakedConstRule(Rule):
    rule_id = RULE_BAKED_CONST
    title = "baked-tensor-blowup"
    hint = ("the program walk (audit_baked_consts) runs under "
            "SLU_TPU_VERIFY_PROGRAMS=1 — the source scan has nothing to "
            "check")

    def check(self, tree, source, path, project=None):
        return []


class CollectiveLockstepRule(Rule):
    rule_id = RULE_COLLECTIVE_LOCKSTEP
    title = "grid-collective-lockstep"
    hint = ("the program walk (audit_collective_lockstep and the ranks' "
            "digest exchange) runs under SLU_TPU_VERIFY_PROGRAMS=1 — the "
            "source scan has nothing to check")

    def check(self, tree, source, path, project=None):
        return []
