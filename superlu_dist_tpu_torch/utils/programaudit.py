"""The runtime program audits: SLU111 / SLU112 / SLU114
(``SLU_TPU_VERIFY_PROGRAMS``), SLU115 / SLU116 (``SLU_TPU_VERIFY_DTYPES``),
SLU119 / SLU121 (``SLU_TPU_VERIFY_SHARDING``, or a positive
``SLU_TPU_MEM_BUDGET_BYTES``) — registered knobs.

Port of the JAX package's ``utils/programaudit.py``.  The executors
submit each program once, before it first runs (``maybe_audit``): a
group's ``group_step`` at the first dispatch of its shape key
(numeric/stream.py), the fused and level waves and mega's buckets before
their warm-up (numeric/stream.py, numeric/mega.py), the solve sweeps
(solve/device.py), the spmd factor and sweeps (parallel/spmd.py) and the
2-D group programs (parallel/mesh_stream.py, mesh_graphs.py).  Each
auditor runs the program once on fake tensors (``analysis/program.
trace_spec``: no memory, no device work, no kernel launch), walks the
record against its rules and raises a structured error
(``utils/errors.py``, with a flight-recorder postmortem) before the
program ever runs, or memoizes the clean verdict by (site, label).

A program on a grid of several ranks (one with a ProcessGrid among its
arguments) ends each auditor's audit with one exchange over the grid:
each rank's digest of its collective sequence and the rules its
findings broke.
Every rank audits the same programs in the same order, so the exchange
sits where every rank reaches it; a divergence (SLU114) or a finding on
any rank raises on every rank.  Every rank of a grid must set the same
knobs.

Off path (every knob unset): ``get_auditor`` / ``get_dtype_auditor`` /
``get_sharding_auditor`` return None and allocate nothing — a few env
reads per build site.  The census of clean programs is
:func:`audit_block`.  Each audit also notes its stats in the build
census (obs/compilestats.py) under the program's own tagged label,
``audit_note(site, label[#dtypes|#sharding])`` as the JAX package does;
the census sums the notes into ``stats.compile["program_audit"]``, and
the census row of the graph the program is captured into (``build=``)
carries the sharding audit's ``peak_bytes_est``.
"""

from __future__ import annotations

import hashlib
import time

from superlu_dist_tpu_torch.utils.options import env_flag, env_int

#: SLU111 only flags dead arguments at least this large — small scalars
#: and index vectors are not the peak-memory axis
INPLACE_MIN_BYTES = 1 << 20
#: SLU112 flags outside tensors at least this large — a threshold
#: scalar or a small table is not the per-matrix-capture pattern
CONST_MAX_BYTES = 1 << 18
#: SLU119 only prices gathers at least this large
RESHARD_MIN_BYTES = 1 << 20

_AUDITOR = None
_DTYPE_AUDITOR = None
_SHARDING_AUDITOR = None
#: host seconds spent walking and auditing, since the last ``_reset``
_SECONDS = 0.0


def get_auditor():
    """The process-wide program auditor, or None (allocating nothing)
    when ``SLU_TPU_VERIFY_PROGRAMS`` is off."""
    global _AUDITOR
    if not env_flag("SLU_TPU_VERIFY_PROGRAMS"):
        return None
    if _AUDITOR is None:
        _AUDITOR = ProgramAuditor()
    return _AUDITOR


def get_dtype_auditor():
    """The process-wide precision auditor, or None when
    ``SLU_TPU_VERIFY_DTYPES`` is off."""
    global _DTYPE_AUDITOR
    if not env_flag("SLU_TPU_VERIFY_DTYPES"):
        return None
    if _DTYPE_AUDITOR is None:
        _DTYPE_AUDITOR = DtypeAuditor()
    return _DTYPE_AUDITOR


def get_sharding_auditor():
    """The process-wide sharding / memory auditor, or None when both
    ``SLU_TPU_VERIFY_SHARDING`` and ``SLU_TPU_MEM_BUDGET_BYTES`` are off
    — a positive budget implies the audit without the flag."""
    global _SHARDING_AUDITOR
    budget = env_int("SLU_TPU_MEM_BUDGET_BYTES")
    if not env_flag("SLU_TPU_VERIFY_SHARDING") and budget <= 0:
        return None
    if _SHARDING_AUDITOR is None:
        _SHARDING_AUDITOR = ShardingAuditor(budget_bytes=budget)
    return _SHARDING_AUDITOR


def _reset() -> None:
    """Test hygiene: drop the auditors so a knob flip re-latches."""
    global _AUDITOR, _DTYPE_AUDITOR, _SHARDING_AUDITOR, _SECONDS
    _AUDITOR = _DTYPE_AUDITOR = _SHARDING_AUDITOR = None
    _SECONDS = 0.0


def find_build_site(site: str) -> str | None:
    """Best-effort source location of a build site such as
    ``stream._step``, through the port's slulint call graph — it names
    the CAPTURING site in SLU112 reports.  Runs on the error path only
    (it parses the package)."""
    import os
    try:
        from superlu_dist_tpu_torch.analysis.callgraph import build_project
        from superlu_dist_tpu_torch.analysis.core import read_sources
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        mod, _, fn_name = site.rpartition(".")
        proj = build_project(read_sources([pkg]))
        hits = [fi for q, fi in proj.functions.items()
                if q.rsplit(".", 1)[-1] == fn_name]
        hits.sort(key=lambda fi: mod not in fi.module)
        if hits:
            return f"{hits[0].path}:{hits[0].node.lineno}"
    except Exception:
        pass
    return None


def _rule_bits(findings) -> int:
    """The rules of ``findings`` as a bit mask (bit k: SLU1xx with
    xx - 10 = k) — what the ranks exchange."""
    bits = 0
    for f in findings:
        bits |= 1 << (int(f.rule[3:]) - 110)
    return bits


def _digest(spec) -> int:
    h = hashlib.sha256(repr(spec.collective_sequence()).encode()).digest()
    return int.from_bytes(h[:7], "little")


def _agree(spec, findings):
    """One exchange over a grid program's ranks: (their digests by rank,
    the findings the other ranks' audits broke, as findings here).  A
    one-rank (or grid-less) program exchanges nothing."""
    grid = spec.grid
    if grid is None or grid.nproc < 2:
        return None, []
    import torch
    from superlu_dist_tpu_torch.analysis.rules_program import program_finding
    mine = torch.tensor([[_digest(spec), _rule_bits(findings)]],
                        dtype=torch.int64)
    every = grid.all_gather(mine.to(grid.device)).cpu().tolist()
    digests = {r: d for r, (d, _) in enumerate(every)}
    peers = []
    for r, (_, bits) in enumerate(every):
        if r == grid.rank or not bits:
            continue
        for k in range(bits.bit_length()):
            if bits >> k & 1:
                peers.append(program_finding(
                    f"SLU{110 + k}", spec,
                    f"rank {r}'s audit of this program found an "
                    f"SLU{110 + k} finding (every rank raises)",
                    f"see rank {r}'s error"))
    return digests, peers


class _Auditor:
    """Audits each (site, label) program once; clean verdicts memoized
    so a lazy build site pays one walk per distinct program, ever."""

    metric = ""
    #: the suffix of this auditor's notes in the build census
    note = ""

    def __init__(self):
        self.audited: dict = {}     # (site, label) -> stats
        self.findings: list = []    # every finding raised (evidence)

    def _audit(self, spec) -> tuple:
        raise NotImplementedError

    def _raise(self, site, label, findings, stats):
        raise NotImplementedError

    def check(self, spec, build=None) -> dict:
        """Audit one recorded program (``analysis/program.trace_spec``;
        the auditors of one ``maybe_audit`` share its walk): raises on any
        finding (on every rank of a grid program), returns the stats when
        clean.  The stats are noted in the build census under the
        program's own (site, label); ``build`` is the census (site, key)
        of the graph it is captured into, if any."""
        site, label = spec.site, spec.label
        findings, stats = self._audit(spec)
        digests, peers = _agree(spec, findings)
        findings += self._diverged(spec, digests)
        findings += peers
        stats["findings"] = len(findings)
        from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
        COMPILE_STATS.audit_note(site, label + self.note, stats,
                                 build=build)
        from superlu_dist_tpu_torch.obs.metrics import get_metrics
        m = get_metrics()
        if m.enabled:
            m.inc(self.metric, 1.0, site=site,
                  result="finding" if findings else "clean")
        if findings:
            self.findings.extend(findings)
            self._raise(site, label, findings, stats)
        self.audited[(site, label)] = stats
        return stats

    def _diverged(self, spec, digests) -> list:
        return []


class ProgramAuditor(_Auditor):
    """SLU111 / SLU112 / SLU114."""

    metric = "slu_program_audit_total"

    def __init__(self, inplace_min_bytes: int = INPLACE_MIN_BYTES,
                 const_max_bytes: int = CONST_MAX_BYTES):
        super().__init__()
        self.inplace_min_bytes = int(inplace_min_bytes)
        self.const_max_bytes = int(const_max_bytes)

    def _audit(self, spec):
        from superlu_dist_tpu_torch.analysis.program import audit_spec
        findings, stats = audit_spec(spec, self.inplace_min_bytes,
                                     self.const_max_bytes)
        stats["digest"] = f"{_digest(spec):014x}"
        return findings, stats

    def _diverged(self, spec, digests):
        if not digests:
            return []
        mine = digests[spec.grid.rank]
        if all(d == mine for d in digests.values()):
            return []
        from superlu_dist_tpu_torch.analysis.rules_program import (
            rank_divergence_finding)
        return [rank_divergence_finding(spec, mine, digests)]

    def _raise(self, site, label, findings, stats):
        if any(f.rule == "SLU112" for f in findings):
            src = find_build_site(site)
            if src:
                for f in findings:
                    if f.rule == "SLU112":
                        f.message += f" (capturing build site: {src})"
        from superlu_dist_tpu_torch.utils.errors import ProgramAuditError
        raise ProgramAuditError(site=site, program=label, findings=findings)


class DtypeAuditor(_Auditor):
    """SLU115 / SLU116: a separate auditor, so either knob works alone
    (with both on, ``maybe_audit`` walks each program once for both)."""

    metric = "slu_precision_audit_total"
    note = "#dtypes"

    def _audit(self, spec):
        from superlu_dist_tpu_torch.analysis.program import audit_dtypes
        return audit_dtypes(spec)

    def _raise(self, site, label, findings, stats):
        from superlu_dist_tpu_torch.utils.errors import PrecisionAuditError
        raise PrecisionAuditError(site=site, program=label,
                                  findings=findings)


class ShardingAuditor(_Auditor):
    """SLU119 / SLU121: an SLU121 budget breach raises
    MemoryBudgetError, any other finding ShardingAuditError."""

    metric = "slu_sharding_audit_total"
    note = "#sharding"

    def __init__(self, reshard_min_bytes: int = RESHARD_MIN_BYTES,
                 budget_bytes: int = 0):
        super().__init__()
        self.reshard_min_bytes = int(reshard_min_bytes)
        self.budget_bytes = int(budget_bytes)

    def _audit(self, spec):
        from superlu_dist_tpu_torch.analysis.program import audit_sharding
        return audit_sharding(spec, self.reshard_min_bytes,
                              self.budget_bytes)

    def _raise(self, site, label, findings, stats):
        from superlu_dist_tpu_torch.utils.errors import (MemoryBudgetError,
                                                         ShardingAuditError)
        if any(f.rule == "SLU121" for f in findings):
            raise MemoryBudgetError(
                site=site, program=label, findings=findings,
                peak_bytes=stats.get("peak_bytes_est", 0),
                budget_bytes=self.budget_bytes)
        raise ShardingAuditError(site=site, program=label,
                                 findings=findings)


def maybe_audit(site: str, label: str, fn, args, *, dead=(), mesh_axes=(),
                device=None, build=None) -> dict | None:
    """The one-line build-site hook: nothing (and no state) when every
    knob is off; else the program auditor, then the precision auditor,
    then the sharding auditor, each memoizing on its own — sharing one
    walk of the program among those that have not seen it.  ``build``:
    the census (site, key) of the graph the program is captured into.
    Returns the first active auditor's stats."""
    global _SECONDS
    out = spec = None
    for aud in (get_auditor(), get_dtype_auditor(), get_sharding_auditor()):
        if aud is None:
            continue
        stats = aud.audited.get((site, label))
        if stats is None:
            t0 = time.perf_counter()
            try:
                if spec is None:
                    from superlu_dist_tpu_torch.analysis.program import (
                        trace_spec)
                    spec = trace_spec(fn, args, label=label, site=site,
                                      dead=dead, mesh_axes=mesh_axes,
                                      device=device)
                stats = aud.check(spec, build)
            finally:
                _SECONDS += time.perf_counter() - t0
        out = stats if out is None else out
    return out


def audit_block() -> dict:
    """What the audits saw in this process — the port's stand-in for the
    JAX package's compile-census audit block: programs audited (distinct
    (site, label)), per site, findings raised, in-place coverage over
    the dead bytes, baked bytes, and the largest peak estimate with its
    program."""
    auds = [a for a in (_AUDITOR, _DTYPE_AUDITOR, _SHARDING_AUDITOR)
            if a is not None]
    keys = {k for a in auds for k in a.audited}
    prog = _AUDITOR.audited if _AUDITOR is not None else {}
    shard = _SHARDING_AUDITOR.audited if _SHARDING_AUDITOR is not None \
        else {}
    dead = sum(s["dead_bytes"] for s in prog.values())
    inplace = sum(s["inplace_bytes"] for s in prog.values())
    top = max(shard.items(), key=lambda kv: kv[1]["peak_bytes_est"],
              default=(None, None))
    sites = {}
    for site, _ in keys:
        sites[site] = sites.get(site, 0) + 1
    return {"programs": len(keys), "sites": sites, "seconds": _SECONDS,
            "findings": sum(len(a.findings) for a in auds),
            "programs_audited": len(prog),
            "programs_dtypes_audited": len(_DTYPE_AUDITOR.audited)
            if _DTYPE_AUDITOR is not None else 0,
            "programs_sharding_audited": len(shard),
            "dead_bytes": int(dead), "inplace_bytes": int(inplace),
            "inplace_coverage_pct": 100.0 if not dead
            else round(100.0 * inplace / dead, 2),
            "baked_const_bytes": int(sum(s["baked_const_bytes"]
                                         for s in prog.values())),
            "replicated_bytes": int(sum(s["replicated_bytes"]
                                        for s in shard.values())),
            "peak_bytes_est": int(top[1]["peak_bytes_est"]) if top[1]
            else 0,
            "peak_program": list(top[0]) if top[0] else None}
