"""Committed JSON baseline for slulint findings.

The gate (``python -m superlu_dist_tpu_torch.analysis``, run by the
tests and by chip_smoke.py's lint phase) must fail only on NEW findings, so
known ones are grandfathered in a committed baseline file.  Entries are
keyed by (rule, normalized path, fingerprint of the flagged source
line), NOT by line number — findings survive unrelated edits above them
and go stale only when the flagged line itself changes (at which point
the author must re-justify or fix).

The project's target state is an EMPTY baseline: real findings get fixed
or carry an inline ``# slulint: disable=SLUxxx`` with a justification.
The baseline exists for the migration window after a new rule lands.

Port of the JAX package's ``analysis/baseline.py``; this package's
baseline is ``.slulint-torch-baseline.json`` at the repo root.
"""

from __future__ import annotations

import hashlib
import json
import os

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = ".slulint-torch-baseline.json"


def _norm_path(path: str, root: str | None = None) -> str:
    if root:
        try:
            path = os.path.relpath(path, root)
        except ValueError:
            pass
    return path.replace(os.sep, "/")


def fingerprint(source: str, line: int) -> str:
    """Hash of the flagged line with whitespace collapsed (indentation
    changes and reformatting don't invalidate the entry)."""
    lines = source.splitlines()
    text = lines[line - 1] if 1 <= line <= len(lines) else ""
    return hashlib.sha256(" ".join(text.split()).encode()).hexdigest()[:16]


def entry(finding, source: str, root: str | None = None) -> dict:
    return {"rule": finding.rule,
            "path": _norm_path(finding.path, root),
            "fingerprint": fingerprint(source, finding.line)}


def write(path: str, entries) -> None:
    doc = {"version": BASELINE_VERSION,
           "findings": sorted(entries, key=lambda e: (e["path"], e["rule"],
                                                      e["fingerprint"]))}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def load(path: str) -> list:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{doc.get('version')!r}")
    return list(doc.get("findings", []))


def filter_new(findings, sources: dict, baseline_entries,
               root: str | None = None):
    """Split findings into (new, baselined).  Each baseline entry
    absorbs at most one finding (a multiset match), so adding a second
    identical-looking violation on a changed line still fails the gate."""
    budget: dict = {}
    for e in baseline_entries:
        key = (e["rule"], e["path"], e["fingerprint"])
        budget[key] = budget.get(key, 0) + 1
    new, old = [], []
    for f in findings:
        key = (f.rule, _norm_path(f.path, root),
               fingerprint(sources[f.path], f.line))
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
