"""Incremental slulint: a content-hash-keyed scan-result cache.

A cold scan of this package costs seconds (the concurrency model and
the dataflow passes dominate), while a test suite or a pre-commit hook
re-scans the unchanged tree once per invocation.  This cache makes the
warm whole-tree rescan sub-second:
``.slulint-torch-cache.json`` (gitignored) stores per-file findings keyed by
each file's content sha256, plus a TREE signature over the whole
(path, sha) set and a RULE-SET signature.

Soundness: slulint is interprocedural — a changed CALLEE can
change a caller's findings — so per-file results are only valid against
the exact project they were computed in.  The tree signature encodes
that: a warm hit requires every file unchanged (then parse, call graph,
dataflow and all rules are skipped outright); any change re-scans the
whole tree and rewrites the cache.  The per-file hashes are what makes
the validity check exact, and the cache is invalidated wholesale when
the rule set or engine version changes (core.ANALYSIS_VERSION in the
rules signature) or when the scanned path set differs.

``--no-cache`` on the CLI bypasses reads AND writes (the escape hatch
for debugging the engine itself).

Port of the JAX package's ``analysis/cache.py``, with a cache file of
its own.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

from superlu_dist_tpu_torch.analysis.core import ANALYSIS_VERSION, Finding

CACHE_VERSION = 1
DEFAULT_CACHE_NAME = ".slulint-torch-cache.json"

_FIELDS = ("rule", "line", "col", "message", "hint")


def rules_signature(rules) -> str:
    """Identity of the rule set + engine semantics: rule ids plus the
    analysis version (bumped on any rule/engine change)."""
    ids = ",".join(sorted(r.rule_id for r in rules))
    blob = f"v{CACHE_VERSION}:{ANALYSIS_VERSION}:{ids}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def file_sha(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8", "replace")).hexdigest()[:16]


def tree_signature(hashes: dict) -> str:
    blob = "\n".join(f"{p}\0{h}" for p, h in sorted(hashes.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def lookup(path: str, sources: dict, rules) -> list | None:
    """Findings from a warm cache, or None on any mismatch (missing
    file, changed content, different path set, different rule set)."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if doc.get("version") != CACHE_VERSION:
        return None
    if doc.get("rules_sig") != rules_signature(rules):
        return None
    hashes = {p: file_sha(src) for p, src in sources.items()}
    if doc.get("tree_sig") != tree_signature(hashes):
        return None
    files = doc.get("files", {})
    if set(files) != set(sources):
        return None
    out = []
    for p in sorted(files):
        if files[p].get("sha") != hashes[p]:
            return None
        for f in files[p].get("findings", ()):
            out.append(Finding(f["rule"], p, int(f["line"]), int(f["col"]),
                               f["message"], f.get("hint", "")))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def store(path: str, sources: dict, rules, findings) -> None:
    """Write the scan result atomically (tmp + rename — a killed writer
    leaves the previous cache intact)."""
    hashes = {p: file_sha(src) for p, src in sources.items()}
    files = {p: {"sha": hashes[p], "findings": []} for p in sources}
    for f in findings:
        if f.path in files:
            files[f.path]["findings"].append(
                {k: getattr(f, k) for k in _FIELDS})
    doc = {"version": CACHE_VERSION,
           "rules_sig": rules_signature(rules),
           "tree_sig": tree_signature(hashes),
           "files": files}
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd, tmp = tempfile.mkstemp(prefix=".slulint-torch-cache.", dir=d)
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
    except OSError:
        pass      # caching is best-effort; the scan result stands
