"""SARIF 2.1.0 serialization for slulint findings.

``--format sarif`` on the CLI emits the Static Analysis Results
Interchange Format so findings annotate PRs in standard tooling (GitHub
code scanning, IDE SARIF viewers) without a custom adapter.
``from_sarif`` parses the subset ``to_sarif`` writes — the round-trip
contract tests/test_torch_analysis.py pins.  Port of the JAX package's
``analysis/sarif.py``.
"""

from __future__ import annotations

from superlu_dist_tpu_torch.analysis.core import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings, rules, baselined: int = 0) -> dict:
    """One SARIF run: the slulint driver with its rule catalog, one
    result per finding (file/line/col + message, hint as a related
    message property)."""
    catalog = []
    for r in rules:
        catalog.append({
            "id": r.rule_id,
            "name": (r.title or r.rule_id).replace("-", " ").title()
                    .replace(" ", ""),
            "shortDescription": {"text": r.title or r.rule_id},
            "help": {"text": r.hint or ""},
        })
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path.replace("\\", "/")},
                    "region": {"startLine": max(int(f.line), 1),
                               "startColumn": max(int(f.col), 1)},
                },
            }],
            "properties": {"hint": f.hint, "line": int(f.line),
                           "col": int(f.col)},
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "slulint",
                "fullName": "superlu_dist_tpu_torch.analysis",
                "informationUri":
                    "superlu_dist_tpu_torch/analysis/__init__.py",
                "rules": catalog,
            }},
            "results": results,
            "properties": {"baselined": int(baselined)},
        }],
    }


def from_sarif(doc: dict) -> list:
    """Findings back out of a ``to_sarif`` document (the round-trip
    subset: ruleId, uri, region, message text, hint property)."""
    out = []
    for run in doc.get("runs", ()):
        for res in run.get("results", ()):
            loc = (res.get("locations") or [{}])[0] \
                .get("physicalLocation", {})
            region = loc.get("region", {})
            props = res.get("properties", {})
            out.append(Finding(
                res.get("ruleId", "?"),
                loc.get("artifactLocation", {}).get("uri", "?"),
                int(props.get("line", region.get("startLine", 0))),
                int(props.get("col", region.get("startColumn", 1))),
                res.get("message", {}).get("text", ""),
                props.get("hint", "")))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out
