"""slulint CLI — `python -m superlu_dist_tpu_torch.analysis [paths...]`.

Exit codes: 0 = clean (or every finding baselined/suppressed),
1 = new findings, 2 = usage error.  Pure host-side text processing:
imports neither jax nor the JAX package, and torch only for SLU104's
knob registry.

The scan is two-pass: pass one builds the package-wide call graph +
dataflow summaries (analysis/callgraph.py, analysis/dataflow.py) over
every scanned file, pass two runs the rules with that project in hand so
SLU101/SLU102/SLU103/SLU105/SLU113 resolve cross-module indirection.

Port of the JAX package's ``analysis/__main__.py``, with its flags and
exit codes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from superlu_dist_tpu_torch.analysis import baseline as bl
from superlu_dist_tpu_torch.analysis.core import (analyze_source,
                                                  default_rules, read_sources)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the port's sources, relative to the repo root
DEFAULT_PATHS = ["superlu_dist_tpu_torch", "chip_smoke.py",
                 "scripts/mfu_report_torch.py",
                 "scripts/trace_cost_torch.py"]


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m superlu_dist_tpu_torch.analysis",
        description="slulint for superlu_dist_tpu_torch: project-native "
                    "static analysis (collective-safety SLU101, "
                    "capture purity SLU102, index-width SLU103, "
                    "env-knob registry SLU104, graph-cache keys SLU105, "
                    "graph-key shape diversity SLU107, "
                    "shared-mutable access SLU108, lock-order/"
                    "hold-discipline SLU109, thread lifecycle SLU110, "
                    "dispatch-loop host round-trips SLU113, implicit "
                    "downcast SLU115, GEMMs outside the ladder SLU116, "
                    "tolerance hygiene SLU118, dispatch-loop "
                    "cross-device copies SLU122; the SLU106 runtime twin "
                    "lives in parallel/treecomm.py and parallel/grid.py "
                    "under SLU_TPU_VERIFY_COLLECTIVES=1, the SLU109 "
                    "runtime twin in utils/lockwatch.py under "
                    "SLU_TPU_VERIFY_LOCKS=1)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to scan (default: the package, "
                        "chip_smoke.py and the port's scripts)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON path (default: .slulint-torch-"
                        "baseline.json at the repo root when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to the baseline and "
                        "exit 0")
    p.add_argument("--update-baseline", action="store_true",
                   help="prune baseline entries no longer matched by any "
                        "current finding (fixed findings), print the "
                        "drift, and exit 0 — never adds new entries")
    p.add_argument("--no-dataflow", action="store_true",
                   help="lexical-only SLU101/SLU103 (no call graph, no "
                        "taint propagation) — for measuring what the "
                        "interprocedural tier adds")
    p.add_argument("--format", default=None, dest="fmt",
                   choices=("text", "json", "sarif"),
                   help="output format (default text; sarif = SARIF "
                        "2.1.0 for PR-annotation tooling)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (alias of --format json)")
    p.add_argument("--no-cache", action="store_true",
                   help="bypass the content-hash scan cache "
                        "(.slulint-torch-cache.json) — reads AND writes")
    p.add_argument("--cache", default=None,
                   help="cache file path (default: "
                        ".slulint-torch-cache.json at the repo root)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _update_baseline(baseline_path, findings, sources) -> int:
    """Drop baseline entries that no current finding matches (they were
    fixed) and report the drift.  New findings are NOT added — that is
    --write-baseline's explicit, deliberate act."""
    if not os.path.exists(baseline_path):
        print(f"no baseline at {baseline_path} — nothing to update")
        return 0
    entries = bl.load(baseline_path)
    new, matched = bl.filter_new(findings, sources, entries,
                                 root=_REPO_ROOT)
    kept = [bl.entry(f, sources[f.path], root=_REPO_ROOT) for f in matched]
    stale = len(entries) - len(kept)
    bl.write(baseline_path, kept)
    print(f"baseline {baseline_path}: {len(entries)} -> {len(kept)} "
          f"entries ({stale} stale pruned)")
    if new:
        print(f"note: {len(new)} NEW finding(s) not added (fix them or "
              "use --write-baseline deliberately):")
        for f in new:
            print("  " + f.render().splitlines()[0])
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    rules = default_rules()
    if args.no_dataflow:
        from superlu_dist_tpu_torch.analysis.rules_collective import \
            CollectiveRule
        from superlu_dist_tpu_torch.analysis.rules_index import \
            IndexWidthRule
        from superlu_dist_tpu_torch.analysis.rules_trace import \
            GraphCacheKeyRule
        for r in rules:
            if isinstance(r, (CollectiveRule, IndexWidthRule,
                              GraphCacheKeyRule)):
                r.interprocedural = False
    if args.list_rules:
        for r in rules:
            print(f"{r.rule_id}  {r.title}")
        return 0
    if args.rules:
        wanted = {x.strip() for x in args.rules.split(",") if x.strip()}
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in wanted]

    if not args.paths:
        args.paths = [os.path.relpath(os.path.join(_REPO_ROOT, p))
                      for p in DEFAULT_PATHS]
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2

    sources = read_sources(args.paths)
    # incremental scan: a warm content-hash cache skips parse, call
    # graph, dataflow AND rules for the unchanged tree (analysis/
    # cache.py); a filtered rule set or the lexical tier bypasses it
    # (the cache stores full-default-scan results only)
    from superlu_dist_tpu_torch.analysis import cache as sc
    cache_path = args.cache or os.path.join(_REPO_ROOT,
                                            sc.DEFAULT_CACHE_NAME)
    use_cache = not (args.no_cache or args.rules or args.no_dataflow)
    cache_state = "off"
    findings = None
    if use_cache:
        findings = sc.lookup(cache_path, sources, rules)
        if findings is not None:
            cache_state = "hit"
    if findings is None:
        project = None
        if not args.no_dataflow:
            from superlu_dist_tpu_torch.analysis.callgraph import build_project
            project = build_project(sources)
        findings = []
        for path, source in sources.items():
            findings.extend(analyze_source(source, path, rules, project))
        if use_cache:
            sc.store(cache_path, sources, rules, findings)
            cache_state = "miss"

    baseline_path = args.baseline or os.path.join(
        _REPO_ROOT, bl.DEFAULT_BASELINE_NAME)
    if args.write_baseline:
        bl.write(baseline_path,
                 [bl.entry(f, sources[f.path], root=_REPO_ROOT)
                  for f in findings])
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0
    if args.update_baseline:
        return _update_baseline(baseline_path, findings, sources)

    baselined = []
    if not args.no_baseline and os.path.exists(baseline_path):
        entries = bl.load(baseline_path)
        findings, baselined = bl.filter_new(findings, sources, entries,
                                            root=_REPO_ROOT)

    fmt = args.fmt or ("json" if args.as_json else "text")
    if fmt == "json":
        print(json.dumps({
            "findings": [vars(f) for f in findings],
            "baselined": len(baselined),
            "cache": cache_state,
            "files": len(sources),
            "rules": [r.rule_id for r in rules]}, indent=1))
    elif fmt == "sarif":
        from superlu_dist_tpu_torch.analysis.sarif import to_sarif
        print(json.dumps(to_sarif(findings, rules,
                                  baselined=len(baselined)), indent=1))
    else:
        for f in findings:
            print(f.render())
        tail = f" ({len(baselined)} baselined)" if baselined else ""
        cached = f" [cache {cache_state}]" if cache_state != "off" else ""
        print(f"slulint: {len(findings)} finding(s){tail} in "
              f"{len(sources)} file(s){cached}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
