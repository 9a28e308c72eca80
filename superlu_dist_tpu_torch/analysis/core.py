"""slulint engine: finding model, rule base class, suppressions, driver.

A project-native static-analysis layer (the correctness-tooling
discipline production solver stacks grow — ShyLU's node-level test/check
harnesses are the PAPERS.md precedent): generic linters cannot know that
every rank must reach the same TreeComm / ProcessGrid collective
sequence, that the per-group dispatch loops must not wait on the card,
or that nnz/offset accumulators must survive the int32/int64
index-width selection (the reference's ``int_t`` discipline,
superlu_defs.h:80-93).  The rules in rules_*.py encode those invariants
as AST checks over this package's sources.

Port of the JAX package's ``analysis/core.py``: the engine is
framework-neutral text processing (no torch import either; SLU104 reads
the knob registry lazily), and the path scoping keys on the
``superlu_dist_tpu_torch`` path part.

Design points:

* Rules are :class:`ast.NodeVisitor`-style walkers producing
  :class:`Finding` records (rule id, file:line:col, message, fix hint).
* ``# slulint: disable=SLU101`` on a flagged line suppresses it;
  ``# slulint: disable-file=SLU104`` anywhere in the first 20 lines
  suppresses a rule for a whole file.  Suppressions are meant to carry a
  justification in the same comment.
* A committed JSON baseline (baseline.py) grandfathers known findings so
  the gate only fails on NEW ones.
* Everything is lexical — no imports of the analyzed code, no type
  inference.  False-negative-leaning by design: a quiet rule that only
  fires on the known-deadly shapes earns trust; a noisy one gets
  disabled.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

#: bumped whenever the rule set / engine semantics change — part of the
#: result-cache key (analysis/cache.py), so a stale cache can never
#: serve findings computed by an older rule set
ANALYSIS_VERSION = "torch-2"

#: the package directory whose subpackages ``Rule.package_dirs`` name
PACKAGE = "superlu_dist_tpu_torch"


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def render(self) -> str:
        out = f"{self.location()}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class Rule:
    """Base class for slulint rules.

    Subclasses set ``rule_id``/``title``/``hint`` and implement
    ``check(tree, source, path, project=None) -> list[Finding]``.
    ``project`` is the package-wide call graph + dataflow summaries
    (analysis.callgraph.Project) when the driver built one — rules use
    it for interprocedural reasoning and must degrade to their lexical
    behavior when it is None.  ``package_dirs`` restricts a rule to
    subpackages *within* the superlu_dist_tpu_torch tree (hot-path rules
    like the dispatch-loop host round trip only make sense there); files
    outside the package — scripts, test fixtures — are always in scope.
    """

    rule_id: str = "SLU1xx"
    title: str = ""
    hint: str = ""
    package_dirs: tuple | None = None

    def applies(self, path: str) -> bool:
        parts = _norm_parts(path)
        if self.package_dirs is None or PACKAGE not in parts:
            return True
        inner = parts[parts.index(PACKAGE) + 1:]
        return any(d in inner for d in self.package_dirs)

    def check(self, tree: ast.AST, source: str, path: str,
              project=None) -> list:
        raise NotImplementedError

    def finding(self, path: str, node: ast.AST, message: str,
                hint: str | None = None) -> Finding:
        return Finding(self.rule_id, path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0) + 1, message,
                       self.hint if hint is None else hint)


def _norm_parts(path: str) -> tuple:
    return tuple(os.path.normpath(path).split(os.sep))


# --- shared AST helpers -----------------------------------------------------

def dotted_name(node: ast.AST) -> str:
    """'np.add.at' for Attribute/Name chains, '' for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def is_env_read(node: ast.AST):
    """Match os.environ.get('K') / os.environ['K'] / os.getenv('K') /
    os.environ.setdefault('K', ...) / 'K' in os.environ.  Returns
    (key-or-None, anchor-node) or None.  Writes are not reads (exporting
    to subprocesses is legitimate); non-literal keys return key=None.
    """
    def lit(args):
        if args and isinstance(args[0], ast.Constant) \
                and isinstance(args[0].value, str):
            return args[0].value
        return None

    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn.endswith("os.getenv") or fn == "getenv":
            return lit(node.args), node
        if fn.endswith("environ.get") or fn.endswith("environ.setdefault"):
            return lit(node.args), node
    if isinstance(node, ast.Subscript):
        base = dotted_name(node.value)
        if base.endswith("environ") and isinstance(node.ctx, ast.Load):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return sl.value, node
            return None, node
    if isinstance(node, ast.Compare) and len(node.ops) == 1 \
            and isinstance(node.ops[0], (ast.In, ast.NotIn)):
        if dotted_name(node.comparators[0]).endswith("environ"):
            left = node.left
            if isinstance(left, ast.Constant) and isinstance(left.value, str):
                return left.value, node
            return None, node
    return None


# --- suppressions -----------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*slulint:\s*disable=([A-Za-z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*slulint:\s*disable-file=([A-Za-z0-9_,\s]+)")
_FILE_SUPPRESS_SCAN_LINES = 20


def _parse_ids(blob: str) -> set:
    return {p.strip() for p in blob.split(",") if p.strip()}


def suppressions(source: str):
    """(line -> suppressed rule ids, file-wide suppressed rule ids)."""
    per_line: dict = {}
    file_wide: set = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_FILE_RE.search(text)
        if m and i <= _FILE_SUPPRESS_SCAN_LINES:
            file_wide |= _parse_ids(m.group(1))
            continue
        m = _SUPPRESS_RE.search(text)
        if m:
            per_line.setdefault(i, set()).update(_parse_ids(m.group(1)))
    return per_line, file_wide


# --- driver -----------------------------------------------------------------

PARSE_ERROR_RULE = "SLU100"


def default_rules() -> list:
    from superlu_dist_tpu_torch.analysis.rules_collective import \
        CollectiveRule
    from superlu_dist_tpu_torch.analysis.rules_index import IndexWidthRule
    from superlu_dist_tpu_torch.analysis.rules_env import EnvKnobRule
    from superlu_dist_tpu_torch.analysis.rules_shared import \
        SharedMutableRule
    from superlu_dist_tpu_torch.analysis.rules_lockorder import \
        LockOrderRule
    from superlu_dist_tpu_torch.analysis.rules_lifecycle import \
        ThreadLifecycleRule
    from superlu_dist_tpu_torch.analysis.rules_program import (
        BakedConstRule, CollectiveLockstepRule, HostRoundTripRule,
        InPlaceRule)
    from superlu_dist_tpu_torch.analysis.rules_precision import (
        AccumulationDtypeRule, ImplicitDowncastRule, ToleranceLiteralRule)
    from superlu_dist_tpu_torch.analysis.rules_sharding import (
        CrossDeviceCopyRule, ImplicitReshardRule, PeakMemoryRule)
    from superlu_dist_tpu_torch.analysis.rules_trace import (
        CapturePurityRule, GraphCacheKeyRule, GraphKeyShapeDiversityRule)
    return [CollectiveRule(), CapturePurityRule(), IndexWidthRule(),
            EnvKnobRule(), GraphCacheKeyRule(), GraphKeyShapeDiversityRule(),
            SharedMutableRule(), LockOrderRule(), ThreadLifecycleRule(),
            InPlaceRule(), BakedConstRule(), HostRoundTripRule(),
            CollectiveLockstepRule(), ImplicitDowncastRule(),
            AccumulationDtypeRule(), ToleranceLiteralRule(),
            ImplicitReshardRule(), PeakMemoryRule(), CrossDeviceCopyRule()]


def analyze_source(source: str, path: str, rules, project=None) -> list:
    """Run `rules` over one file.  With ``project=None`` a single-file
    project (call graph + dataflow summaries of just this source) is
    built, so intra-module interprocedural reasoning works even for
    isolated fixtures; the driver passes the package-wide project when
    scanning a tree."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(PARSE_ERROR_RULE, path, exc.lineno or 0, 1,
                        f"file does not parse: {exc.msg}",
                        "slulint gates on parseability so every rule "
                        "actually ran")]
    if project is None:
        from superlu_dist_tpu_torch.analysis.callgraph import build_project
        project = build_project({path: (source, tree)})
    per_line, file_wide = suppressions(source)
    out = []
    for rule in rules:
        if not rule.applies(path):
            continue
        for f in rule.check(tree, source, path, project):
            if f.rule in file_wide or f.rule in per_line.get(f.line, ()):
                continue
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


_SKIP_DIRS = {".git", "__pycache__", ".cache", ".venv", "node_modules",
              "build", "dist"}


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS
                             and not d.endswith(".egg-info"))
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def read_sources(paths) -> dict:
    sources = {}
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            sources[path] = fh.read()
    return sources


def analyze_sources(sources: dict, rules=None) -> list:
    """Whole-tree scan: ONE project (call graph + summaries) spanning
    every file, so cross-module indirection resolves."""
    from superlu_dist_tpu_torch.analysis.callgraph import build_project
    rules = default_rules() if rules is None else rules
    project = build_project(sources)
    out = []
    for path, source in sources.items():
        out.extend(analyze_source(source, path, rules, project))
    return out


def analyze_paths(paths, rules=None) -> list:
    return analyze_sources(read_sources(paths), rules)
