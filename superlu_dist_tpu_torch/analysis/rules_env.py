"""SLU104 — env-knob registry discipline.

Every environment variable the project reads must be declared in the
central knob registry (``utils/options.py:KNOB_REGISTRY``) — the single
source of truth that feeds the generated docs table, the
``SLU_TPU_STRICT_ENV=1`` typo guard, and this rule.  An undeclared read
is either a typo (silently-ignored knob — the classic wasted hardware
sweep) or a new knob that skipped registration (scattered parse points,
no docs row).

Flagged: ``os.environ.get('K')`` / ``os.environ['K']`` / ``os.getenv``
/ ``setdefault`` / ``'K' in os.environ`` with a literal key not in the
registry.  Writes (``os.environ['K'] = ...``) are exempt — exporting to
subprocesses is not a knob read.  Non-literal keys are exempt lexically;
the registry helpers cover them at runtime (env_int & co. raise
UnknownKnobError for unregistered names).

Port of the JAX package's ``analysis/rules_env.py``, held against this
package's registry (``superlu_dist_tpu_torch.utils.options``), which is
read on the first check, not at import.
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Rule, is_env_read


def _registry_keys() -> frozenset:
    from superlu_dist_tpu_torch.utils.options import KNOB_REGISTRY
    return frozenset(KNOB_REGISTRY)


class EnvKnobRule(Rule):
    rule_id = "SLU104"
    title = "env-knob-registry"
    hint = ("declare the knob in utils/options.py (register_knob) and "
            "read it via env_int/env_float/env_str/env_flag — that one "
            "registration feeds the docs table, SLU_TPU_STRICT_ENV typo "
            "detection, and this rule")

    def __init__(self, extra_keys=()):
        self._extra = frozenset(extra_keys)
        self._keys = None

    @property
    def keys(self) -> frozenset:
        if self._keys is None:
            self._keys = _registry_keys() | self._extra
        return self._keys

    def check(self, tree, source, path, project=None):
        findings = []
        for node in ast.walk(tree):
            env = is_env_read(node)
            if env is None:
                continue
            key, anchor = env
            if key is None or key in self.keys:
                continue
            findings.append(self.finding(
                path, anchor,
                f"env read of {key!r} which is not declared in the knob "
                "registry (utils/options.py)"))
        return findings
