"""Rule registry of the port's static-analysis engine.

Port of `multihop_offload_tpu/analysis/rules.py`: the same `Finding`,
`Rule` and registry; the `repo` group holds the rules with a counterpart
in the port.

A `Rule` is an id plus everything the engine and the docs need to know
about it: severity, the package scope it applies to, the per-line waiver
token that marks a deliberate, reviewed exception, and a one-line doc
rendered by the CLI's `--list-rules`.

Rules register themselves with the `@rule(...)` decorator; the check
callable receives a `ModuleCtx` (parsed module + import-alias info, see
`modinfo`) and yields `Finding`s.  The ENGINE, not the check, decides
whether a finding is waived (waiver token or `# noqa` on any source line
the flagged node spans) — checks only say *where* and *what*.

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit: a location, the rule id, and the human message."""

    rule: str
    path: str
    line: int
    message: str
    # the stripped source line, used for baseline matching (stable under
    # line-number drift, invalidated when the flagged code itself changes)
    snippet: str = ""
    waived: bool = False
    waiver_reason: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "waived": self.waived,
            **({"waiver_reason": self.waiver_reason}
               if self.waiver_reason else {}),
        }


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered check (see module docstring)."""

    id: str
    severity: str                     # "error" | "warning"
    scope: str                        # human-readable scope description
    waiver: str                       # waiver token, e.g. "# dtype-ok(" ("" = none)
    doc: str                          # one-line summary for --list-rules / docs
    check: Callable[..., Iterable[Finding]]
    # first-level package dirs the rule applies to; None = whole package
    dirs: Optional[Tuple[str, ...]] = None
    # first-level package dirs exempt from the rule (e.g. cli/ for prints)
    exempt_dirs: Tuple[str, ...] = ()
    # exempt file basenames (e.g. precision.py defines the dtype policy)
    exempt_files: Tuple[str, ...] = ()

    def applies_to(self, rel_parts: Tuple[str, ...]) -> bool:
        """Does this rule run on a file at `rel_parts` (path components
        relative to the package root, e.g. ("env", "queueing.py"))?"""
        if not rel_parts:
            return False
        if rel_parts[-1] in self.exempt_files:
            return False
        top = rel_parts[0] if len(rel_parts) > 1 else ""
        if top in self.exempt_dirs:
            return False
        if self.dirs is not None and top not in self.dirs:
            return False
        return True


_REGISTRY: Dict[str, Rule] = {}

# selection groups understood by the CLI's --select
GROUPS = {
    # the repo-specific rules with a counterpart in the port (ROADMAP.md
    # lists the JAX rules without one)
    "repo": ("JX003", "JX005", "JX006", "JX008", "JX011", "MP001", "SL001",
             "OB001"),
    # the ruff-approximation rules (E9/F401/F811) the fallback branch runs
    # over tests/ scripts/ bench.py as well as the package
    "pyflakes": ("E999", "F401", "F811"),
}


def rule(**kwargs) -> Callable:
    """Register the decorated callable as a rule's check."""

    def deco(fn):
        r = Rule(check=fn, **kwargs)
        if r.id in _REGISTRY:
            raise ValueError(f"duplicate rule id {r.id}")
        _REGISTRY[r.id] = r
        return fn

    return deco


def all_rules() -> List[Rule]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    return _REGISTRY[rule_id]


def resolve_select(select: Optional[str]) -> List[Rule]:
    """Expand a --select value ("repo", "pyflakes", "all", or a
    comma-separated id list) into rules.  Unknown ids raise ValueError."""
    if select is None or select == "repo":
        ids: Iterable[str] = GROUPS["repo"]
    elif select == "all":
        ids = sorted(_REGISTRY)
    elif select in GROUPS:
        ids = GROUPS[select]
    else:
        ids = [s.strip() for s in select.split(",") if s.strip()]
    out = []
    for i in ids:
        if i not in _REGISTRY:
            raise ValueError(
                f"unknown rule id '{i}' (known: {', '.join(sorted(_REGISTRY))})"
            )
        out.append(_REGISTRY[i])
    return out
