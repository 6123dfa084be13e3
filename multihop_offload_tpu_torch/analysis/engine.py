"""The analysis engine: walk files, run rules, classify waivers, baseline.

Port of `multihop_offload_tpu/analysis/engine.py`, over the port's package
(`PACKAGE_DIR`), without JAX's jit-reachability index (no rule of the port
reads it).

One `run_analysis(...)` call produces a `Report`:

  * `findings`  — live violations (these fail the gate),
  * `waived`    — sites carrying the rule's waiver token (or `# noqa`)
                  on a line the flagged node spans: deliberate, reviewed
                  exceptions, counted per rule so waiver creep is visible
                  in the `--report` file,
  * `suppressed`— findings matched by a `--baseline` file entry.

Scope resolution: a file's rule scope is decided by its path relative to
the PACKAGE ROOT — the path component named `multihop_offload_tpu_torch`
when present, else the scanned root itself.  That second case lets
fixture trees (a scanned `env/...` directory) exercise dir-scoped rules
without nesting a fake package.

Baseline format (JSON): a list of {path, rule, snippet_sha1} entries
with an occurrence count.  Matching is by content hash of the stripped
flagged line, so findings survive unrelated line-number drift but
re-surface the moment the flagged code itself changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from multihop_offload_tpu_torch.analysis import checks_imports  # noqa: F401  (registers rules)
from multihop_offload_tpu_torch.analysis import checks_repo     # noqa: F401
from multihop_offload_tpu_torch.analysis import checks_torch    # noqa: F401
from multihop_offload_tpu_torch.analysis.modinfo import ModuleCtx, parse_module
from multihop_offload_tpu_torch.analysis.rules import Finding, Rule, resolve_select

PACKAGE_DIR = "multihop_offload_tpu_torch"
_SKIP_DIRS = ("__pycache__", ".git", ".ruff_cache", ".pytest_cache")


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    waived: List[Finding]
    suppressed: List[Finding]
    files_scanned: int
    rules_run: List[str]

    def counts(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for rid in self.rules_run:
            out[rid] = {"findings": 0, "waived": 0, "suppressed": 0}
        for f in self.findings:
            out.setdefault(f.rule, {"findings": 0, "waived": 0,
                                    "suppressed": 0})["findings"] += 1
        for f in self.waived:
            out.setdefault(f.rule, {"findings": 0, "waived": 0,
                                    "suppressed": 0})["waived"] += 1
        for f in self.suppressed:
            out.setdefault(f.rule, {"findings": 0, "waived": 0,
                                    "suppressed": 0})["suppressed"] += 1
        return out

    def to_json(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "rules": self.counts(),
            "findings": [f.to_json() for f in self.findings],
            "waived": [f.to_json() for f in self.waived],
            "suppressed": [f.to_json() for f in self.suppressed],
        }


def iter_py_files(roots: Sequence[str]):
    for root in roots:
        if os.path.isfile(root):
            if root.endswith(".py"):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _rel_parts(path: str, root: str) -> Tuple[str, ...]:
    """Path components relative to the package root (see module doc)."""
    parts = os.path.normpath(path).split(os.sep)
    if PACKAGE_DIR in parts:
        i = len(parts) - 1 - parts[::-1].index(PACKAGE_DIR)
        return tuple(parts[i + 1:])
    rel = os.path.relpath(path, root if os.path.isdir(root)
                          else os.path.dirname(root) or ".")
    return tuple(os.path.normpath(rel).split(os.sep))


def _waiver_on_span(mod: ModuleCtx, finding: Finding, rule: Rule) -> Tuple[bool, str]:
    """Is the rule's waiver token (or # noqa) present on any line the
    flagged node spans?  Returns (waived, reason-text)."""
    # scan from the flagged line to where its bracket nesting closes (a
    # multi-line call may carry the waiver on any of its physical lines)
    depth = 0
    for ln in range(finding.line, min(finding.line + 12,
                                      len(mod.lines) + 1)):
        text = mod.line(ln)
        if rule.waiver and rule.waiver in text:
            reason = text.split(rule.waiver, 1)[1]
            return True, reason.split(")", 1)[0]
        if "# noqa" in text and ln == finding.line:
            return True, "noqa"
        code = text.split("#", 1)[0]
        depth += (code.count("(") + code.count("[")
                  - code.count(")") - code.count("]"))
        if depth <= 0:
            break
    return False, ""


def _snippet_hash(f: Finding) -> str:
    return hashlib.sha1(f.snippet.encode("utf-8")).hexdigest()[:16]


def load_baseline(path: str) -> Dict[Tuple[str, str, str], int]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[Tuple[str, str, str], int] = {}
    for e in data.get("suppressions", []):
        key = (e["path"], e["rule"], e["snippet_sha1"])
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    agg: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        key = (f.path, f.rule, _snippet_hash(f))
        agg[key] = agg.get(key, 0) + 1
    entries = [
        {"path": p, "rule": r, "snippet_sha1": h, "count": c}
        for (p, r, h), c in sorted(agg.items())
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"format": "mho-lint-baseline-v1",
                   "suppressions": entries}, fh, indent=2)
        fh.write("\n")


def run_analysis(
    roots: Sequence[str],
    select: Optional[str] = None,
    baseline: Optional[str] = None,
) -> Report:
    rules = resolve_select(select)
    mods: List[ModuleCtx] = []
    parse_findings: List[Finding] = []
    n_files = 0
    for root in roots:
        for path in iter_py_files([root]):
            n_files += 1
            mod, err = parse_module(path, _rel_parts(path, root))
            if err is not None:
                parse_findings.append(err)
            if mod is not None:
                mods.append(mod)
    findings: List[Finding] = list(parse_findings)
    waived: List[Finding] = []
    for mod in mods:
        for r in rules:
            if not r.applies_to(mod.rel_parts):
                continue
            for f in r.check(mod):
                is_waived, reason = _waiver_on_span(mod, f, r)
                if is_waived:
                    waived.append(dataclasses.replace(
                        f, waived=True, waiver_reason=reason))
                else:
                    findings.append(f)

    suppressed: List[Finding] = []
    if baseline and os.path.exists(baseline):
        budget = load_baseline(baseline)
        live: List[Finding] = []
        for f in findings:
            key = (f.path, f.rule, _snippet_hash(f))
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                suppressed.append(f)
            else:
                live.append(f)
        findings = live

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    waived.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings=findings, waived=waived, suppressed=suppressed,
                  files_scanned=n_files, rules_run=[r.id for r in rules])
