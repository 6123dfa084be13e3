"""The ruff-approximation rules (E999/F401/F811).

Port of `multihop_offload_tpu/analysis/checks_imports.py`, as it is:
module-scope unused imports honoring `# noqa`,
`__init__.py` re-export hubs, `__all__`, underscore bindings, and
string-literal mentions (doctest-ish uses); F811 for an import rebinding
an earlier import.  E999 (syntax errors) is detected at parse time by the
engine — the rule is registered here so `--select pyflakes` and the docs
have an entry for it; its check body never runs on an unparseable file.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from multihop_offload_tpu_torch.analysis.modinfo import ModuleCtx
from multihop_offload_tpu_torch.analysis.rules import Finding, rule


@rule(
    id="E999", severity="error", scope="everywhere", waiver="",
    doc="file does not parse (syntax/indentation error)",
)
def check_e999(mod: ModuleCtx) -> Iterator[Finding]:
    return iter(())  # parse errors are emitted by the engine before checks


@rule(
    id="F401", severity="error", scope="everywhere", waiver="",
    doc="module-scope import never used (honors # noqa, __all__, _name)",
)
def check_f401(mod: ModuleCtx) -> Iterator[Finding]:
    if os.path.basename(mod.path) == "__init__.py":
        return
    imports = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                bind = a.asname or a.name.split(".")[0]
                if bind != "*":
                    imports[bind] = (node.lineno, a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                bind = a.asname or a.name
                if bind != "*":
                    imports[bind] = (node.lineno,
                                     f"{node.module}.{a.name}")
    used = {n.id for n in ast.walk(mod.tree)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    exported = set()
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            exported = {e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)}
    literal_words = set(" ".join(
        n.value for n in ast.walk(mod.tree)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ).split())
    for name, (lineno, display) in imports.items():
        if name in used or name in exported or name in literal_words:
            continue
        if name.startswith("_"):
            continue
        if "# noqa" in mod.line(lineno):
            continue
        yield Finding(
            rule="F401", path=mod.path, line=lineno,
            message=f"unused import '{display}' as '{name}'",
            snippet=mod.line(lineno).strip(),
        )


@rule(
    id="F811", severity="error", scope="everywhere", waiver="",
    doc="a later module-scope import rebinds an earlier imported name",
)
def check_f811(mod: ModuleCtx) -> Iterator[Finding]:
    seen = {}
    for node in mod.tree.body:
        names = []
        if isinstance(node, ast.Import):
            names = [(a.asname or a.name.split(".")[0], node.lineno)
                     for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names = [(a.asname or a.name, node.lineno) for a in node.names]
        for bind, lineno in names:
            if bind == "*":
                continue
            if bind in seen and "# noqa" not in mod.line(lineno):
                yield Finding(
                    rule="F811", path=mod.path, line=lineno,
                    message=f"import redefines '{bind}'",
                    snippet=mod.line(lineno).strip(),
                )
            seen[bind] = lineno
