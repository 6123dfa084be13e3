"""Per-module symbol model of the analysis engine.

Port of `multihop_offload_tpu/analysis/modinfo.py`.  `ModuleCtx` wraps one
parsed source file with what the checks need: the AST, its lines, and an
import-alias map collected from every `import` / `from ... import` in the
file (module scope and function scope: lazy in-function imports are this
repo's idiom), so that `canonical(node)` resolves `torch.zeros`,
`from torch import zeros`, `import numpy as xp; xp.float32` and simple
local aliases such as `z = torch.zeros` to one dotted name
(`torch.zeros`).

JAX's model also indexes every function for its jit-reachability pass,
and answers "is this node in a loop / a function" for the jit rules; the
port's rules need neither.

Waiver handling: checks report the node's `lineno`; the engine scans the
lines the flagged node spans for the rule's waiver token.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

# the array namespaces a simple value alias (`z = torch.zeros`) may resolve
# into (JAX: numpy and jax)
_ALIAS_ROOTS = ("numpy", "torch")


class ModuleCtx:
    """Parsed module and its import aliases (see module docstring)."""

    def __init__(self, path: str, rel_parts: Tuple[str, ...], source: str,
                 tree: ast.Module):
        self.path = path
        self.rel_parts = rel_parts          # path parts under the pkg root
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.aliases: Dict[str, str] = {}   # local name -> dotted target
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    bind = a.asname or a.name.split(".")[0]
                    # `import torch.nn.functional as F` binds F ->
                    # torch.nn.functional; bare `import torch.nn` binds torch
                    self.aliases[bind] = a.name if a.asname else bind
            elif isinstance(node, ast.ImportFrom):
                if node.module is None or node.level:
                    continue  # relative imports stay package-internal
                for a in node.names:
                    bind = a.asname or a.name
                    if bind != "*":
                        self.aliases[bind] = f"{node.module}.{a.name}"
        # simple value aliases: `z = torch.zeros` (module or function scope)
        # make the constructor rules alias-proof; one extra resolution hop
        # only, chains of aliases are not followed
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, (ast.Attribute, ast.Name))):
                tgt = self._dotted(node.value)
                if tgt:
                    root = tgt.split(".", 1)[0]
                    base = self.aliases.get(root)
                    if base and root not in ("self", "cls"):
                        resolved = tgt.replace(root, base, 1)
                        if resolved.split(".", 1)[0] in _ALIAS_ROOTS:
                            self.aliases.setdefault(node.targets[0].id, resolved)

    def _dotted(self, node: ast.AST) -> Optional[str]:
        """Raw dotted text of a Name/Attribute chain, no alias resolution."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    def canonical(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain through the import-alias map
        (`zeros` after `from torch import zeros` -> `torch.zeros`).
        Unresolvable chains (locals, self.x) return the raw dotted text:
        callers match on known prefixes, so an unresolved local never
        matches."""
        dotted = self._dotted(node)
        if dotted is None:
            return None
        root, _, rest = dotted.partition(".")
        base = self.aliases.get(root)
        if base is None:
            return dotted
        return f"{base}.{rest}" if rest else base

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


def parse_module(path: str, rel_parts: Tuple[str, ...],
                 source: Optional[str] = None):
    """Parse one file: (ModuleCtx, None), or (None, the E999 finding) on a
    syntax error."""
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        from multihop_offload_tpu_torch.analysis.rules import Finding
        return None, Finding(
            rule="E999", path=path, line=e.lineno or 0,
            message=f"syntax error: {e.msg}",
            snippet=(e.text or "").strip(),
        )
    return ModuleCtx(path, rel_parts, source, tree), None
