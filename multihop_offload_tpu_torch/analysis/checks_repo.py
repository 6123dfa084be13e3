"""The repo's three original lint rules (MP001, SL001, OB001).

Port of `multihop_offload_tpu/analysis/checks_repo.py`, with `torch` in
the place of `jax.numpy` in the array namespace: MP001 reads
`torch.float32` (and its alias `torch.float`) where JAX's reads
`jnp.float32`, SL001 `torch.zeros/ones/full/empty((n, n), ...)` where
JAX's reads `jnp.`; OB001 reads no JAX name and is carried as it is.
Alias- and multi-line-aware:

  * `torch.zeros(\n    (n, n))` split across lines is still SL001, and
    so is `torch.zeros(n, n)` (torch takes the sizes as arguments too);
  * `import torch as t; t.float32` is still MP001 (any import alias
    resolves through `ModuleCtx.canonical`);
  * `z = torch.zeros; z((n, n))` is still SL001 (one resolution hop).

JAX's OB002 (XLA's cost and memory analysis outside the prof layer) and
OB003 (`jax.debug` host callbacks in jit-reachable code) have no
counterpart: the port has neither.

The waiver comments are JAX's (`# fp32-island(`, `# dense-ok(`,
`# print-ok(`), honored on any physical line the flagged call spans.
"""

from __future__ import annotations

import ast
from typing import Iterator

from multihop_offload_tpu_torch.analysis.modinfo import ModuleCtx
from multihop_offload_tpu_torch.analysis.rules import Finding, rule

_ARRAY_NS = ("numpy", "torch")
# hardcoded float32 (JAX: numpy.float32, jax.numpy.float32)
_FLOAT32 = ("numpy.float32", "torch.float32", "torch.float")

# hot-path dirs match the original fallback rules exactly
MP001_DIRS = ("env", "models", "agent", "serve", "sim")
SL001_DIRS = ("env", "models", "serve", "sim")


def _snippet(mod: ModuleCtx, node: ast.AST) -> str:
    return mod.line(node.lineno).strip()


@rule(
    id="MP001", severity="error",
    scope="env/ models/ agent/ serve/ sim/ (precision.py exempt)",
    waiver="# fp32-island(",
    doc=("hardcoded float32 in a hot-path module — dtypes flow from "
         "precision.PrecisionPolicy"),
    dirs=MP001_DIRS, exempt_files=("precision.py",),
)
def check_mp001(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Attribute):
            continue
        canon = mod.canonical(node)
        if canon in _FLOAT32:
            yield Finding(
                rule="MP001", path=mod.path, line=node.lineno,
                message=("hardcoded float32 in hot path — take the dtype "
                         "from precision.PrecisionPolicy, or waive with "
                         "'# fp32-island(<why>)'"),
                snippet=_snippet(mod, node),
            )


def _same_symbol_dims(elts) -> bool:
    """First two tuple elements are the same Name/Attribute chain — the
    (n, n) square-buffer signature the old regex looked for."""
    if len(elts) < 2:
        return False
    a, b = elts[0], elts[1]
    if not isinstance(a, (ast.Name, ast.Attribute)):
        return False
    return ast.dump(a) == ast.dump(b)


@rule(
    id="SL001", severity="error",
    scope="env/ models/ serve/ sim/",
    waiver="# dense-ok(",
    doc=("dense square (N, N)-style materialization in a hot-path module — "
         "instance structure flows through layouts/ edge lists"),
    dirs=SL001_DIRS,
)
def check_sl001(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        canon = mod.canonical(node.func) if isinstance(
            node.func, (ast.Name, ast.Attribute)) else None
        if canon is None:
            continue
        ns, _, fn = canon.rpartition(".")
        if ns not in _ARRAY_NS or fn not in ("zeros", "ones", "full", "empty"):
            continue
        shape = node.args[0]
        if isinstance(shape, (ast.Tuple, ast.List)):
            dims = shape.elts
        elif ns == "torch" and fn != "full":
            dims = node.args  # torch also takes the sizes as arguments
        else:
            continue
        if _same_symbol_dims(dims):
            yield Finding(
                rule="SL001", path=mod.path, line=node.lineno,
                message=("dense square materialization in hot path — route "
                         "through the padded edge lists in layouts/, or "
                         "waive with '# dense-ok(<why>)'"),
                snippet=_snippet(mod, node),
            )


@rule(
    id="OB001", severity="error",
    scope="library code (cli/ and */cli.py exempt — printing is the "
          "console's job)",
    waiver="# print-ok(",
    doc=("bare print() in library code — telemetry goes through the run "
         "log / metric registry (obs/)"),
    exempt_dirs=("cli",), exempt_files=("cli.py",),
)
def check_ob001(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            yield Finding(
                rule="OB001", path=mod.path, line=node.lineno,
                message=("bare print() in library code — emit through the "
                         "run log or metric registry (obs/), or waive with "
                         "'# print-ok(<why>)'"),
                snippet=_snippet(mod, node),
            )
