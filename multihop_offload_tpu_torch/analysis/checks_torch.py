"""The rules of `multihop_offload_tpu/analysis/checks_jax.py` that carry over.

JX003 dtype pinning     torch/np arange|zeros|ones without an explicit
                        dtype in hot-path dirs (the sim/ i32-pin bug;
                        `torch` in the place of `jax.numpy`: a torch
                        default dtype is a process-wide setting,
                        `torch.set_default_dtype`)
JX005 nondeterminism    wall-clock / global-RNG calls in library code —
                        clocks are injected (the health layer's
                        convention), RNG is seeded
JX006 swallowed errors  bare `except:` / `except Exception: pass` in the
                        recovery-critical dirs
JX008 saturation div    unguarded `x / (1 - ...)` in the queueing-math
                        dirs — the M/M/1 utilization denominator blows
                        up to inf/NaN exactly at the saturated inputs
                        the admission guards exist to keep out
JX011 topology drawing  raw `networkx` graph constructors outside
                        graphs/ (the port imports no networkx: the rule
                        keeps it so)

Each keeps JAX's id, scope and waiver token; the messages name torch's
spellings.  JAX's JX001
(trace safety), JX002 (retrace hazards), JX004 (host syncs in hot loops,
beside jit-reachable code), JX007 (unplaced `device_put`), JX009 (host
syncs in a rollout scan), JX010 (`jax.distributed` outside multihost/)
and JX012 (use after donation) read jit, tracing, donation or
`device_put`, and have no counterpart.
"""

from __future__ import annotations

import ast
from typing import Iterator

from multihop_offload_tpu_torch.analysis.modinfo import ModuleCtx
from multihop_offload_tpu_torch.analysis.rules import Finding, rule

_ARRAY_NS = ("numpy", "torch")

JX003_DIRS = ("env", "models", "agent", "serve", "sim", "layouts",
              "train", "loop")


def _snippet(mod: ModuleCtx, node: ast.AST) -> str:
    return mod.line(node.lineno).strip()


# ---------------------------------------------------------------------------
# JX003 — unpinned dtypes in hot paths
# ---------------------------------------------------------------------------


@rule(
    id="JX003", severity="error",
    scope="env/ models/ agent/ serve/ sim/ layouts/ train/ loop/",
    waiver="# dtype-ok(",
    doc=("torch/np arange|zeros|ones without an explicit dtype in a hot-path "
         "dir — default dtypes caused the sim/ i32-pin bug"),
    dirs=JX003_DIRS,
)
def check_jx003(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canonical(node.func) if isinstance(
            node.func, (ast.Name, ast.Attribute)) else None
        if canon is None:
            continue
        ns, _, fn = canon.rpartition(".")
        if ns not in _ARRAY_NS or fn not in ("arange", "zeros", "ones"):
            continue
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        # positional dtype: numpy's zeros/ones(shape, dtype) and
        # arange(a, b, step, dtype); torch takes `dtype=` only (its
        # positional arguments are sizes, or arange's start, end, step)
        if ns == "numpy" and fn in ("zeros", "ones") and len(node.args) >= 2:
            continue
        if ns == "numpy" and fn == "arange" and len(node.args) >= 4:
            continue
        yield Finding(
            rule="JX003", path=mod.path, line=node.lineno,
            message=(f"{fn}() without an explicit dtype in a hot-path dir — "
                     "pin it (i32 for indices, policy dtype for data), or "
                     "waive with '# dtype-ok(<why>)'"),
            snippet=_snippet(mod, node),
        )


# ---------------------------------------------------------------------------
# JX005 — nondeterminism outside injected clocks / seeded RNG
# ---------------------------------------------------------------------------

_WALL_CLOCKS = {"time.time", "time.monotonic", "time.perf_counter",
                "time.process_time"}


@rule(
    id="JX005", severity="error",
    scope="library code (cli/ exempt — the console owns wall time)",
    waiver="# nondet-ok(",
    doc=("wall-clock / global-RNG call in library code — inject clocks "
         "(clock=time.monotonic param) and seed RNG; unseeded time/random "
         "breaks replay and resume"),
    exempt_dirs=("cli",),
)
def check_jx005(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canonical(node.func) if isinstance(
            node.func, (ast.Name, ast.Attribute)) else None
        if canon is None:
            continue
        root = canon.split(".")[0]
        msg = None
        if canon in _WALL_CLOCKS and "time" in mod.aliases:
            msg = (f"{canon}() call — inject the clock instead "
                   "(`clock: Callable[[], float]` parameter, the health "
                   "layer's convention)")
        elif root == "random" and "random" in mod.aliases:
            msg = (f"{canon}() — stdlib global RNG is unseeded "
                   "nondeterminism; use np.random.default_rng(seed) or "
                   "a seeded torch.Generator")
        elif canon.startswith("numpy.random."):
            fn = canon.rsplit(".", 1)[-1]
            if fn == "default_rng":
                if node.args or node.keywords:
                    continue  # seeded — the sanctioned pattern
                msg = ("np.random.default_rng() without a seed — "
                       "nondeterministic; thread a seed in")
            elif fn[:1].isupper() or fn == "Generator":
                continue  # type reference, not a draw
            else:
                msg = (f"np.random.{fn}() — legacy global-state RNG; use "
                       "np.random.default_rng(seed)")
        if msg:
            yield Finding(
                rule="JX005", path=mod.path, line=node.lineno,
                message=msg + ", or waive with '# nondet-ok(<why>)'",
                snippet=_snippet(mod, node),
            )


# ---------------------------------------------------------------------------
# JX008 — unguarded saturation denominators in the queueing-math dirs
# ---------------------------------------------------------------------------

JX008_DIRS = ("env", "sim", "loop")


def _has_one_minus(node: ast.AST) -> bool:
    """Does the expression contain a top-level `1 - x` / `1.0 - x`?  Does
    NOT descend into calls: a denominator wrapped in a guard
    (`torch.clamp_min(1 - rho, eps)`, `torch.where(...)`) is the sanctioned fix
    and must not fire."""
    if isinstance(node, ast.Call):
        return False
    if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
            and isinstance(node.left, ast.Constant)
            and node.left.value in (1, 1.0)):
        return True
    return any(_has_one_minus(c) for c in ast.iter_child_nodes(node))


@rule(
    id="JX008", severity="error",
    scope="env/ sim/ loop/",
    waiver="# div-ok(",
    doc=("unguarded `x / (1 - ...)` division in a queueing-math dir — the "
         "M/M/1 utilization denominator is 0 at rho=1 and negative past "
         "it; clamp (torch.clamp_min(1 - rho, eps)), select (torch.where), or "
         "prove the bound and waive"),
    dirs=JX008_DIRS,
)
def check_jx008(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)):
            continue
        if not _has_one_minus(node.right):
            continue
        yield Finding(
            rule="JX008", path=mod.path, line=node.lineno,
            message=("division by an unguarded `1 - ...` saturation "
                     "denominator — inf/NaN at utilization 1; clamp it "
                     "(torch.clamp_min(1 - rho, eps)) or select around it "
                     "(torch.where), or waive a proven-bounded site with "
                     "'# div-ok(<why>)'"),
            snippet=_snippet(mod, node),
        )


# ---------------------------------------------------------------------------
# JX006 — swallowed exceptions in the recovery-critical dirs
# ---------------------------------------------------------------------------

JX006_DIRS = ("serve", "loop", "train", "obs")


def _pass_only(body) -> bool:
    return all(isinstance(st, ast.Pass) for st in body)


@rule(
    id="JX006", severity="error",
    scope="serve/ loop/ train/ obs/",
    waiver="# swallow-ok(",
    doc=("bare `except:` or `except Exception: pass` in a recovery-critical "
         "dir — a swallowed error here hides the exact corruption the chaos "
         "drills exist to surface; handle it, narrow it, or justify it"),
    dirs=JX006_DIRS,
)
def check_jx006(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            yield Finding(
                rule="JX006", path=mod.path, line=node.lineno,
                message=("bare `except:` swallows SystemExit/KeyboardInterrupt "
                         "and every error signal — catch a concrete type, or "
                         "waive with '# swallow-ok(<why>)'"),
                snippet=_snippet(mod, node),
            )
            continue
        if not _pass_only(node.body):
            continue
        names = []
        types = (node.type.elts if isinstance(node.type, ast.Tuple)
                 else [node.type])
        for t in types:
            if isinstance(t, ast.Name):
                names.append(t.id)
        if any(n in ("Exception", "BaseException") for n in names):
            yield Finding(
                rule="JX006", path=mod.path, line=node.lineno,
                message=("`except Exception: pass` silently swallows errors "
                         "in a recovery-critical dir — handle or log the "
                         "failure, or waive with '# swallow-ok(<why>)'"),
                snippet=_snippet(mod, node),
            )


# ---------------------------------------------------------------------------
# JX011 — raw networkx topology draws outside graphs/
# ---------------------------------------------------------------------------

# the classic constructor surface: nx.<family>_graph(...) plus the bare
# container classes people reach for when hand-building a topology
_JX011_CLASSES = {"networkx.Graph", "networkx.DiGraph", "networkx.MultiGraph"}


@rule(
    id="JX011", severity="error",
    scope="package (graphs/ exempt — it owns topology drawing)",
    waiver="# topo-ok(",
    doc=("raw networkx graph constructor outside graphs/ — topology draws "
         "go through graphs.generators.generate so every caller gets the "
         "bounded connectivity retry, per-seed determinism and the "
         "(adj, pos) contract; an ad-hoc nx draw silently reintroduces the "
         "disconnected-graph hazard the generators close"),
    exempt_dirs=("graphs",),
)
def check_jx011(mod: ModuleCtx) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canonical(node.func) if isinstance(
            node.func, (ast.Name, ast.Attribute)) else None
        if canon is None or not canon.startswith("networkx."):
            continue
        if not (canon.endswith("_graph") or canon in _JX011_CLASSES):
            continue
        yield Finding(
            rule="JX011", path=mod.path, line=node.lineno,
            message=(f"{canon}() outside graphs/ — draw topologies through "
                     "graphs.generators.generate (connectivity retry, "
                     "seeded determinism, (adj, pos) contract), or waive "
                     "with '# topo-ok(<why>)'"),
            snippet=_snippet(mod, node),
        )
