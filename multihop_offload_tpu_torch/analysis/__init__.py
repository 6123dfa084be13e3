"""The port's static-analysis engine: `mho-lint`'s counterpart.

Port of `multihop_offload_tpu/analysis/`: the same AST engine (alias- and
multi-line-aware, per-line waivers, a content-hashed baseline) over the
port's package, with the rules whose checks read no JAX name (E999,
F401, F811, JX005, JX006, JX008, JX011, OB001) and those that read the
array namespace, with `torch` in the place of `jax.numpy` (JX003, MP001,
SL001).  The rules about jit, tracing, donation, `device_put`, XLA's
cost analysis and `jax.debug` (JX001, JX002, JX004, JX007, JX009, JX010,
JX012, OB002, OB003) and the jit reachability pass have no counterpart:
the port compiles no program.  Stdlib only; it imports no `jax`.

    python -m multihop_offload_tpu_torch.analysis.cli [--json] [paths...]
"""

from multihop_offload_tpu_torch.analysis.engine import (
    Report,
    run_analysis,
    write_baseline,
)
from multihop_offload_tpu_torch.analysis.rules import (
    Finding,
    Rule,
    all_rules,
    get_rule,
    resolve_select,
)

__all__ = [
    "Report", "run_analysis", "write_baseline",
    "Finding", "Rule", "all_rules", "get_rule", "resolve_select",
]
