"""The RL step under `precision='bf16'` on the sparse layout at K = 2 against
the JAX package on the CPU: the ChebConv's propagate and its transposed
walk in bf16 (K4 bf16 forward and transposed on the card).  The case,
draws and bars of `tests/test_torch_rl_bf16.py` (see there).
"""

import pytest

from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl_bf16 import CHECKS, run_case


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_rl_step_matches_jax_under_mixed_policy_sparse(check):
    CHECKS[check](run_case("precision_bf16", "sparse"), "precision_bf16")
