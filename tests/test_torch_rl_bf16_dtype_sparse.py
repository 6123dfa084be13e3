"""The RL step under `dtype='bfloat16'` on the sparse layout at K = 2
against the JAX package on the CPU (bf16 parameters; the propagate in
float32 on the float32 fleet, as JAX's identity policy runs it).  The
case, draws and bars of `tests/test_torch_rl_bf16.py` (see there).
"""

import pytest

from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl_bf16 import CHECKS, run_case


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_rl_step_matches_jax_at_a_bf16_base_sparse(check):
    CHECKS[check](run_case("dtype_bfloat16", "sparse"), "dtype_bfloat16")
