"""The RL step under `dtype='bfloat16'` against the JAX package on the CPU:
the identity policy at a bf16 base, bf16 parameters, gradients and Adam
moments against the float32 fleet's features (promoted to float32 in the
ChebConv's feature products, as `jnp.matmul` does), the simulator and the
APSP float32; dense, K = 1.  The case, draws and bars of
`tests/test_torch_rl_bf16.py` (see there).
"""

import pytest

from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl_bf16 import CHECKS, run_case


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_rl_step_matches_jax_at_a_bf16_base_dense(check):
    CHECKS[check](run_case("dtype_bfloat16", "dense"), "dtype_bfloat16")
