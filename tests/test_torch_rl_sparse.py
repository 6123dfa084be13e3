"""The RL rollout on the sparse layout against JAX's, float64 (the checks
of `tests/test_torch_rl.py:check_rollout`): W from the link list squared
on the tape, K4's propagate both ways on the card, next hops from the edge
list.
"""

from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl import check_rollout


def test_rollout_matches_jax_sparse():
    check_rollout("sparse")
