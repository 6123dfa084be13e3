"""Non-finite containment of the RL step, in both packages (the fleet and
weights of `tests/test_torch_rl.py`): a NaN parameter poisons the mean
gradient, the update is skipped and counted, and the parameters and the
Adam moments stay as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl import TINY, _draws, _fleet, _trainers


def test_nonfinite_gradient_skips_the_update():
    """A NaN parameter poisons every lane's gradient: the step is skipped
    and counted, and the parameters and Adam moments stay as they were, in
    both packages."""
    fl = _fleet("dense")
    jtr, ttr = _trainers(fl)
    keys = jax.random.split(jax.random.PRNGKey(9), TINY["rl_fleet"])
    draws, gumbel = _draws(keys, fl["jspec"], TINY["rl_rounds"], TINY["rl_slots"],
                           int(fl["t"][0].servers.shape[1]) + 1)
    ttr.params["layers.1.kernel"][0, 0, 0] = float("nan")
    params = jax.tree_util.tree_map(np.array, jtr.params)
    params["cheb_1"]["kernel"][0, 0, 0] = np.nan
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    before = {k: v.clone() for k, v in ttr.params.items()}
    mu = {k: v.clone() for k, v in ttr.opt_state.mu.items()}
    tout = ttr.train_step(*fl["t"], draws, gumbel=gumbel)
    jout = jtr.train_step(*fl["j"], keys)
    assert tout.skipped == 1 and int(jout.skipped) == 1
    assert ttr.opt_state.count == 0
    for k in before:
        assert torch.equal(ttr.params[k].isnan(), before[k].isnan())
        assert torch.equal(torch.nan_to_num(ttr.params[k]), torch.nan_to_num(before[k]))
        assert torch.equal(ttr.opt_state.mu[k], mu[k])
    rl = ttr.last_rl_metrics
    assert rl["mho_dev_rl_nonfinite_total"] == 1
    assert rl["mho_refit_skipped_updates_total{phase=rl}"] == 1


