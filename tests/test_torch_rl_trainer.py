"""`rl.RLTrainer` against the JAX trainer on the CPU, float64 (the fleet,
weights and injected draws of `tests/test_torch_rl.py`): one step's
parameters and Adam moments within 1e-9, the devmetrics against the
host's conservation counts; the fleet sharded over `[cpu] * 2` against one
device; an RL checkpoint hot-reloaded by the port's service.
"""

import jax
import numpy as np
import torch

from multihop_offload_tpu.rl import buffer as jbuf
from multihop_offload_tpu_torch.cli import rl as rl_cli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs.registry import MetricRegistry
from multihop_offload_tpu_torch.parallel.mesh import make_mesh
from multihop_offload_tpu_torch.rl import buffer as tbuf
from multihop_offload_tpu_torch.sim.step import (
    DM_DELIVERED,
    DM_DROP_ARR,
    DM_DROP_CAP,
    DM_DROP_FWD,
    DM_GENERATED,
)
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl import (
    TINY,
    _adam_state,
    _draws,
    _fleet,
    _jax_grads_by_name,
    _np,
    _trainers,
)


def test_train_step_matches_jax():
    """One `RLTrainer` step (dense): new parameters and Adam moments within
    1e-9, the losses, rewards and the pushed reward ring as JAX's; the
    devmetrics equal the host's conservation counts."""
    fl = _fleet("dense")
    jtr, ttr = _trainers(fl)
    keys = jax.random.split(jax.random.PRNGKey(9), TINY["rl_fleet"])
    draws, gumbel = _draws(keys, fl["jspec"], TINY["rl_rounds"], TINY["rl_slots"],
                           int(fl["t"][0].servers.shape[1]) + 1)
    jout = jtr.train_step(*fl["j"], keys)
    tout = ttr.train_step(*fl["t"], draws, gumbel=gumbel)
    assert tout.skipped == 0 and int(jout.skipped) == 0
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(_np(tout.rewards), np.asarray(jout.rewards))
    np.testing.assert_allclose(_np(tout.grad_norms), np.asarray(jout.grad_norms), rtol=1e-6)
    want = _jax_grads_by_name(jtr.params)
    adam = _adam_state(jtr.opt_state)
    mu, nu = _jax_grads_by_name(adam.mu), _jax_grads_by_name(adam.nu)
    assert ttr.opt_state.count == int(adam.count) == 1
    for k, p in ttr.params.items():
        for got, ref in ((p, want[k]), (ttr.opt_state.mu[k], mu[k]), (ttr.opt_state.nu[k], nu[k])):
            np.testing.assert_allclose(_np(got), ref, rtol=0,
                                       atol=1e-9 * max(np.abs(ref).max(), 1e-30), err_msg=k)
    np.testing.assert_array_equal(_np(ttr.buf.rewards), np.asarray(jtr.buf.rewards))
    np.testing.assert_allclose(_np(tbuf.buffer_baseline(ttr.buf)),
                               np.asarray(jbuf.buffer_baseline(jtr.buf)), rtol=4 * 2.0 ** -23)
    st = tout.state
    host = [int(st.generated.sum()), int(st.delivered.sum()), int(st.dropped.sum())]
    tot = ttr.sim_totals
    assert [int(tot[DM_GENERATED]), int(tot[DM_DELIVERED]),
            int(tot[DM_DROP_FWD] + tot[DM_DROP_ARR] + tot[DM_DROP_CAP])] == host
    flushed = ttr.dm_sim.flush(tout.dev_sim, reg=MetricRegistry())
    assert flushed[DM_GENERATED] == tot[DM_GENERATED] and host[0] > 0
    assert ttr.sim_totals[DM_GENERATED] == jtr.sim_totals[DM_GENERATED]
    assert ttr.sim_totals[DM_DELIVERED] == jtr.sim_totals[DM_DELIVERED]
    rl = ttr.last_rl_metrics
    assert rl["mho_dev_rl_episodes_total"] == TINY["rl_fleet"]
    assert rl["mho_refit_skipped_updates_total{phase=rl}"] == 0


def test_fleet_sharded_over_two_devices_matches_one():
    """`rl_mesh = 2` on `[cpu] * 2`: the mean of the shard means gives the
    one-device step's parameters within 1e-12, and the same rollouts."""
    fl = _fleet("dense")
    _, one = _trainers(fl)
    _, two = _trainers(fl, mesh=make_mesh(2, 1, [torch.device("cpu")] * 2))
    seeds = [11, 12]
    a = one.train_step(*fl["t"], seeds)
    b = two.train_step(*fl["t"], seeds)
    assert torch.equal(a.rewards, b.rewards) and torch.equal(a.dsts, b.dsts)
    for k in one.params:
        np.testing.assert_allclose(_np(two.params[k]), _np(one.params[k]), rtol=0,
                                   atol=1e-12 * max(1.0, float(one.params[k].abs().max())))
    assert one.sim_totals == two.sim_totals


def test_rl_checkpoint_hot_reloads_into_the_service(tmp_path):
    """`RLTrainer.save` writes `source="rl"` lineage with the Adam state, and
    the port's service hot-reloads the RL candidate: the weights it serves
    are the trainer's (float32, as the service serves)."""
    import dataclasses

    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.rl.trainer import RLTrainer
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    cfg = dataclasses.replace(Config(), **{k: v for k, v in TINY.items() if k != "dtype"})
    insts, jobss, paramss, spec, _ = rl_cli.build_fleet(cfg, "cpu")
    tr = RLTrainer(cfg, rl_cli.make_rl_model(cfg, insts, jobss), spec)
    tr.train_step(insts, jobss, paramss, [3, 4])
    model_dir = str(tmp_path / "model")
    directory = f"{model_dir}/{rl_cli.RL_SUBDIR}"
    step = tr.save(directory)
    lin = ckpt_lib.load_lineage(directory, step)
    assert lin["source"] == "rl" and lin["rl_step"] == step == 1
    restored = ckpt_lib.restore_checkpoint_raw(directory, step)
    assert set(restored) == {"params", "opt_state"} and restored["opt_state"]["count"] == 1
    svc, _ = build_service(Config(serve_sizes="10,12", serve_slots=2), device="cpu",
                           load_checkpoint=False)
    assert svc.hot_reload(model_dir, which=rl_cli.RL_SUBDIR) == step
    assert svc.executor.loaded_lineage["source"] == "rl"
    served = dict(svc.executor.model.named_parameters())
    assert set(served) == set(tr.params)
    for k, v in tr.params.items():
        assert torch.equal(served[k].detach(), v)
