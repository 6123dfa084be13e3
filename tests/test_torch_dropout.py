"""PyTorch port of the Trainer's dropout against the JAX package, float64 on
the CPU.

JAX's masks are read where flax draws them (`flax.linen.stochastic`'s
`random.bernoulli`, wrapped around one eager, un-vmapped actor pass under
the episode's dropout key) and fed to the port's `forward_backward`
(`dropout_masks`): the losses within 1e-10 and the gradients within 1e-9
of JAX's `forward_backward` under that key, on both layouts.  The port's
Trainer at `dropout=0.1` runs on both layouts, on one device and on a
2-slot data mesh, each run the same as a second run with the same seed,
and its masks come from its own generator (a changed seed changes them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic

from multihop_offload_tpu.agent import actor as jactor
from multihop_offload_tpu.agent.train_step import forward_backward as j_forward_backward
from multihop_offload_tpu.layouts import sparse as jsparse
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu_torch.agent.train_step import forward_backward
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.train import driver as td
from tests.test_torch_drivers import common, read_rows, tiny  # noqa: F401
from tests.test_torch_layouts import eq, paired_batch, synthetic
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_train_step import _leaf

RATE = 0.1


def _jax_masks(jmodel, variables, inst, jobs, key, layout):
    """The keep masks flax draws in one eager actor pass under `key`."""
    drawn = []
    bernoulli = stochastic.random.bernoulli

    def record(*a, **k):
        out = bernoulli(*a, **k)
        drawn.append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stochastic.random, "bernoulli", record)
        support = jactor.default_support(jmodel, inst, layout=layout)
        jactor.actor_delay_matrix(jmodel, variables, inst, jobs, support,
                                  deterministic=False, dropout_rng=key, layout=layout)
    return drawn


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_forward_backward_with_jax_masks_matches_jax(layout):
    bi, bj, ti, tj, pad = paired_batch([synthetic(18, 3)], layout, per_network=1, seed=4)
    prop = jsparse.make_sparse_propagate() if layout == "sparse" else None
    jmodel = JChebNet(num_layer=3, hidden=8, k=2, dropout=RATE, param_dtype=jnp.float64,
                      propagate=prop)
    e = pad.e
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64),
        JChebNet(num_layer=3, hidden=8, k=2, param_dtype=jnp.float64).init(
            jax.random.PRNGKey(5), jnp.zeros((e, 4)), jnp.zeros((e, e))))
    tmodel = tcheb.ChebNet(num_layer=3, hidden=8, k=2, dtype=torch.float64, dropout=RATE,
                           propagate=tcheb.layout_propagate(layout))
    tmodel.load_state_dict(tcheb.params_from_jax(variables))

    inst = jax.tree_util.tree_map(lambda x: x[0], bi)
    jobs = jax.tree_util.tree_map(lambda x: x[0], bj)
    key = jax.random.PRNGKey(0)
    dk = jax.random.fold_in(key, 1)   # the Trainer's dropout stream
    drawn = _jax_masks(jmodel, variables, inst, jobs, dk, layout)
    assert [m.shape for m in drawn] == [(e, 4), (e, 8), (e, 8)]
    assert all(0 < (~m).sum() < m.size for m in drawn)  # some dropped, most kept

    jout = jax.jit(lambda i, j: j_forward_backward(
        jmodel, variables, i, j, key, dropout_rng=dk, layout=layout))(inst, jobs)
    masks = [torch.from_numpy(m.copy())[None] for m in drawn]
    tout = forward_backward(tmodel, ti, tj, layout=layout, device="cpu", dropout_masks=masks)
    eq(tout.dst[0], jout.dst)
    np.testing.assert_allclose(tout.loss_critic.numpy(), [float(jout.loss_critic)],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(tout.loss_mse.numpy(), [float(jout.loss_mse)],
                               rtol=1e-10, atol=0)
    for name, g in tout.grads.items():
        want = _leaf(jout.grads, name)
        err = np.abs(g[0].numpy() - want).max() / max(np.abs(want).max(), 1e-300)
        assert err <= 1e-9, (name, err)
    # the masks matter: without them the gradient is another one
    plain = forward_backward(tmodel, ti, tj, layout=layout, device="cpu")
    assert any(not torch.allclose(plain.grads[n], g) for n, g in tout.grads.items())


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("mesh", [1, 2])
def test_trainer_with_dropout_is_deterministic_per_seed(tiny, tmp_path, layout, mesh):
    drawn = []
    original = tcheb.ChebNet.dropout_masks

    def counted(self, *a, **k):
        drawn.append(1)
        return original(self, *a, **k)

    def run(tag, seed=3):
        kw = {**common(tiny, tmp_path / tag, layout=layout, dropout=RATE, batch=2,
                       mesh_data=mesh), "seed": seed}
        tr = td.Trainer(Config(**kw), device="cpu", devices=[torch.device("cpu")] * mesh)
        rows = read_rows(tr.run(epochs=1, files_limit=1, verbose=False))
        return rows, tr

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcheb.ChebNet, "dropout_masks", counted)
        a, tra = run("a")
        b, trb = run("b")
        c, _ = run("c", seed=4)
    assert len(drawn) == 3 * mesh  # one draw a step, a shard
    assert tra.n_dp == mesh and len(a) == 4 * 4
    assert [r["tau"] for r in a] == [r["tau"] for r in b]
    assert tra.replay_losses == trb.replay_losses and np.isfinite(tra.replay_losses).all()
    for (k, p), q in zip(tra.model.named_parameters(), trb.model.parameters()):
        assert torch.equal(p, q), k
    assert [r["tau"] for r in a] != [r["tau"] for r in c]
