"""PyTorch port, the training step against the JAX package, in float64 on the
CPU: `forward_backward` in both layouts against `jax.vmap` of the JAX
function (decisions and routes exact, losses within 1e-12, per-episode
gradients within 1e-9 relative to each leaf's largest entry), the
gradient replay and Adam against the optax chain with the JAX-sampled
indices injected (1e-12), and `train_step` end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent import replay as jreplay
from multihop_offload_tpu.agent.train_step import forward_backward as j_forward_backward
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu_torch import _phases
from multihop_offload_tpu_torch.agent import replay as treplay
from multihop_offload_tpu_torch.agent.train_step import forward_backward
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.train.driver import train_init, train_step
from tests.test_torch_layouts import FP_FN, eq, models, paired_batch, synthetic

GRAD_RTOL = 1e-9
BATCHES = {"two": [(16, 4), (26, 5)], "three": [(12, 6), (20, 7), (30, 8)]}


def _leaf(grads_j, name):
    """The JAX gradient leaf of a port parameter name (`layers.i.kernel`)."""
    _, i, leaf = name.split(".")
    return np.asarray(grads_j["params"][f"cheb_{i}"][leaf])


def _grad_close(t, j, name):
    scale = max(np.abs(j).max(), 1e-300)
    err = np.abs(t.numpy() - j).max() / scale
    assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_forward_backward_matches_jax(batch, layout):
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in BATCHES[batch]],
                                       layout, seed=len(batch))
    jmodel, variables, tmodel = models(2, 2, 8, pad, layout)
    key = jax.random.PRNGKey(0)
    jout = jax.jit(jax.vmap(lambda i, j: j_forward_backward(
        jmodel, variables, i, j, key, fp_fn=FP_FN, layout=layout)))(bi, bj)
    tout = forward_backward(tmodel, ti, tj, layout=layout, device="cpu")
    eq(tout.dst, jout.dst)
    eq(tout.routes.seq_slot, jout.routes.seq_slot)
    eq(tout.routes.seq_active, jout.routes.seq_active)
    eq(tout.delays.unit_mask, jout.delays.unit_mask)
    np.testing.assert_allclose(tout.loss_critic.numpy(), np.asarray(jout.loss_critic),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tout.loss_mse.numpy(), np.asarray(jout.loss_mse),
                               rtol=1e-12, atol=0)
    assert set(tout.grads) == {n for n, _ in tmodel.named_parameters()}
    for name, g in tout.grads.items():
        assert g.shape[0] == ti.adj.shape[0]  # one gradient per episode
        _grad_close(g, _leaf(jout.grads, name), name)


def test_per_episode_gradients_are_separate():
    """Episode b's gradient in the batch equals its gradient alone: one
    backward over per-episode parameter copies sums nothing."""
    _, _, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in BATCHES["two"]],
                                     "sparse", seed=9)
    _, _, tmodel = models(2, 2, 8, pad, "sparse")
    full = forward_backward(tmodel, ti, tj, layout="sparse", device="cpu")
    for b in (0, 3):
        one = forward_backward(tmodel, ti.to("cpu").__class__(**{
            f: (getattr(ti, f)[b:b + 1] if isinstance(getattr(ti, f), torch.Tensor)
                else getattr(ti, f)) for f in ti.__dataclass_fields__ if f != "sparse"},
            sparse=_slice_sparse(ti.sparse, b)),
            tj.__class__(**{f: getattr(tj, f)[b:b + 1] for f in tj.__dataclass_fields__}),
            layout="sparse", device="cpu")
        for name, g in full.grads.items():
            torch.testing.assert_close(g[b:b + 1], one.grads[name], rtol=1e-12, atol=1e-15)


def _slice_sparse(sp, b):
    import dataclasses

    def cut(rec):
        return dataclasses.replace(rec, **{
            f.name: getattr(rec, f.name)[b:b + 1] for f in dataclasses.fields(rec)
            if isinstance(getattr(rec, f.name), torch.Tensor)})

    return dataclasses.replace(sp, ext=cut(sp.ext), cf=cut(sp.cf), ext_csr=cut(sp.ext_csr))


def _stored_grads(rng, names_shapes, m):
    grads = {n: 3.0 * rng.normal(size=(m,) + s) for n, s in names_shapes}
    lc = rng.uniform(50, 150, m)
    lm = rng.uniform(0, 1, m)
    first = names_shapes[0][0]
    grads[first][2].flat[0] = np.nan   # a poisoned gradient
    lc[5] = np.inf                      # and a poisoned loss
    return grads, lc, lm


def _jax_tree(flat):
    tree = {}
    for name, v in flat.items():
        _, i, leaf = name.split(".")
        tree.setdefault(f"cheb_{i}", {})[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("decay", [1.0, 0.97])
def test_replay_apply_matches_optax_chain(decay):
    rng = np.random.default_rng(11)
    _, _, tmodel = models(2, 2, 8, type("P", (), {"e": 8})(), "dense")
    params = {n: 2.0 * p.detach() for n, p in tmodel.named_parameters()}  # max-norm binds
    names_shapes = [(n, tuple(p.shape)) for n, p in params.items()]
    m, capacity, batch = 10, 12, 8
    grads, lc, lm = _stored_grads(rng, names_shapes, m)

    jcfg = JConfig(learning_rate=0.05, learning_decay=decay, clipnorm=1.0)
    opt = jreplay.make_optimizer(jcfg)
    jparams = _jax_tree({n: p.numpy() for n, p in params.items()})
    jmem = jreplay.replay_init(jparams, capacity)
    for i in range(m):
        jmem = jreplay.replay_remember(
            jmem, _jax_tree({n: g[i] for n, g in grads.items()}), lc[i], lm[i])
    key = jax.random.PRNGKey(3)
    jp, jstate, jloss, jskip = jreplay.replay_apply(jmem, jparams, opt.init(jparams), opt,
                                                    key, batch, max_norm=1.0)
    # the indices the JAX replay sampled (its Gumbel top-k over the prefix)
    scores = jnp.where(jnp.arange(capacity) < m, jax.random.uniform(key, (capacity,)),
                       -jnp.inf)
    idx = torch.from_numpy(np.asarray(jax.lax.top_k(scores, batch)[1]).astype(np.int64))

    mem = treplay.replay_init(params, capacity)
    treplay.replay_remember(mem, {n: torch.from_numpy(g) for n, g in grads.items()},
                            torch.from_numpy(lc), torch.from_numpy(lm))
    tp, tstate, tloss, tskip = treplay.replay_apply(
        mem, params, treplay.adam_init(params), batch, lr=0.05, decay=decay,
        clipnorm=1.0, max_norm=1.0, idx=idx)
    assert int(tskip) == int(jskip) and int(jskip) in (1, 2)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)  # float32 storage
    for name, p in tp.items():
        _, i, leaf = name.split(".")
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[f"cheb_{i}"][leaf]),
                                   rtol=1e-12, atol=1e-15)
    adam = jstate[1][0]  # chain(clip, adam): adam's ScaleByAdamState
    assert int(tstate.count) == int(adam.count) == batch - int(jskip)
    for name in params:
        _, i, leaf = name.split(".")
        np.testing.assert_allclose(tstate.mu[name].numpy(),
                                   np.asarray(adam.mu[f"cheb_{i}"][leaf]), rtol=1e-12,
                                   atol=1e-18)
        np.testing.assert_allclose(tstate.nu[name].numpy(),
                                   np.asarray(adam.nu[f"cheb_{i}"][leaf]), rtol=1e-12,
                                   atol=1e-18)


def test_replay_remember_ring_and_max_norm_match_jax():
    rng = np.random.default_rng(2)
    shapes = {"layers.0.kernel": (2, 3, 4), "layers.0.bias": (4,)}
    params = {n: torch.from_numpy(rng.normal(size=s)) for n, s in shapes.items()}
    capacity = 5
    mem = treplay.replay_init(params, capacity)
    jmem = jreplay.replay_init(_jax_tree({n: p.numpy() for n, p in params.items()}), capacity)
    for b in (3, 4, 7):  # wraps, then a batch longer than the ring
        g = {n: rng.normal(size=(b,) + s) for n, s in shapes.items()}
        lc, lm = rng.uniform(size=b), rng.uniform(size=b)
        treplay.replay_remember(mem, {n: torch.from_numpy(v) for n, v in g.items()},
                                torch.from_numpy(lc), torch.from_numpy(lm))
        for i in range(b):
            jmem = jreplay.replay_remember(
                jmem, _jax_tree({n: v[i] for n, v in g.items()}), lc[i], lm[i])
        assert (mem.count, mem.ptr) == (int(jmem.count), int(jmem.ptr))
        for n, buf in mem.grads.items():
            _, i, leaf = n.split(".")
            eq(buf, jmem.grads[f"cheb_{i}"][leaf])
        eq(mem.loss_critic, jmem.loss_critic)
    big = {n: 3.0 * p for n, p in params.items()}
    got = treplay.apply_max_norm_constraint(big, 1.0)
    want = jreplay.apply_max_norm_constraint(_jax_tree({n: p.numpy() for n, p in big.items()}),
                                             1.0)
    for n, p in got.items():
        _, i, leaf = n.split(".")
        np.testing.assert_allclose(p.numpy(), np.asarray(want[f"cheb_{i}"][leaf]),
                                   rtol=1e-13)


def test_train_step_replays_once_enough_gradients_stored():
    _, _, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in BATCHES["two"]],
                                     "sparse", seed=4)
    cfg = Config(layout="sparse", batch=6, memory_size=8, cheb_k=2)
    _, _, tmodel = models(2, 2, 8, pad, "sparse")
    state = train_init(tmodel, cfg, device="cpu")
    before = [p.detach().clone() for p in tmodel.parameters()]
    gen = torch.Generator().manual_seed(0)
    rep = train_step(tmodel, state, ti, tj, cfg, gen=gen, device="cpu")
    assert not rep.replayed and state.mem.count == 4
    assert all(torch.equal(a, b) for a, b in zip(before, tmodel.parameters()))
    with _phases.timing() as times:  # the phases the profile script reads
        rep = train_step(tmodel, state, ti, tj, cfg, gen=gen, device="cpu")
    fb = ["actor_forward", "apsp", "offload_decide", "next_hops", "trace_routes",
          "run_empirical", "critic", "suffix_bias_mse", "actor_backward"]
    assert set(times) == {"forward_backward", "replay_remember", "replay_apply"} | {
        f"forward_backward/{p}" for p in fb}
    assert all(ms >= 0 for ms in times.values()) and _phases._times is None
    assert rep.replayed and state.mem.count == 8 and state.mem.ptr == 0
    assert torch.isfinite(rep.replay_loss) and rep.skipped == 0
    assert int(state.opt.count) == cfg.batch
    assert any(not torch.equal(a, b) for a, b in zip(before, tmodel.parameters()))
    assert torch.isfinite(rep.loss_critic).all() and rep.job_total.shape == tj.src.shape
