"""PyTorch port of `rl/` and `cli/rl.py`, against the JAX package on the
CPU, float64.

The same scenario fleet (BA(8) networks of `cli.rl.build_fleet`, JAX's
rates) goes through both packages with the same weights, and the port's
draws are the JAX run's own, rebuilt from its key tree and injected: the
slot uniforms as `tests/test_torch_sim.py` derives them (`InjectedDraws`),
and the decision noise as `jax.random.categorical` draws it (the Gumbel
noise of `split(k_dec)[0]`).  Rewards, deltas, destinations and routes
must be bit-identical, log-probabilities, entropies and losses within
1e-10, parameter gradients within 1e-9 of their largest entry, a train
step's parameters and Adam moments within 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.layouts import (
    cf_nnz_count as j_cf_nnz,
    ext_nnz_count as j_ext_nnz,
    make_sparse_propagate,
    zeros_support,
)
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.rl import RLTrainer as JRLTrainer
from multihop_offload_tpu.rl import buffer as jbuf
from multihop_offload_tpu.rl.rollout import rollout as j_rollout
from multihop_offload_tpu.sim import fidelity as jfid
from multihop_offload_tpu.sim import state as jstate
from multihop_offload_tpu_torch.cli import rl as rl_cli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs import generators as tgen
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.rl import buffer as tbuf
from multihop_offload_tpu_torch.rl.rollout import rollout as t_rollout
from multihop_offload_tpu_torch.rl.trainer import RLTrainer
from multihop_offload_tpu_torch.sim import fidelity as tfid
from multihop_offload_tpu_torch.sim import state as tstate
from multihop_offload_tpu_torch.sim.runner import InjectedDraws
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

F64 = torch.float64
# a temperature at the scale of the cost table (local ~16, a server ~1,600
# on these fleets), so that servers are sampled and the gradient of the
# log-probabilities flows through the APSP
TINY = dict(sim_nodes=8, sim_jobs=3, sim_cap=64, rl_fleet=2, rl_rounds=2, rl_slots=40,
            rl_steps=3, rl_temp=1000.0, dtype="float64")
BASELINE = 0.4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fleet(layout, dtype="float64", fleet=TINY["rl_fleet"]):
    """The JAX `cli.rl.build_fleet` of `TINY` in `dtype` (its body, at the
    port's data-sized sparse pads), and the port's instances of the same
    cases carrying the JAX run's scaled rates and sim parameters."""
    n_nodes, num_jobs = TINY["sim_nodes"], TINY["sim_jobs"]
    sparse = layout == "sparse"
    jtopos = [jtopo.build_topology(jgen.barabasi_albert(n_nodes, seed=100 * i)[0])
              for i in range(fleet)]
    ttopos = [ttopo.build_topology(tgen.barabasi_albert(n_nodes, seed=100 * i)[0])
              for i in range(fleet)]
    dims = dict(n=8, l=-(-max(t.num_links for t in jtopos) // 8) * 8, s=8, j=8)
    if sparse:
        dims.update(enn=jinst.PadSpec.round_up(max(j_ext_nnz(t, np.ones(t.n, bool))
                                                   for t in jtopos), 128),
                    cnn=jinst.PadSpec.round_up(max(j_cf_nnz(t) for t in jtopos), 128))
    jpad, tpad = jinst.PadSpec(**dims), tinst.PadSpec(**dims)
    lay = layout if sparse else None
    keys = jax.random.split(jax.random.PRNGKey(0), fleet)
    bp = jax.jit(lambda i, j, k: j_baseline(i, j, k, layout=lay))
    jcases, tcases, jparams, tparams = [], [], [], []
    for i in range(fleet):
        ji, jj = jfid.make_case(100 * i, jtopos[i], jpad, num_jobs, dtype=np.dtype(dtype),
                                layout=lay)
        jj, _ = jfid.scale_to_util(ji, jj, keys[i], 0.7, policy_fn=bp)
        ti, tj = tfid.make_case(100 * i, ttopos[i], tpad, num_jobs,
                                dtype=getattr(torch, dtype), layout=lay, device="cpu")
        tj = dataclasses.replace(tj, rate=torch.from_numpy(np.array(jj.rate)))
        jcases.append((ji, jj))
        tcases.append((ti, tj))
        jparams.append(jstate.build_sim_params(ji, jj, margin=5.0))
        tparams.append(tstate.build_sim_params(ti, tj, margin=5.0))
    jspec = jstate.spec_for(jcases[0][0], jcases[0][1], cap=TINY["sim_cap"])
    return {
        "j": (jinst.stack_instances([c[0] for c in jcases]),
              jinst.stack_instances([c[1] for c in jcases]),
              jinst.stack_instances(jparams)),
        "t": (tinst.stack_instances([c[0] for c in tcases]),
              tinst.stack_instances([c[1] for c in tcases]),
              tinst.stack_instances(tparams)),
        "jspec": jspec, "tspec": tstate.SimSpec(*dataclasses.astuple(jspec)),
        "pad": jpad, "layout": layout,
    }


def _models(fl, k=1):
    """The JAX ChebNet in float64 with a fresh init at key 0, its output
    sign flipped where that draw is dead at birth on the fleet (JAX's
    `ensure_alive_output_multi`, one probe a lane: a dead relu output has
    zero gradients), and the port's model carrying the same weights."""
    from multihop_offload_tpu.agent.actor import build_ext_features, default_support
    from multihop_offload_tpu.layouts import resolve_layout
    from multihop_offload_tpu.models.chebconv import ensure_alive_output_multi

    sparse = fl["layout"] == "sparse"
    jmodel = JChebNet(num_layer=5, hidden=32, k=k, param_dtype=jnp.float64,
                      propagate=make_sparse_propagate(None) if sparse else None)
    pad = fl["pad"]
    lay = resolve_layout(fl["layout"])
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((pad.e, 4), jnp.float64),
                            zeros_support(pad, jnp.float64, lay))
    jinsts, jjobs, _ = fl["j"]
    probes = []
    for i in range(TINY["rl_fleet"]):
        inst = jax.tree_util.tree_map(lambda x: x[i], jinsts)
        jobs = jax.tree_util.tree_map(lambda x: x[i], jjobs)
        probes.append((build_ext_features(inst, jobs), default_support(jmodel, inst, lay),
                       inst.ext_mask))
    variables = ensure_alive_output_multi(jmodel, variables, probes)
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), variables)
    tmodel = tcheb.make_model(Config(cheb_k=k), dtype=F64, layout=fl["layout"])
    tmodel.load_state_dict(tcheb.params_from_jax(variables))
    return jmodel, variables, tmodel


def _draws(keys, spec, rounds, slots, options, dtype=jnp.float64):
    """The JAX rollout's draws for lane keys (B, 2) in `dtype`: slot
    uniforms (`InjectedDraws`, (B, R, K, width)) and the decision Gumbel
    noise (B, R, J, S+1)."""
    def lane(key):
        def rnd(kr):
            k_dec, k_slots = jax.random.split(kr)
            k_act, _ = jax.random.split(k_dec)
            return (jax.random.split(k_slots, slots),
                    jax.random.gumbel(k_act, (spec.num_jobs, options), dtype))
        return jax.vmap(rnd)(jax.random.split(key, rounds))

    slot_keys, gumbel = jax.jit(jax.vmap(lane))(keys)

    def one(kk):
        a, b, c, d = jax.random.split(kk, 4)
        return (jax.random.uniform(a, (spec.num_links,), dtype),
                jax.random.uniform(b, (spec.num_links,), dtype),
                jax.random.uniform(c, (spec.num_nodes,), dtype),
                jax.random.uniform(d, (spec.num_streams,), dtype))

    u = jax.jit(jax.vmap(jax.vmap(jax.vmap(one))))(slot_keys)
    return (InjectedDraws(*[torch.from_numpy(np.array(x)) for x in u]),
            torch.from_numpy(np.array(gumbel)))


def _lane_params(tmodel, b):
    return {k: p.detach().unsqueeze(0).expand((b,) + p.shape).clone().requires_grad_()
            for k, p in tmodel.named_parameters()}


def _jax_grads_by_name(grads):
    return {f"layers.{i}.{w}": np.asarray(grads[f"cheb_{i}"][w])
            for i in range(len(grads)) for w in ("kernel", "bias")}


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _trainers(fl, **tkw):
    jmodel, variables, tmodel = _models(fl)
    jcfg = dataclasses.replace(JConfig(layout=fl["layout"]), **{
        k: v for k, v in TINY.items() if k != "dtype"})
    tcfg = dataclasses.replace(Config(layout=fl["layout"]), **TINY)
    jtr = JRLTrainer(jcfg, jmodel, variables, fl["jspec"], sim_dtype=jnp.float64)
    ttr = RLTrainer(tcfg, tmodel, fl["tspec"], sim_dtype=F64, **tkw)
    return jtr, ttr


def test_fleet_matches_jax_build_fleet():
    """`cli.rl.build_fleet` builds JAX's cases, rates and sim parameters
    (`TINY` at `dtype=float64`: both fleets float32, so the rates agree to
    float32 rounding, the rest bit for bit)."""
    from multihop_offload_tpu.cli.rl import build_fleet as j_build_fleet

    fl = _fleet("dense")
    cfg = dataclasses.replace(Config(), **TINY)
    insts, jobss, paramss, spec, _ = rl_cli.build_fleet(cfg, "cpu")
    jinsts, jjobs, jparams, jspec, _ = j_build_fleet(dataclasses.replace(JConfig(), **TINY))
    assert spec == fl["tspec"] == tstate.SimSpec(*dataclasses.astuple(jspec))
    np.testing.assert_array_equal(_np(insts.adj), np.asarray(jinsts.adj))
    np.testing.assert_array_equal(_np(jobss.src), np.asarray(jjobs.src))
    assert jobss.rate.dtype == torch.float32 and jjobs.rate.dtype == np.float32
    np.testing.assert_allclose(_np(jobss.rate), np.asarray(jjobs.rate), rtol=4 * 2.0 ** -23)
    np.testing.assert_allclose(_np(paramss.arr_p), np.asarray(jparams.arr_p),
                               rtol=4 * 2.0 ** -23)
    np.testing.assert_array_equal(_np(paramss.dt), np.asarray(jparams.dt))


def test_buffer_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    jb, tb = jbuf.buffer_init(5), tbuf.buffer_init(5)
    assert float(tbuf.buffer_baseline(tb)) == 0.0
    for n in (2, 3, 1, 7, 5):
        v = rng.uniform(-1, 2, n).astype(np.float32)
        jb = jbuf.buffer_push(jb, jnp.asarray(v))
        tb = tbuf.buffer_push(tb, torch.from_numpy(v))
        np.testing.assert_array_equal(_np(tb.rewards), np.asarray(jb.rewards))
        assert int(tb.count) == int(jb.count) and int(tb.ptr) == int(jb.ptr)
        assert tb.rewards.dtype == torch.float32 and tb.count.dtype == torch.int32
        # the mean's float32 sum: XLA's CPU reduction order is its own (not
        # sequential, not pairwise over 64 slots), so the baseline agrees to
        # float32 rounding, the ring and its counters bit for bit
        np.testing.assert_allclose(_np(tbuf.buffer_baseline(tb)),
                                   np.asarray(jbuf.buffer_baseline(jb)), rtol=4 * 2.0 ** -23)


def check_rollout(layout):
    """One episode per lane on `layout`: the same counters, rewards,
    destinations and routes bit for bit; log-probabilities, entropies and
    losses within 1e-10; the per-lane parameter gradients within 1e-9."""
    fl = _fleet(layout)
    jmodel, variables, tmodel = _models(fl)
    jinsts, jjobs, jparams = fl["j"]
    tinsts, tjobs, tparams = fl["t"]
    jspec, tspec = fl["jspec"], fl["tspec"]
    rounds, slots = TINY["rl_rounds"], TINY["rl_slots"]
    cfg = JConfig(rl_temp=TINY["rl_temp"], rl_delay_weight=0.05, rl_ent=0.05)
    fleet_n = TINY["rl_fleet"]
    keys = jax.random.split(jax.random.PRNGKey(42), fleet_n)
    lay = None if fl["layout"] == "dense" else fl["layout"]
    st0 = jstate.init_state(jspec, jnp.float64)
    rates0 = jnp.zeros((jspec.num_jobs,), jnp.float64)

    def lane(params, inst, jobs, sp, key):
        return j_rollout(jmodel, {"params": params}, inst, jobs, jspec, sp, st0, rates0,
                                key, BASELINE, rounds, slots, cfg.rl_temp,
                                cfg.rl_delay_weight, cfg.rl_ent, layout=lay)

    run = jax.jit(jax.vmap(jax.value_and_grad(lane, has_aux=True),
                           in_axes=(None, 0, 0, 0, 0)))
    (jloss, jout), jgrads = run(variables["params"], jinsts, jjobs, jparams, keys)

    draws, gumbel = _draws(keys, jspec, rounds, slots, int(tinsts.servers.shape[1]) + 1)
    params = _lane_params(tmodel, fleet_n)
    tloss, tout = t_rollout(
        tmodel, params, tinsts, tjobs, tspec, tparams,
        tstate.init_state(tspec, fleet_n, F64), torch.zeros((fleet_n, tspec.num_jobs), dtype=F64),
        draws, BASELINE, rounds, slots, cfg.rl_temp, cfg.rl_delay_weight,
        cfg.rl_ent, layout=fl["layout"], gumbel=gumbel)
    grads = dict(zip(params, torch.autograd.grad(tloss.sum(), list(params.values()))))

    for f in ("generated", "delivered", "dropped", "delay_sum"):
        np.testing.assert_array_equal(_np(getattr(tout.deltas, f)),
                                      np.asarray(getattr(jout.deltas, f)), err_msg=f)
    np.testing.assert_array_equal(_np(tout.rewards), np.asarray(jout.rewards))
    np.testing.assert_array_equal(_np(tout.dsts), np.asarray(jout.dsts))
    for f in ("dst", "next_hop", "reach"):
        np.testing.assert_array_equal(_np(getattr(tout.routes, f)),
                                      np.asarray(getattr(jout.routes, f)), err_msg=f)
    for f in ("generated", "delivered", "dropped", "count", "t"):
        np.testing.assert_array_equal(_np(getattr(tout.state, f)),
                                      np.asarray(getattr(jout.state, f)), err_msg=f)
    np.testing.assert_allclose(_np(tout.logps), np.asarray(jout.logps), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(tout.ents), np.asarray(jout.ents), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), rtol=0, atol=1e-10)
    offloaded = (tout.dsts != tjobs.src.unsqueeze(1)) & tjobs.mask.unsqueeze(1)
    assert offloaded.any()  # the sampled destinations include servers
    want = _jax_grads_by_name(jgrads)
    for k, g in grads.items():
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(_np(g), want[k], rtol=0, atol=1e-9 * scale, err_msg=k)
    assert max(float(g.abs().max()) for g in grads.values()) > 0


def test_rollout_matches_jax_dense():
    check_rollout("dense")
