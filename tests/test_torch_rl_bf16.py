"""The RL path under bf16 against the JAX package on the CPU: `rl.RLTrainer`
(its rollout, gradients and update) under `precision='bf16'` (the mixed
policy: float32 parameters, bf16 ChebConv operands, float32
accumulation) and under `dtype='bfloat16'` (the identity policy at a bf16
base: bf16 parameters against float32 features, promoted to float32 as
`jnp.matmul` does).

The fleet is float32 in both packages, as both `mho-rl`s build it (BA(8)
x 4 lanes of `tests/test_torch_rl.py:_fleet`, 2 rounds of 10 slots,
temperature 1000 so that servers are sampled and the gradient flows
through the APSP); a 3-layer ChebNet of width 8 (K = 1 dense, K = 2
sparse, where the ChebConv propagates: K4 bf16 forward and transposed
under the mixed policy).  The models carry the same weights, JAX's init
under its policy (the output sign flipped where it is dead at birth on
the fleet); the port's draws are the JAX run's, injected.

One port `RLTrainer` step (its first: baseline 0) against JAX: the lanes'
`jax.vmap(jax.value_and_grad(rollout))` under the same draws, and JAX's
update of their mean gradient by the `RLTrainer`'s own optimizer and
max-norm constraint (the body of its `step_fn`).  Both JAX programs are
compiled with excess precision off (`strict_jit`): XLA's CPU compiler
otherwise drops bf16 roundings the program writes.

Bars, on both layouts and both legs, one case a file (each case's JAX
compiles take most of its time): this file the mixed policy on the dense
layout, `test_torch_rl_bf16_sparse.py` on the sparse one,
`test_torch_rl_bf16_dtype.py` and `test_torch_rl_bf16_dtype_sparse.py`
the bf16 base:
* sampled destinations equal on >= 99% of (lane, round, job) entries;
* each lane's loss within 1e-2 relative, its gradient within 2e-2 of its
  norm;
* the step's parameters within 0.05 of the update's norm;
* parameters, gradients and Adam's moments at JAX's dtypes; the
  simulator and the reward ring float32;
* the W handed to the APSP float32 in both packages (K2 float32 and its
  backward on the card; K2 bf16 is not on this path).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multihop_offload_tpu.agent.actor import build_ext_features as j_features
from multihop_offload_tpu.agent.actor import default_support as j_support
from multihop_offload_tpu.agent.replay import apply_max_norm_constraint
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.env.apsp import apsp_minplus as j_apsp
from multihop_offload_tpu.layouts import resolve_layout, zeros_support
from multihop_offload_tpu.models.chebconv import ensure_alive_output_multi
from multihop_offload_tpu.models.chebconv import make_model as j_make_model
from multihop_offload_tpu.rl import RLTrainer as JRLTrainer
from multihop_offload_tpu.rl.rollout import rollout as j_rollout
from multihop_offload_tpu.sim import state as jstate
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.rl.trainer import RLTrainer
from tests.test_torch_bf16_backward import strict_jit
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_rl import TINY, _adam_state, _draws, _fleet, _jax_grads_by_name

# the module (the package exports its `rollout` function under that name)
trollout = importlib.import_module("multihop_offload_tpu_torch.rl.rollout")

FLEET = 4
SLOTS = 10
MODEL = dict(num_layer=3, hidden=8)
DST_AGREE = 0.99
LOSS_RTOL = 1e-2
GRAD_GAP = 2e-2      # of the lane's gradient norm
PARAM_DRIFT = 0.05   # ||p_port - p_jax|| over ||p_jax - p0||
LEGS = {"precision_bf16": dict(precision="bf16"), "dtype_bfloat16": dict(dtype="bfloat16")}
LAYOUTS = {"dense": dict(layout="dense", cheb_k=1), "sparse": dict(layout="sparse", cheb_k=2)}
TORCH_OF = {np.dtype(jnp.bfloat16): torch.bfloat16, np.dtype(np.float32): torch.float32}


def _wide(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


@functools.lru_cache(maxsize=None)
def fleet32(layout):
    return _fleet(layout, "float32", fleet=FLEET)


def draws32(layout):
    """The JAX lanes' keys and their draws in float32 (the port's injected
    slot uniforms and Gumbel noise), shared by the layouts' equal specs."""
    fl = fleet32(layout)
    return _draws32(fl["jspec"], int(fl["t"][0].servers.shape[1]) + 1)


@functools.lru_cache(maxsize=None)
def _draws32(spec, options):
    keys = jax.random.split(jax.random.PRNGKey(42), FLEET)
    return (keys,) + _draws(keys, spec, TINY["rl_rounds"], SLOTS, options, jnp.float32)


@functools.lru_cache(maxsize=None)
def run_case(leg, layout):
    """Both packages' step of the case: a dict of what the bars read."""
    kw = {**LEGS[leg], **LAYOUTS[layout], **MODEL}
    fl = fleet32(layout)
    rl = {k: v for k, v in TINY.items() if k != "dtype"} | dict(rl_fleet=FLEET, rl_slots=SLOTS)
    jcfg = dataclasses.replace(JConfig(**kw), **rl)
    tcfg = dataclasses.replace(Config(**kw), **rl)
    jinsts, jjobs, jparams = fl["j"]
    jspec = fl["jspec"]
    lay = resolve_layout(layout)

    # JAX's model and weights under the leg's policy
    jmodel = j_make_model(jcfg)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((fl["pad"].e, 4), jcfg.jnp_dtype),
        zeros_support(fl["pad"], jcfg.jnp_dtype, lay))
    probes = []
    for i in range(FLEET):
        inst = jax.tree_util.tree_map(lambda x: x[i], jinsts)
        jobs = jax.tree_util.tree_map(lambda x: x[i], jjobs)
        probes.append((j_features(inst, jobs), j_support(jmodel, inst, lay), inst.ext_mask))
    variables = ensure_alive_output_multi(jmodel, variables, probes)

    # JAX: the lanes' rollouts and gradients, then the trainer's update
    keys, draws, gumbel = draws32(layout)
    st0 = jstate.init_state(jspec, jnp.float32)
    rates0 = jnp.zeros((jspec.num_jobs,), jnp.float32)
    seen_j = []

    def j_apsp_rec(w):
        seen_j.append(w.dtype)
        return j_apsp(w, early_stop=False)

    def lane(params, inst, jobs, sp, key):
        return j_rollout(jmodel, {"params": params}, inst, jobs, jspec, sp, st0, rates0, key,
                         0.0, jcfg.rl_rounds, SLOTS, jcfg.rl_temp, jcfg.rl_delay_weight,
                         jcfg.rl_ent, apsp_fn=j_apsp_rec, layout=jcfg.layout_policy)

    run = jax.vmap(jax.value_and_grad(lane, has_aux=True), in_axes=(None, 0, 0, 0, 0))
    (jloss, jout), jgrads = strict_jit(run, variables["params"], jinsts, jjobs, jparams, keys)
    jtr = JRLTrainer(jcfg, jmodel, variables, jspec)

    def update(params, opt_state, grads):
        g = jax.tree_util.tree_map(lambda x: jnp.mean(x, axis=0), grads)
        upd, opt = jtr.optimizer.update(g, opt_state, params)
        return apply_max_norm_constraint(optax.apply_updates(params, upd), jcfg.max_norm), opt

    jparams1, jopt1 = strict_jit(update, jtr.params, jtr.opt_state, jgrads)

    # the port: one trainer step under the same draws, W's dtype recorded
    tmodel = tcheb.make_model(tcfg, layout=layout, policy=tcfg.precision_policy("cpu"))
    pdt = next(tmodel.parameters()).dtype
    wide = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables)
    tmodel.load_state_dict({k: v.to(pdt) for k, v in tcheb.params_from_jax(wide).items()})
    seen_t = []
    orig = trollout.apsp_minplus

    def t_apsp_rec(w, **k):
        seen_t.append(w.dtype)
        return orig(w, **k)

    ttr = RLTrainer(tcfg, tmodel, fl["tspec"])
    p0 = {k: v.clone() for k, v in ttr.params.items()}
    trollout.apsp_minplus = t_apsp_rec
    try:
        tout = ttr.train_step(*fl["t"], draws, gumbel=gumbel)
    finally:
        trollout.apsp_minplus = orig
    adam = _adam_state(jopt1)
    return {"jloss": np.asarray(jloss, np.float64), "jdsts": np.asarray(jout.dsts),
            "jgrads": _jax_grads_by_name(jgrads), "jparams": _jax_grads_by_name(jparams1),
            "jp0": _jax_grads_by_name(jtr.params), "jmu": _jax_grads_by_name(adam.mu),
            "jnu": _jax_grads_by_name(adam.nu), "seen_j": seen_j, "seen_t": seen_t,
            "tr": ttr, "out": tout, "p0": p0, "jobs": fl["t"][1], "rounds": jcfg.rl_rounds}


def check_sampled_destinations_agree(r, leg):
    jobs, out = r["jobs"], r["out"]
    mask = jobs.mask.unsqueeze(1).expand(-1, r["rounds"], -1)
    agree = float((out.dsts == torch.from_numpy(r["jdsts"].copy()))[mask].double().mean())
    assert agree >= DST_AGREE, agree
    # servers are sampled: the gradient goes through the APSP
    assert ((out.dsts != jobs.src.unsqueeze(1)) & mask).any()
    assert out.skipped == 0


def check_lane_losses_within_bar(r, leg):
    got, want = _wide(r["out"].losses), r["jloss"]
    assert np.all(np.abs(got - want) <= LOSS_RTOL * np.abs(want)), (got, want)


def check_lane_gradients_within_bar(r, leg):
    got, want = r["out"].grads, r["jgrads"]
    for i in range(FLEET):
        num = sum(float(((_wide(got[k][i]) - _wide(want[k][i])) ** 2).sum()) for k in got)
        den = sum(float((_wide(want[k][i]) ** 2).sum()) for k in got)
        assert den > 0 and (num / den) ** 0.5 <= GRAD_GAP, (i, (num / den) ** 0.5)


def check_train_step_parameters_within_bar(r, leg):
    p1, want, p0 = r["tr"].params, r["jparams"], r["p0"]
    for k in p0:  # both steps start from the same weights
        np.testing.assert_array_equal(_wide(p0[k]), _wide(r["jp0"][k]))
    gap = sum(float(((_wide(p1[k]) - _wide(want[k])) ** 2).sum()) for k in p1)
    step = sum(float(((_wide(want[k]) - _wide(p0[k])) ** 2).sum()) for k in p1)
    assert step > 0 and (gap / step) ** 0.5 <= PARAM_DRIFT, (gap / step) ** 0.5


def check_parameter_and_adam_dtypes_are_jax(r, leg):
    """Parameters, gradients and Adam's moments at JAX's dtypes (fp32 under
    the mixed policy, bf16 at a bf16 base); the simulator and the reward
    ring float32, JAX's islands."""
    tr, out = r["tr"], r["out"]
    want = torch.bfloat16 if leg == "dtype_bfloat16" else torch.float32
    for k, p in tr.params.items():
        assert p.dtype == TORCH_OF[r["jparams"][k].dtype] == want, k
        assert out.grads[k].dtype == TORCH_OF[r["jgrads"][k].dtype], k
        assert tr.opt_state.mu[k].dtype == TORCH_OF[r["jmu"][k].dtype], k
        assert tr.opt_state.nu[k].dtype == TORCH_OF[r["jnu"][k].dtype], k
    assert out.state.delay_sum.dtype == torch.float32 and tr.buf.rewards.dtype == torch.float32


def check_apsp_input_is_float32(r, leg):
    """The W the rollout squares on the tape is float32 in both packages:
    one APSP a round, no narrowing (JAX records it through `apsp_fn`)."""
    assert set(r["seen_j"]) == {jnp.dtype(jnp.float32)}
    assert r["seen_t"] == [torch.float32] * r["rounds"]


CHECKS = {name[len("check_"):]: fn for name, fn in sorted(globals().items())
          if name.startswith("check_")}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_rl_step_matches_jax_under_mixed_policy_dense(check):
    CHECKS[check](run_case("precision_bf16", "dense"), "precision_bf16")
