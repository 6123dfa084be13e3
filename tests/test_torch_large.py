"""PyTorch port, the large-graph path (`large_scale.py`) against the JAX
package, in float64 on the CPU.

On an Erdős–Rényi network of 300 nodes drawn by the large-scale demo's own
`build_case` (padded N=304, which the APSP pads to 384; L > 928), the port
takes the blocked-FW APSP (the demo's `'pallas'` route, `large_scale.LARGE_APSP`)
and the fixed-point scan; the JAX run takes
`apsp_minplus_pallas` in interpret mode (the blocked FW there too) and its
XLA scan.  `dst`, next hops, routes and masks must be identical,
`job_total` and the other delays within 1e-12 relative.  The committed
``large`` group and ``LARGE_K3_init`` weights are held against the demo's
draw and the JAX model's init.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.env import apsp as japsp
from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.env.policies import local_policy as j_local
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.ops.minplus import apsp_minplus_pallas
from multihop_offload_tpu_torch import large_scale
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.env import apsp as tapsp
from multihop_offload_tpu_torch.env.policies import baseline_policy
from multihop_offload_tpu_torch.graphs import cases as tcases
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.ops import fixed_point as tfp
from multihop_offload_tpu_torch.ops import minplus as tmp
from multihop_offload_tpu_torch.train.driver import eval_methods
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
_KEY = jax.random.PRNGKey(0)
_PALLAS_APSP = functools.partial(apsp_minplus_pallas, interpret=True)


def _demo():
    spec = importlib.util.spec_from_file_location(
        "large_scale_demo", os.path.join(ROOT, "scripts", "large_scale_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demo_draw(n, seed, load=0.15):
    """The demo's network and job set (`scripts/large_scale_demo.py:97-109`)."""
    rng = np.random.default_rng(seed)
    topo, roles, proc_bws, link_rates = _demo().build_case(n, "er", seed, rng)
    mobile = np.flatnonzero(roles == 0)
    nj = int(0.5 * mobile.size)
    src = rng.permutation(mobile)[:nj]
    return topo, roles, proc_bws, link_rates, src, load * rng.uniform(0.1, 0.5, nj)


@pytest.fixture(scope="module")
def er300():
    """A 300-node demo draw, as a `LargeCase` and as the JAX batch of one."""
    topo_j, roles, bws, rates, src, rate = _demo_draw(300, 5)
    rec = tcases.CaseRecord(topo=ttopo.build_topology(topo_j.adj), roles=roles,
                            proc_bws=bws, link_rates=rates, seed=5, name="er300")
    case = tcases.LargeCase(rec=rec, job_src=src, job_rate=rate, T=1000.0)
    ti, tj, pad = tcases.large_request(case, dtype=torch.float64, device="cpu")
    jpad = jinst.PadSpec(pad.n, pad.l, pad.s, pad.j)
    ji = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, jpad, dtype=np.float64,
                              device=False)
    jj = jinst.build_jobset(src, rate, jpad.j, dtype=np.float64, device=False)
    bi, bj = jinst.stack_instances([ji]), jinst.stack_instances([jj])
    return case, ti, tj, pad, bi, bj


def _models():
    params = tcheb.load_weights(large_scale.MODEL)
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
    jmodel = JChebNet(num_layer=5, hidden=32, k=3, param_dtype=jnp.float64)
    tmodel = tcheb.load_model(large_scale.MODEL, dtype=torch.float64, device="cpu")
    return jmodel, variables, tmodel


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=0)


def _compare_outcome(t, j):
    _eq(t.decision.dst, j.decision.dst)
    _eq(t.decision.is_local, j.decision.is_local)
    _eq(t.routes.seq_slot, j.routes.seq_slot)
    _eq(t.routes.seq_active, j.routes.seq_active)
    _eq(t.routes.nhop, j.routes.nhop)
    _eq(t.routes.inc_ext, j.routes.inc_ext)
    _eq(t.delays.unit_mask, j.delays.unit_mask)
    _eq(t.delays.congested, j.delays.congested)
    _close(t.delays.job_total, j.delays.job_total)
    _close(t.delays.link_mu, j.delays.link_mu)
    _close(t.delays.unit_matrix, j.delays.unit_matrix)


def test_er300_takes_the_large_paths(er300):
    _, ti, _, pad, _, _ = er300
    assert (pad.n, tmp.padded_n(pad.n)) == (304, 384)
    assert tmp.apsp_path(pad.n) == "blocked-fw"
    assert pad.l > 928 and tfp.fixed_point_path(pad.l) == "scan"
    assert int(ti.link_mask.sum()) > 928


def test_forward_env_matches_jax_at_padded_384(er300):
    _, ti, tj, _, bi, bj = er300
    jmodel, variables, tmodel = _models()
    jout, jact = jax.jit(jax.vmap(lambda i, j: j_forward_env(
        jmodel, variables, i, j, _KEY, apsp_fn=_PALLAS_APSP)))(bi, bj)
    runs = tfp.fixed_point_scan.runs
    tout, tact = forward_env(tmodel, ti, tj, device="cpu", apsp_impl=large_scale.LARGE_APSP)
    assert tfp.fixed_point_scan.runs - runs == 2  # actor, empirical evaluator
    _compare_outcome(tout, jout)
    _close(tact.lam, jact.lam)
    # the next hops over the GNN's predicted delays (the JAX model's: the two
    # models' agree to ~1e-15, and sp would carry that), from each APSP
    sp = tmp.apsp_minplus_pallas(tapsp.weight_matrix_from_link_delays(
        ti.adj, ti.link_index, torch.from_numpy(np.array(jact.link_delay))))
    jsp = jax.vmap(lambda a, li, d: _PALLAS_APSP(japsp.weight_matrix_from_link_delays(
        a, li, d)))(bi.adj, bi.link_index, jact.link_delay)
    _eq(sp, jsp)
    _eq(tapsp.next_hop_table(ti.adj, sp), jax.vmap(japsp.next_hop_table)(bi.adj, jsp))


def test_eval_methods_matches_jax_at_padded_384(er300):
    _, ti, tj, _, bi, bj = er300
    jmodel, variables, tmodel = _models()

    @jax.jit
    def triple(i, j):
        return jax.vmap(lambda i_, j_: (
            j_baseline(i_, j_, _KEY, apsp_fn=_PALLAS_APSP),
            j_local(i_, j_).job_total,
            j_forward_env(jmodel, variables, i_, j_, _KEY,
                          apsp_fn=_PALLAS_APSP)[0].job_total))(i, j)

    jbase, jloc, jgnn = triple(bi, bj)
    got = eval_methods(tmodel, ti, tj, device="cpu", apsp_impl=large_scale.LARGE_APSP)
    for t, j in zip(got, (jbase.delays.job_total, jloc, jgnn)):
        _close(t, j)
    _compare_outcome(baseline_policy(ti, tj, apsp_impl=large_scale.LARGE_APSP), jbase)


def test_large_scale_run_on_cpu(er300):
    case = er300[0]
    rep = large_scale.run("cpu", steps=1, backward=True, case=case)
    assert (rep["apsp"], rep["fixed_point"], rep["cheb_k"]) == ("blocked-fw", "scan", 3)
    assert (rep["n"], rep["jobs"], rep["ext_slots"]) == (300, case.job_src.size,
                                                         rep["pad"][0] + rep["pad"][1])
    for key in ("build_s", "compile_s", "step_s", "tau", "congested_ratio",
                "offloaded_ratio", "apsp_pallas_ms", "apsp_xla_ms", "bwd_compile_s",
                "bwd_step_s", "loss_critic"):
        assert np.isfinite(rep[key]), key
    assert rep["grads_finite"] and rep["tau"] == rep["tau_methods"]["gnn"]
    # on the CPU no kernel launches; the fixed point runs the scan
    scans = {"forward_env": 2, "eval_methods": 4, "forward_backward": 3}
    for call, c in rep["launches"].items():
        assert c["fixed_point_scan"] == scans[call]
        assert sum(v for k, v in c.items() if k != "fixed_point_scan") == 0


def test_committed_large_case_matches_demo_draw():
    topo_j, roles, bws, rates, src, rate = _demo_draw(1024, 42)
    case = tcases.load_large_case()
    rec = case.rec
    np.testing.assert_array_equal(rec.topo.link_ends, topo_j.link_ends)
    np.testing.assert_array_equal(rec.topo.adj, topo_j.adj)
    np.testing.assert_array_equal(rec.roles, roles)
    np.testing.assert_array_equal(rec.proc_bws, bws)
    np.testing.assert_array_equal(rec.link_rates, rates)
    np.testing.assert_array_equal(case.job_src, src)
    np.testing.assert_array_equal(case.job_rate, rate)
    assert (case.T, case.gtype) == (1000.0, "er")
    assert (rec.topo.n, rec.topo.num_links, case.job_src.size) == (1024, 7694, 451)
    pad = tcases.pad_for([rec])
    assert (pad.n, pad.l, pad.s, pad.j, pad.e) == (1024, 7696, 104, 904, 8720)
    assert tmp.apsp_path(pad.n) == "blocked-fw" and tfp.fixed_point_path(pad.l) == "scan"


def test_large_request_builds_the_demo_instance():
    """The port's instance of the committed case: 7,694 real links and 451
    jobs in the demo's pads N=1,024, L=7,696, E=8,720 (float32, ~7 s and
    ~1.4 GB on the host)."""
    inst, jobs, pad = tcases.large_request(device="cpu")
    assert (pad.n, pad.l, pad.e) == (1024, 7696, 8720)
    assert tuple(inst.adj.shape) == (1, 1024, 1024)
    assert tuple(inst.adj_conflict.shape) == (1, 7696, 7696)
    assert tuple(inst.adj_ext.shape) == (1, 8720, 8720)
    assert int(inst.link_mask.sum()) == 7694 and int(jobs.mask.sum()) == 451
    assert int(inst.node_mask.sum()) == 1024 and float(inst.T[0]) == 1000.0


@pytest.mark.parametrize("e", [24, 40])
def test_large_init_weights_match_jax_init(e):
    """`LARGE_K3_init` is the demo's `make_model(Config(cheb_k=3)).init(
    PRNGKey(0), ...)`, whose values do not depend on E."""
    from multihop_offload_tpu.config import Config
    from multihop_offload_tpu.models import make_model

    want = make_model(Config(cheb_k=3)).init(
        jax.random.PRNGKey(0), jnp.zeros((e, 4)), jnp.zeros((e, e)))["params"]
    got = tcheb.load_weights(large_scale.MODEL)["params"]
    assert sorted(got) == sorted(want)
    for layer, leaves in want.items():
        for leaf, val in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(val))
