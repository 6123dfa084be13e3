"""PyTorch port, the decision path end to end against `jax.vmap` of the JAX
functions, in float64 on the CPU, at ``explore=0, prob=False``.

`dst`, `is_local`, `seq_slot`, `seq_active`, `nhop`, the route incidence
and `unit_mask` must be identical; `job_total`, `link_mu`, `unit_matrix`,
the model's lambda and the delay head (`delay_matrix`, on equal lambda)
within 1e-12 relative.  The same inputs, made from seeds with numpy, go
through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.env.policies import local_policy as j_local
from multihop_offload_tpu.graphs import generators
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.models.chebconv import chebyshev_support as jcheb_support
from multihop_offload_tpu_torch.agent.actor import lambdas_to_delay_matrix
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy
from multihop_offload_tpu_torch.graphs import cases as tcases
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.train.driver import eval_methods
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

RTOL = 1e-12


def _synthetic(n, seed):
    adj, _ = generators.barabasi_albert(n, m=2, seed=seed)
    rng = np.random.default_rng(seed)
    roles = np.zeros(n, dtype=np.int32)
    picks = rng.permutation(n)
    ns = max(2, n // 6)
    roles[picks[:ns]] = 1
    roles[picks[ns:ns + 2]] = 2
    bws = np.where(roles == 1, rng.uniform(100, 300, n),
                   np.where(roles == 0, rng.uniform(5, 15, n), 0.0)).round()
    return adj, roles, bws, rng.uniform(30, 70, int(np.triu(adj, 1).sum()))


def _paired_batch(cases, per_network=2, seed=0, scale=0.15):
    """The same padded requests built by both packages, float64."""
    rng = np.random.default_rng(seed)
    topos = [(jtopo.build_topology(c[0]), ttopo.build_topology(c[0])) for c in cases]
    pad = jinst.PadSpec.for_cases(
        [(c[0].shape[0], t.num_links, int((c[1] == 1).sum()),
          int((c[1] == 0).sum())) for c, (t, _) in zip(cases, topos)])
    tpad = tinst.PadSpec(pad.n, pad.l, pad.s, pad.j)
    ji, jj, ti, tj = [], [], [], []
    for (adj, roles, bws, mean), (topo_j, topo_t) in zip(cases, topos):
        rates = jtopo.sample_link_rates(topo_j, mean, rng=rng)
        inst_j = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, pad,
                                      dtype=np.float64, device=False)
        inst_t = tinst.build_instance(topo_t, roles, bws, rates, 1000.0, tpad,
                                      dtype=torch.float64, device="cpu")
        for _ in range(per_network):
            mobile = rng.permutation(np.flatnonzero(roles == 0))
            nj = int(rng.integers(max(int(0.3 * mobile.size), 1), mobile.size))
            src, rate = mobile[:nj], scale * rng.uniform(0.1, 0.5, nj)
            jj.append(jinst.build_jobset(src, rate, pad.j, dtype=np.float64,
                                         device=False))
            tj.append(tinst.build_jobset(src, rate, pad.j, dtype=torch.float64,
                                         device="cpu"))
            ji.append(inst_j)
            ti.append(inst_t)
    return (jinst.stack_instances(ji), jinst.stack_instances(jj),
            tinst.stack_instances(ti), tinst.stack_instances(tj), pad)


def _models(k, layers, hidden, pad, params=None):
    jmodel = JChebNet(num_layer=layers, hidden=hidden, k=k,
                      param_dtype=jnp.float64)
    if params is None:
        e = pad.e
        params = jax.device_get(jmodel.init(
            jax.random.PRNGKey(k), jnp.zeros((e, 4)), jnp.zeros((e, e))))
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
    tmodel = tcheb.ChebNet(num_layer=layers, hidden=hidden, k=k, dtype=torch.float64)
    tmodel.load_state_dict(tcheb.params_from_jax(variables))
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
    _close(t.delays.link_lambda, j.delays.link_lambda)
    _close(t.delays.link_mu, j.delays.link_mu)
    _close(t.delays.server_load, j.delays.server_load)
    _close(t.delays.unit_matrix, j.delays.unit_matrix)


def _compare_delay_head(ti, jact):
    """The delay head on the JAX model's own lambda.  The two models' lambdas
    agree to about 1e-15 (matmul summation order); the head's 1/(mu - lam)
    multiplies that by its condition number mu/(mu - lam), which nears 1e3
    where a random-weight model predicts a node close to capacity.  So the
    1e-12 bar holds the head on equal inputs, and the model on its own."""
    t = lambdas_to_delay_matrix(ti, torch.from_numpy(np.array(jact.lam)))
    _close(t.delay_matrix, jact.delay_matrix)
    _close(t.link_delay, jact.link_delay)
    _close(t.node_delay, jact.node_delay)


_KEY = jax.random.PRNGKey(0)
BATCHES = {
    "small": [(12, 1), (20, 2)],
    "mixed": [(16, 3), (28, 4), (40, 5)],
}


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_baseline_and_local_match_jax(batch):
    bi, bj, ti, tj, _ = _paired_batch([_synthetic(n, s) for n, s in BATCHES[batch]])
    _compare_outcome(baseline_policy(ti, tj),
                     jax.vmap(lambda i, j: j_baseline(i, j, _KEY))(bi, bj))
    _compare_outcome(local_policy(ti, tj), jax.vmap(j_local)(bi, bj))


@pytest.mark.parametrize("k,layers", [(1, 3), (2, 2)])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_forward_env_matches_jax(batch, k, layers):
    bi, bj, ti, tj, pad = _paired_batch(
        [_synthetic(n, s) for n, s in BATCHES[batch]], seed=k)
    jmodel, variables, tmodel = _models(k, layers, 8, pad)
    jout, jact = jax.vmap(
        lambda i, j: j_forward_env(jmodel, variables, i, j, _KEY))(bi, bj)
    tout, tact = forward_env(tmodel, ti, tj, device="cpu")
    _compare_outcome(tout, jout)
    _close(tact.lam, jact.lam)
    _compare_delay_head(ti, jact)
    if k >= 2:  # the support is the masked Laplacian, batched
        sup = tcheb.chebyshev_support(ti.adj_ext, ti.ext_mask)
        _close(sup, jax.vmap(jcheb_support)(bi.adj_ext, bi.ext_mask))


def test_compat_diagonal_matches_jax():
    bi, bj, ti, tj, pad = _paired_batch([_synthetic(n, s) for n, s in BATCHES["mixed"]])
    jmodel, variables, tmodel = _models(1, 2, 8, pad)
    jout, _ = jax.vmap(lambda i, j: j_forward_env(
        jmodel, variables, i, j, _KEY, compat_diagonal_bug=True))(bi, bj)
    tout, _ = forward_env(tmodel, ti, tj, compat_diagonal_bug=True, device="cpu")
    _compare_outcome(tout, jout)


def test_eval_methods_triple_matches_jax():
    bi, bj, ti, tj, pad = _paired_batch([_synthetic(n, s) for n, s in BATCHES["mixed"]])
    jmodel, variables, tmodel = _models(1, 3, 8, pad)
    bl = jax.vmap(lambda i, j: j_baseline(i, j, _KEY).job_total)(bi, bj)
    loc = jax.vmap(lambda i, j: j_local(i, j).job_total)(bi, bj)
    gnn = jax.vmap(lambda i, j: j_forward_env(
        jmodel, variables, i, j, _KEY)[0].job_total)(bi, bj)
    got = eval_methods(tmodel, ti, tj, torch.Generator(), device="cpu")
    for t, j in zip(got, (bl, loc, gnn)):
        _close(t, j)


def test_committed_case_and_weights_match_jax():
    """One committed case through both packages with the committed model of
    record, so the data files are held too."""
    rec = tcases.load_cases("paper")[2]  # n = 20
    with np.load(tcases.CASES_PATH) as z:
        adj = z["paper/2/adj"]
    case = (adj, rec.roles, rec.proc_bws, rec.link_rates)
    bi, bj, ti, tj, pad = _paired_batch([case], per_network=3, seed=11)
    params = tcheb.load_weights("SCRATCH800_decay0.99")
    jmodel, variables, tmodel = _models(1, 5, 32, pad, params=params)
    jout, jact = jax.vmap(
        lambda i, j: j_forward_env(jmodel, variables, i, j, _KEY))(bi, bj)
    tout, tact = forward_env(tmodel, ti, tj, device="cpu")
    _compare_outcome(tout, jout)
    _close(tact.lam, jact.lam)
    _compare_delay_head(ti, jact)
    _compare_outcome(baseline_policy(ti, tj),
                     jax.vmap(lambda i, j: j_baseline(i, j, _KEY))(bi, bj))


@pytest.mark.parametrize("prob", [False, True])
def test_exploration_draws_valid_options(prob):
    """`explore=1` (and softmax sampling) pick a valid option for every job;
    the draws come from the torch Generator and are reproducible."""
    _, _, ti, tj, _ = _paired_batch([_synthetic(n, s) for n, s in BATCHES["mixed"]])

    def run(seed):
        out = baseline_policy(ti, tj, torch.Generator().manual_seed(seed),
                              explore=1.0, prob=prob)
        return out.decision

    dec = run(5)
    servers = ti.servers.long()
    is_server = (dec.dst.long().unsqueeze(2) == servers.unsqueeze(1)) \
        & ti.server_mask.unsqueeze(1)
    ok = torch.where(dec.is_local, dec.dst.long() == tj.src.long(), is_server.any(2))
    assert bool(ok[tj.mask].all())
    assert torch.equal(run(5).dst, dec.dst)
    assert bool(dec.is_local.any()) and bool((~dec.is_local[tj.mask]).any())
