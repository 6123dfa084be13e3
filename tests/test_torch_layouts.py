"""PyTorch port, the sparse layout against the JAX package, in float64 on the
CPU: the sparse Instance's fields, the edge-list builders of the decision
path (`weight_matrix_from_edges`, `next_hop_from_edges`,
`apsp_minplus_blocked`) and the decisions, exact; the sparse Chebyshev
support, the propagate and the delays within 1e-12 relative.  The same
inputs, made from seeds with numpy, go through both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.env import apsp as japsp
from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.env.policies import local_policy as j_local
from multihop_offload_tpu.env.queueing import interference_fixed_point as j_ifp
from multihop_offload_tpu.graphs import generators
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.layouts import policy as jpolicy
from multihop_offload_tpu.layouts import sparse as jsparse
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.ops.fixed_point import fixed_point_pallas
from multihop_offload_tpu_torch import _phases
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.env import apsp as tapsp
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy
from multihop_offload_tpu_torch.env.queueing import interference_fixed_point
from multihop_offload_tpu_torch.graphs import cases as tcases
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.layouts import compact as tcompact
from multihop_offload_tpu_torch.layouts import policy as tpolicy
from multihop_offload_tpu_torch.layouts import sparse as tsparse
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.ops import chebconv as tcc
from multihop_offload_tpu_torch.train.driver import eval_methods
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

RTOL = 1e-12
_KEY = jax.random.PRNGKey(0)
# the JAX step with its Pallas fixed-point core given (off a TPU the core
# runs its XLA reference): the dense-matrix fixed point the port runs (K1)
FP_FN = fixed_point_pallas


def synthetic(n, seed):
    """A BA network with random roles, capacities and mean link rates."""
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


def paired_batch(cases, layout, per_network=2, seed=0, scale=0.15):
    """The same padded requests built by both packages under `layout`,
    float64; sparse nnz pads sized from the data (rounded up to 128)."""
    rng = np.random.default_rng(seed)
    topos = [(jtopo.build_topology(c[0]), ttopo.build_topology(c[0])) for c in cases]
    pad = jinst.PadSpec.for_cases(
        [(c[0].shape[0], t.num_links, int((c[1] == 1).sum()),
          int((c[1] == 0).sum())) for c, (t, _) in zip(cases, topos)])
    if layout == "sparse":
        enn = max(jsparse.ext_nnz_count(t, c[1] < 2) for c, (t, _) in zip(cases, topos))
        cnn = max(jsparse.cf_nnz_count(t) for t, _ in topos)
        pad = dataclasses.replace(pad, enn=pad.round_up(enn, 128),
                                  cnn=pad.round_up(cnn, 128))
    tpad = tinst.PadSpec(pad.n, pad.l, pad.s, pad.j, pad.enn, pad.cnn)
    idt = jpolicy.resolve_layout(layout).index_dtype
    ji, jj, ti, tj = [], [], [], []
    for (adj, roles, bws, mean), (topo_j, topo_t) in zip(cases, topos):
        rates = jtopo.sample_link_rates(topo_j, mean, rng=rng)
        inst_j = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, pad,
                                      dtype=np.float64, device=False, layout=layout)
        inst_t = tinst.build_instance(topo_t, roles, bws, rates, 1000.0, tpad,
                                      dtype=torch.float64, device="cpu", layout=layout)
        for _ in range(per_network):
            mobile = rng.permutation(np.flatnonzero(roles == 0))
            nj = int(rng.integers(max(int(0.3 * mobile.size), 1), mobile.size))
            src, rate = mobile[:nj], scale * rng.uniform(0.1, 0.5, nj)
            jj.append(jinst.build_jobset(src, rate, pad.j, dtype=np.float64,
                                         device=False, index_dtype=idt))
            tj.append(tinst.build_jobset(src, rate, pad.j, dtype=torch.float64,
                                         device="cpu", index_dtype=idt))
            ji.append(inst_j)
            ti.append(inst_t)
    return (jinst.stack_instances(ji), jinst.stack_instances(jj),
            tinst.stack_instances(ti), tinst.stack_instances(tj), pad)


def models(k, layers, hidden, pad, layout):
    """A JAX ChebNet and its port with the same random float64 weights."""
    prop = jsparse.make_sparse_propagate() if layout == "sparse" else None
    jmodel = JChebNet(num_layer=layers, hidden=hidden, k=k, param_dtype=jnp.float64,
                      propagate=prop)
    e = pad.e
    params = jax.device_get(JChebNet(num_layer=layers, hidden=hidden, k=k,
                                     param_dtype=jnp.float64).init(
        jax.random.PRNGKey(k), jnp.zeros((e, 4)), jnp.zeros((e, e))))
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
    tmodel = tcheb.ChebNet(num_layer=layers, hidden=hidden, k=k, dtype=torch.float64,
                           propagate=tcheb.layout_propagate(layout))
    tmodel.load_state_dict(tcheb.params_from_jax(variables))
    return jmodel, variables, tmodel


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def compare_outcome(t, j):
    eq(t.decision.dst, j.decision.dst)
    eq(t.decision.is_local, j.decision.is_local)
    eq(t.routes.seq_slot, j.routes.seq_slot)
    eq(t.routes.seq_active, j.routes.seq_active)
    eq(t.routes.nhop, j.routes.nhop)
    eq(t.delays.unit_mask, j.delays.unit_mask)
    eq(t.delays.congested, j.delays.congested)
    for f in ("job_total", "link_lambda", "link_mu", "server_load", "unit_matrix"):
        close(getattr(t.delays, f), getattr(j.delays, f))


BATCH = [(14, 1), (22, 2), (30, 3)]


def test_layout_policy_and_compact_storage():
    for name in ("dense", "sparse", "auto"):
        assert tpolicy.resolve_layout(name).name == (
            "sparse" if name == "sparse" else "dense")
    assert tpolicy.resolve_layout(None) is tpolicy.DENSE
    assert tpolicy.resolve_layout(tpolicy.SPARSE) is tpolicy.SPARSE
    assert tpolicy.SPARSE.index_dtype == jpolicy.SPARSE.index_dtype == np.int16
    assert tpolicy.DENSE.index_dtype == jpolicy.DENSE.index_dtype == np.int32
    with pytest.raises(ValueError):
        tpolicy.resolve_layout("csr")
    for v in (0, 127, 128, 32767, 32768, 2**31):
        from multihop_offload_tpu.layouts import compact as jcompact

        assert tcompact.compact_index_dtype(v) == jcompact.compact_index_dtype(v)
        assert tcompact.compact_value_dtype(v) == jcompact.compact_value_dtype(v)
    nh = torch.randint(0, 300, (2, 300, 300), dtype=torch.int32)
    packed = tcompact.pack_next_hop(nh)
    assert packed.dtype == torch.int16 and torch.equal(tcompact.unpack_next_hop(packed), nh)


def test_sparse_instance_fields_exact():
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse")
    for f in tinst.Instance.__dataclass_fields__:
        if f != "sparse":
            t, j = getattr(ti, f), np.asarray(getattr(bi, f))
            assert t.numpy().dtype == j.dtype, f
            eq(t, j)
    assert ti.link_index.dtype == torch.int16 and tj.src.dtype == torch.int16
    for part in ("ext", "cf"):
        tc, jc = getattr(ti.sparse, part), getattr(bi.sparse, part)
        assert tc.shape == jc.shape
        for f in ("rows", "cols", "vals"):
            t, j = getattr(tc, f), np.asarray(getattr(jc, f))
            assert t.numpy().dtype == j.dtype
            eq(t, j)
    # the heuristic pads and the overflow check match the JAX PadSpec
    for p in (jinst.PadSpec(112, 216, 24, 104), jinst.PadSpec(256, 496, 64, 216)):
        tp = tinst.PadSpec(p.n, p.l, p.s, p.j)
        assert (tp.ext_nnz, tp.cf_nnz) == (p.ext_nnz, p.cf_nnz)
    adj, roles, bws, mean = synthetic(30, 3)
    topo = ttopo.build_topology(adj)
    small = tinst.PadSpec(32, 64, 8, 24, enn=128, cnn=128)
    with pytest.raises(ValueError, match="nnz pad"):
        tinst.build_instance(topo, roles, bws, mean, 1000.0, small,
                             device="cpu", layout="sparse")


def test_committed_pads_sized_from_data():
    """The nnz pads of the committed batches: the paper batch's and the
    256-node rung's largest counts, rounded up to 128 (the rung's conflict
    graph, 7,988 nonzeros, exceeds the 16 L heuristic of 7,936)."""
    paper = tcases.pad_for(tcases.load_cases("paper")[:16], "sparse")
    rung = tcases.pad_for(tcases.load_cases("rung256"), "sparse")
    assert (paper.enn, paper.cnn) == (4096, 3328)
    assert (rung.enn, rung.cnn) == (9984, 8064)
    assert tinst.PadSpec(rung.n, rung.l, rung.s, rung.j).cf_nnz < 7988
    inst, jobs, _ = tcases.request_batch(tcases.load_cases("rung256"), 1,
                                         device="cpu", layout="sparse")
    assert inst.sparse.cf.rows.shape == (4, 8064) and jobs.src.dtype == torch.int16


def test_decision_builders_exact():
    bi, _, ti, _, _ = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse")
    rng = np.random.default_rng(5)
    delays = rng.uniform(0.05, 3.0, tuple(ti.link_rates.shape))
    n = ti.num_pad_nodes
    w_t = tsparse.weight_matrix_from_edges(ti.link_ends, ti.link_mask,
                                           torch.from_numpy(delays), n)
    w_j = jax.vmap(lambda e, m, d: jsparse.weight_matrix_from_edges(e, m, d, n))(
        bi.link_ends, bi.link_mask, jnp.asarray(delays))
    eq(w_t, w_j)
    # equal to the dense layout's gather, too
    eq(w_t, tapsp.weight_matrix_from_link_delays(ti.adj, ti.link_index,
                                                 torch.from_numpy(delays)))
    sp_t = tapsp.apsp_minplus_blocked(w_t)
    eq(sp_t, jax.jit(jax.vmap(japsp.apsp_minplus_blocked))(w_j))
    eq(sp_t, tapsp.apsp_minplus(w_t))
    eq(tsparse.next_hop_from_edges(ti.link_ends, ti.link_mask, sp_t),
       jax.vmap(jsparse.next_hop_from_edges)(bi.link_ends, bi.link_mask, jnp.asarray(sp_t)))
    eq(tsparse.next_hop_from_edges(ti.link_ends, ti.link_mask, sp_t),
       tapsp.next_hop_table(ti.adj, sp_t))


def test_sparse_support_and_propagate_match_jax():
    bi, _, ti, _, pad = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse")
    sup_t = tsparse.sparse_chebyshev_support(ti.sparse.ext, mask=ti.ext_mask)
    sup_j = jax.vmap(lambda c, m: jsparse.sparse_chebyshev_support(c, mask=m))(
        bi.sparse.ext, bi.ext_mask)
    close(sup_t.edges.vals, sup_j.edges.vals)
    close(sup_t.diag, sup_j.diag)
    x = np.random.default_rng(2).normal(size=(ti.adj.shape[0], pad.e, 8))
    got = tcc.chebconv_propagate(sup_t, torch.from_numpy(x))
    want = jax.vmap(jsparse.make_sparse_propagate())(sup_j, jnp.asarray(x))
    close(got, want)
    # edge-list propagate == the dense Laplacian product
    dense = tcheb.chebyshev_support(ti.adj_ext, ti.ext_mask)
    close(got, torch.matmul(dense, torch.from_numpy(x)).numpy(), rtol=1e-12)


def _csr_walk(ptr, order, index, vals, diag, x):
    """K4's access pattern in numpy: each row's sum over its CSR range in
    list order, then plus diag * x."""
    out = np.empty_like(x)
    for b in range(x.shape[0]):
        for r in range(x.shape[1]):
            acc = np.zeros(x.shape[2])
            for p in range(ptr[b, r], ptr[b, r + 1]):
                e = p if order is None else order[b, p]
                acc = acc + vals[b, e] * x[b, index[b, e]]
            out[b, r] = acc + diag[b, r] * x[b, r]
    return out


@pytest.mark.parametrize("transpose", [False, True])
def test_csr_index_walk_equals_plain_propagate(transpose):
    """The host-built CSR index reaches every real entry once, in list
    order, and no pad: a walk through it equals the plain propagate (and
    its transpose, the backward) bit for bit."""
    _, _, ti, _, pad = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse")
    sup = tsparse.sparse_chebyshev_support(ti.sparse.ext, mask=ti.ext_mask,
                                           csr=ti.sparse.ext_csr)
    e, csr = sup.edges, sup.csr
    x = np.random.default_rng(6).normal(size=(ti.adj.shape[0], pad.e, 5))
    if transpose:
        walk = _csr_walk(csr.col_ptr.numpy(), csr.col_order.numpy(), e.rows.numpy(),
                         e.vals.numpy(), sup.diag.numpy(), x)
        plain = tsparse.propagate_edges(e.cols, e.rows, e.vals, sup.diag, torch.from_numpy(x))
    else:
        walk = _csr_walk(csr.row_ptr.numpy(), None, e.cols.numpy(), e.vals.numpy(),
                         sup.diag.numpy(), x)
        plain = tsparse.propagate_edges(e.rows, e.cols, e.vals, sup.diag, torch.from_numpy(x))
    np.testing.assert_array_equal(walk, plain.numpy())
    nnz = np.count_nonzero(e.vals.numpy(), axis=1)
    np.testing.assert_array_equal(csr.row_ptr[:, -1].numpy(), nnz)
    np.testing.assert_array_equal(csr.col_ptr[:, -1].numpy(), nnz)


def test_edge_list_fixed_point_matches_jax():
    """The sparse path's fixed point (K1's plain version on the dense
    conflict matrix) against the JAX sparse layout's segment-sum over the
    conflict edge list."""
    bi, _, ti, _, _ = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse")
    lam = np.random.default_rng(4).uniform(0, 40, tuple(ti.link_rates.shape))
    lam = np.where(np.asarray(bi.link_mask), lam, 0.0)
    got = interference_fixed_point(ti, torch.from_numpy(lam))
    want = jax.jit(jax.vmap(lambda i, l: j_ifp(i, l, layout="sparse")))(bi, jnp.asarray(lam))
    close(got, want)


@pytest.mark.parametrize("per_network", [1, 2])
def test_sparse_baseline_and_local_match_jax(per_network):
    bi, bj, ti, tj, _ = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse",
                                     per_network=per_network, seed=per_network)
    compare_outcome(baseline_policy(ti, tj, layout="sparse"),
                    jax.jit(jax.vmap(lambda i, j: j_baseline(i, j, _KEY, fp_fn=FP_FN,
                                                     layout="sparse")))(bi, bj))
    compare_outcome(local_policy(ti, tj, layout="sparse"),
                    jax.jit(jax.vmap(lambda i, j: j_local(i, j, fp_fn=FP_FN,
                                                  layout="sparse")))(bi, bj))
    # the sparse layout decides exactly as the dense one
    dense = baseline_policy(ti, tj)
    sparse = baseline_policy(ti, tj, layout="sparse")
    eq(sparse.decision.dst, dense.decision.dst.numpy())
    close(sparse.delays.job_total, dense.delays.job_total.numpy())


def test_sparse_forward_env_and_eval_methods_match_jax():
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in BATCH], "sparse",
                                       seed=3)
    jmodel, variables, tmodel = models(2, 2, 8, pad, "sparse")
    jout, jact = jax.jit(jax.vmap(lambda i, j: j_forward_env(
        jmodel, variables, i, j, _KEY, fp_fn=FP_FN, layout="sparse")))(bi, bj)
    tout, tact = forward_env(tmodel, ti, tj, device="cpu", layout="sparse")
    compare_outcome(tout, jout)
    close(tact.lam, jact.lam)
    bl = jax.jit(jax.vmap(lambda i, j: j_baseline(i, j, _KEY, fp_fn=FP_FN,
                                                  layout="sparse").job_total))(bi, bj)
    loc = jax.jit(jax.vmap(lambda i, j: j_local(i, j, fp_fn=FP_FN,
                                                layout="sparse").job_total))(bi, bj)
    with _phases.timing() as times:  # the phases the profile script reads
        got = eval_methods(tmodel, ti, tj, device="cpu", layout="sparse")
    steps = ["apsp", "offload_decide", "next_hops", "trace_routes", "run_empirical"]
    assert set(times) == {"baseline", "local", "gnn", "gnn/actor"} | {
        f"{m}/{p}" for m in ("baseline", "gnn") for p in steps}
    for t, j in zip(got, (bl, loc, jout.delays.job_total)):
        close(t, j)
