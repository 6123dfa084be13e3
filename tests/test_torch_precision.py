"""PyTorch port, the bf16 precision policy (`precision.py`) against the JAX
package's on the CPU.

The same numpy-seeded networks and job sets go through both packages under
`precision='bf16'`: instances and job sets stored as bf16 (the port narrows
with torch's round to nearest even, JAX with `ml_dtypes`), the ChebNet's
operands in bf16 with fp32 accumulation, the APSP squared in bf16, and the
four fp32 islands.  The JAX side runs as `tests/test_precision.py` runs it
(`wrap_apsp` over its XLA squaring, the XLA propagate); bf16 arrays cross to
numpy as float32, which is exact.

Bars (bf16 carries an 8-bit mantissa, one unit in the last place 2^-8
relative):
* exact where the arithmetic is: the stored fields, K2's and K6's plain
  versions (the shortest paths), the next-hop tables and the `baseline`
  decisions, bit for bit; the sim's `baseline` policy over one round under
  the JAX run's own draws, every state field;
* within one bf16 ulp: the Chebyshev support, K4's plain version;
* the actor's output within rtol 2^-7 (matmul summation order differs
  between XLA and torch by an ulp);
* decisions: `gnn` `dst` agreement >= 0.99 against JAX, job totals within
  1e-2 relative; the port's own bf16-vs-fp32 gate at JAX's thresholds
  (agreement 0.99, mean job total 0.05, fp32 vs fp64 1e-3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu import precision as jprec
from multihop_offload_tpu.agent.actor import build_ext_features as j_features
from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.cli.serve import build_service as j_build_service
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.env.apsp import next_hop_table as j_next_hop
from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.env.policies import local_policy as j_local
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.layouts import sparse as jsparse
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.models.chebconv import chebyshev_support as j_cheb_support
from multihop_offload_tpu.ops.chebconv import _xla_propagate
from multihop_offload_tpu.serve import workload as jwork
from multihop_offload_tpu.sim import policies as jpol
from multihop_offload_tpu.sim import runner as jrun
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch import precision as tprec
from multihop_offload_tpu_torch.agent.actor import build_ext_features
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.cli import serve as tcli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env.apsp import apsp_minplus, next_hop_table
from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.layouts import sparse as tsparse
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.models.tf_import import save_reference_checkpoint
from multihop_offload_tpu_torch.ops import chebconv as tcc
from multihop_offload_tpu_torch.ops import fixed_point as tfp
from multihop_offload_tpu_torch.ops import minplus as tmp
from multihop_offload_tpu_torch.serve import workload as twork
from multihop_offload_tpu_torch.sim import fidelity as tfid
from multihop_offload_tpu_torch.sim import policies as tpol
from multihop_offload_tpu_torch.sim import runner as trun
from multihop_offload_tpu_torch.train import driver as td
from tests.test_torch_drivers import MODEL, common, jax_config, read_rows
from tests.test_torch_layouts import FP_FN, synthetic
from tests.test_torch_sim import _case_pair, _eq_state, _run_draws

ULP = 2.0 ** -8
AGREEMENT_FLOOR = 0.99   # `tests/test_precision.py`: bf16 vs fp32 decisions
TAU_RTOL_BF16 = 0.05     # mean job total, bf16 vs fp32
TAU_RTOL_FP32 = 1e-3     # fp32 vs float64
PORT_VS_JAX_RTOL = 1e-2  # job totals, port bf16 vs JAX bf16
ACTOR_RTOL = 2.0 ** -7
_KEY = jax.random.PRNGKey(0)
J16 = jprec.resolve_precision("bf16", jnp.float32)
T16 = tprec.resolve_precision("bf16", torch.float32)
BATCH = [(12, 1), (20, 2), (28, 4)]


def f32(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy (exact for bf16)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def within_ulps(got, want, ulps=1):
    got, want = f32(got), f32(want)
    return bool(np.all(np.abs(got - want) <= ulps * ULP * np.abs(want) + 1e-6))


def bf16_batch(cases, layout="dense", per_network=2, seed=0, scale=0.15,
               jdtype=None, tdtype=torch.bfloat16):
    """The same padded requests built by both packages under `layout`, stored
    at bf16 (JAX: `ml_dtypes` through its storage dtype; the port: torch);
    sparse nnz pads sized from the data."""
    jdtype = J16.storage_dtype if jdtype is None else jdtype
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
    idt = np.int16 if layout == "sparse" else np.int32
    ji, jj, ti, tj = [], [], [], []
    for (adj, roles, bws, mean), (topo_j, topo_t) in zip(cases, topos):
        rates = jtopo.sample_link_rates(topo_j, mean, rng=rng)
        inst_j = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, pad,
                                      dtype=jdtype, device=False, layout=layout)
        inst_t = tinst.build_instance(topo_t, roles, bws, rates, 1000.0, tpad,
                                      dtype=tdtype, device="cpu", layout=layout)
        for _ in range(per_network):
            mobile = rng.permutation(np.flatnonzero(roles == 0))
            nj = int(rng.integers(max(int(0.3 * mobile.size), 1), mobile.size))
            src, rate = mobile[:nj], scale * rng.uniform(0.1, 0.5, nj)
            jj.append(jinst.build_jobset(src, rate, pad.j, dtype=jdtype, device=False,
                                         index_dtype=idt))
            tj.append(tinst.build_jobset(src, rate, pad.j, dtype=tdtype, device="cpu",
                                         index_dtype=idt))
            ji.append(inst_j)
            ti.append(inst_t)
    return (jinst.stack_instances(ji), jinst.stack_instances(jj),
            tinst.stack_instances(ti), tinst.stack_instances(tj), pad)


@pytest.fixture(scope="module", params=["dense", "sparse"])
def batch(request):
    return request.param, bf16_batch([synthetic(n, s) for n, s in BATCH], request.param)


def jax_model(name, layout):
    """The committed model `name` as a JAX ChebNet under the bf16 policy
    (fp32 params, bf16 operands, fp32 accumulation) with its variables."""
    params = tcheb.load_weights(name)
    k, _, hidden = params["params"]["cheb_0"]["kernel"].shape
    prop = jsparse.make_sparse_propagate(jnp.float32) if layout == "sparse" else None
    model = JChebNet(num_layer=len(params["params"]), hidden=int(hidden), k=int(k),
                     param_dtype=jnp.float32, compute_dtype=jnp.bfloat16,
                     accum_dtype=jnp.float32, propagate=prop)
    return model, jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


# ---- the policy ----------------------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("precision", ["fp32", "bf16", "auto"])
@pytest.mark.parametrize("base", ["float32", "float64", "bfloat16"])
def test_resolve_precision_matches_jax(precision, base):
    """Every (precision, base dtype) resolves to JAX's policy; `auto` on the
    CPU is fp32, as JAX's off a TPU, and bf16 on CUDA."""
    j = jprec.resolve_precision(precision, jnp.dtype(base))
    t = tprec.resolve_precision(precision, getattr(torch, base), device="cpu")
    assert t.name == j.name and t.mixed == j.mixed
    for f in ("param_dtype", "compute_dtype", "accum_dtype", "storage_dtype"):
        assert _dtype_name(getattr(t, f)) == str(jnp.dtype(getattr(j, f))), f
    if precision == "auto":
        assert tprec.resolve_precision("auto", getattr(torch, base), device="cuda").name \
            == "bf16"
    assert tprec.resolve_precision(t) is t
    cfg = Config(precision=precision, dtype=base)
    assert cfg.torch_dtype == getattr(torch, base)
    assert cfg.precision_policy("cpu") == t
    assert cfg.precision_policy("cuda") == tprec.resolve_precision(
        precision, getattr(torch, base), device="cuda")


def test_unknown_precision_and_island_dtype():
    for bad in ("fp16", "int8"):
        with pytest.raises(ValueError, match="unsupported precision"):
            tprec.resolve_precision(bad)
        with pytest.raises(ValueError, match="precision"):
            Config(precision=bad)
    assert tprec.resolve_precision(None).name == "fp32"
    for dts in [("bfloat16",), ("float32",), ("float64",), ("bfloat16", "float64"),
                ("bfloat16", "float32"), ()]:
        got = tprec.island_dtype(*(getattr(torch, d) for d in dts))
        assert _dtype_name(got) == str(jprec.island_dtype(*(jnp.dtype(d) for d in dts)))
    assert tprec.FP32_ISLANDS == jprec.FP32_ISLANDS
    x = torch.ones(3)
    assert T16.cast_compute(x).dtype == torch.bfloat16
    p32 = tprec.resolve_precision("fp32")
    assert p32.cast_compute(x) is x and p32.wrap_apsp(None) is None


# ---- storage, support and the three kernels' plain versions --------------------


def test_storage_narrowing_equals_ml_dtypes(batch):
    """Every float field of the Instance and JobSet (and the sparse lists'
    values) stored at bf16 equals JAX's `ml_dtypes` narrowing bit for bit."""
    layout, (bi, bj, ti, tj, _) = batch
    for rec_t, rec_j in ((ti, bi), (tj, bj)):
        for f in dataclasses.fields(rec_t):
            t = getattr(rec_t, f.name)
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                assert t.dtype == torch.bfloat16, f.name
                np.testing.assert_array_equal(f32(t), f32(getattr(rec_j, f.name)),
                                              err_msg=f.name)
    if layout == "sparse":
        for name in ("ext", "cf"):
            t, j = getattr(ti.sparse, name), getattr(bi.sparse, name)
            assert t.vals.dtype == torch.bfloat16
            np.testing.assert_array_equal(f32(t.vals), f32(j.vals))


def test_chebyshev_support_is_built_wide_and_narrowed_once(batch):
    """The `laplacian` island: the support of a bf16 adjacency within one
    bf16 ulp of JAX's, in bf16; an explicit output dtype; the edge-list
    twin likewise."""
    layout, (bi, _, ti, _, _) = batch
    got = tcheb.chebyshev_support(ti.adj_ext, ti.ext_mask)
    want = jax.vmap(j_cheb_support)(bi.adj_ext, bi.ext_mask)
    assert got.dtype == torch.bfloat16 and within_ulps(got, want)
    wide = tcheb.chebyshev_support(ti.adj_ext.float(), ti.ext_mask)
    assert within_ulps(got, wide)
    assert tcheb.chebyshev_support(ti.adj_ext.float(), ti.ext_mask,
                                   dtype=torch.bfloat16).dtype == torch.bfloat16
    if layout == "sparse":
        sup = tsparse.sparse_chebyshev_support(ti.sparse.ext, mask=ti.ext_mask)
        jsup = jax.vmap(lambda e, m: jsparse.sparse_chebyshev_support(e, mask=m))(
            bi.sparse.ext, bi.ext_mask)
        assert sup.edges.vals.dtype == torch.bfloat16
        assert within_ulps(sup.edges.vals, jsup.edges.vals)
        assert within_ulps(sup.diag, jsup.diag)


def test_minplus_and_next_hops_bf16_bit_identical_to_jax(batch):
    """K2's plain version on a bf16 W equals JAX's `apsp_minplus` on the
    same W bit for bit, and so do the next-hop tables (ties at the lowest
    neighbour, far more common in bf16); K6's plain version on the
    narrowed delays equals JAX's scatter, narrow and square."""
    layout, (bi, _, ti, _, _) = batch
    rng = np.random.default_rng(5)
    noise = rng.uniform(0.5, 2.0, tuple(ti.link_rates.shape)).astype(np.float32)
    delays = torch.from_numpy(noise) / ti.link_rates.float()          # fp32
    w = weight_matrix_from_link_delays(ti.adj, ti.link_index, delays)
    got = apsp_minplus(w.to(torch.bfloat16))
    want = jax.vmap(J16.wrap_apsp(None))(jnp.asarray(w.numpy()))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(f32(got), f32(want))
    assert torch.equal(got, T16.wrap_apsp(None)(w))
    np.testing.assert_array_equal(
        next_hop_table(ti.adj, got).numpy(),
        np.asarray(jax.vmap(j_next_hop)(bi.adj, want)))
    # K6's plain chain, fed the narrowed delays
    coo = tmp.apsp_minplus_coo(ti.link_ends, ti.link_mask, delays.to(torch.bfloat16),
                               ti.num_pad_nodes)
    jw = jax.vmap(lambda e, m, d: jsparse.weight_matrix_from_edges(e, m, d, ti.num_pad_nodes))(
        bi.link_ends, bi.link_mask, jnp.asarray(delays.numpy()))
    np.testing.assert_array_equal(f32(coo), f32(jax.vmap(J16.wrap_apsp(None))(jw)))
    # the plain closures agree, and squarings_run_plain counts on bf16
    d = torch.where(torch.eye(ti.num_pad_nodes, dtype=torch.bool), 0.0, w).to(torch.bfloat16)
    iters = tmp.squaring_count(ti.num_pad_nodes)
    assert torch.equal(tmp.minplus_closure_plain(d, iters),
                       tmp.minplus_closure_blocked(d, iters))
    assert 0 < tmp.squarings_run_plain(d, iters) <= d.shape[0] * iters


def test_propagate_plain_bf16_within_one_ulp_of_jax():
    """K4's plain version on bf16 x and support with fp32 accumulation
    against JAX's `_xla_propagate` (acc fp32), within one bf16 ulp."""
    bi, _, ti, _, _ = bf16_batch([synthetic(n, s) for n, s in BATCH], "sparse", seed=2)
    sup = tsparse.sparse_chebyshev_support(ti.sparse.ext, mask=ti.ext_mask,
                                           csr=ti.sparse.ext_csr)
    b, e = sup.diag.shape
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(b, e, 6)).astype(
        np.float32)).to(torch.bfloat16)
    got = tcc.chebconv_propagate(sup, x)
    jx = jnp.asarray(f32(x)).astype(jnp.bfloat16)
    want = jax.vmap(lambda r, c, v, dg, xx: _xla_propagate(r, c, v, dg, xx, jnp.float32))(
        jnp.asarray(sup.edges.rows.numpy()), jnp.asarray(sup.edges.cols.numpy()),
        jnp.asarray(f32(sup.edges.vals)).astype(jnp.bfloat16),
        jnp.asarray(f32(sup.diag)).astype(jnp.bfloat16), jx)
    assert got.dtype == torch.bfloat16 and within_ulps(got, want)
    assert within_ulps(got, tcc.chebconv_walk_plain(sup.csr.row_ptr, None, sup.edges.cols,
                                                    sup.edges.vals, sup.diag, x))


# ---- the actor and the decision legs -------------------------------------------


@pytest.mark.parametrize("name,layout", [("SCRATCH800_decay0.99", "dense"),
                                         ("SPECTRAL_K2", "dense"),
                                         ("SPECTRAL_K2", "sparse")])
def test_actor_bf16_matches_jax(name, layout):
    """The committed ChebNet under the bf16 policy (`params_from_jax`
    weights) on the same bf16 features and support: its output within
    rtol 2^-7 of JAX's, fp32; the features themselves within one ulp."""
    bi, bj, ti, tj, _ = bf16_batch([synthetic(n, s) for n, s in BATCH], layout, seed=4)
    jfeats = jax.vmap(j_features)(bi, bj)
    tfeats = build_ext_features(ti, tj)
    assert tfeats.dtype == torch.bfloat16 and within_ulps(tfeats, jfeats)
    jmodel, variables = jax_model(name, layout)
    tmodel = tcheb.load_model(name, device="cpu", layout=layout, policy=T16)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    from multihop_offload_tpu.agent.actor import default_support as j_default_support
    from multihop_offload_tpu_torch.agent.actor import default_support

    jsup = jax.vmap(lambda i: j_default_support(jmodel, i, layout=layout))(bi)
    want = jax.vmap(lambda f, s: jmodel.apply(variables, f, s))(jfeats, jsup)
    got = tmodel(torch.from_numpy(f32(jfeats)).to(torch.bfloat16),
                 default_support(tmodel, ti, layout))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    scale = float(np.abs(f32(want)).max())
    np.testing.assert_allclose(f32(got), f32(want), rtol=ACTOR_RTOL,
                               atol=ACTOR_RTOL * scale)


def _agreement(t_dst, j_dst, mask) -> float:
    m = mask.numpy()
    return float((t_dst.numpy()[m] == np.asarray(j_dst)[m]).mean())


def _close_totals(t, j, mask, rtol=PORT_VS_JAX_RTOL):
    m = mask.numpy()
    np.testing.assert_allclose(f32(t)[m], f32(j)[m], rtol=rtol, atol=0)


def test_decision_legs_bf16_match_jax(batch):
    """`baseline_policy` and `forward_env` (SPECTRAL_K2) under bf16, port
    against JAX: `baseline` and `local` decisions identical with job totals
    within 1e-2; `gnn` `dst` agreement >= 0.99 and the job totals of every
    job within 1e-2 where a request's decisions agree; every delay output
    fp32, bit-equal shortest paths on equal delays."""
    layout, (bi, bj, ti, tj, _) = batch
    jfp = FP_FN if layout == "sparse" else None
    jbl = jax.jit(jax.vmap(lambda i, j: j_baseline(
        i, j, _KEY, apsp_fn=J16.wrap_apsp(None), fp_fn=jfp, layout=layout)))(bi, bj)
    tbl = baseline_policy(ti, tj, layout=layout, precision=T16)
    np.testing.assert_array_equal(tbl.decision.dst.numpy(), np.asarray(jbl.decision.dst))
    np.testing.assert_array_equal(tbl.routes.seq_slot.numpy(), np.asarray(jbl.routes.seq_slot))
    _close_totals(tbl.job_total, jbl.delays.job_total, tj.mask)
    jloc = jax.jit(jax.vmap(lambda i, j: j_local(i, j, fp_fn=jfp, layout=layout)))(bi, bj)
    tloc = local_policy(ti, tj, layout=layout)
    _close_totals(tloc.job_total, jloc.delays.job_total, tj.mask)
    jmodel, variables = jax_model("SPECTRAL_K2", layout)
    tmodel = tcheb.load_model("SPECTRAL_K2", device="cpu", layout=layout, policy=T16)
    jout, _ = jax.jit(jax.vmap(lambda i, j: j_forward_env(
        jmodel, variables, i, j, _KEY, apsp_fn=J16.wrap_apsp(None), fp_fn=jfp,
        layout=layout)))(bi, bj)
    tout, _ = forward_env(tmodel, ti, tj, device="cpu", layout=layout, precision=T16)
    assert _agreement(tout.decision.dst, jout.decision.dst, tj.mask) >= AGREEMENT_FLOOR
    same = ~((tout.decision.dst != torch.from_numpy(np.array(jout.decision.dst)))
             & tj.mask).any(dim=1)
    assert same.any()
    _close_totals(tout.job_total[same], np.asarray(jout.delays.job_total)[same.numpy()],
                  tj.mask[same])
    for out in (tbl, tloc, tout):
        for field in (out.delays.job_total, out.delays.link_lambda, out.delays.link_mu,
                      out.decision.costs if out is not tloc else out.delays.job_total):
            assert field.dtype == torch.float32


def _gate_case(seed, dtype):
    """JAX's gate case (`tests/test_precision.py:_case`): `make_case` on
    BA(16, seed), 8 jobs, in the port."""
    from multihop_offload_tpu_torch.graphs import generators

    topo = ttopo.build_topology(generators.barabasi_albert(16, seed=seed)[0])
    pad = tinst.PadSpec(n=16, l=-(-topo.num_links // 8) * 8, s=8, j=8)
    inst, jobs = tfid.make_case(seed, topo, pad, 8, dtype=dtype, device="cpu")
    return tinst.stack_instances([inst]), tinst.stack_instances([jobs])


def test_port_bf16_gate_against_fp32_and_k1_stays_fp32(monkeypatch):
    """The port's own gate at JAX's thresholds (`tests/test_precision.py`):
    `baseline` decisions under bf16 agree with fp32 on >= 99% of jobs, the
    per-method mean job total within 0.05, fp32 within 1e-3 of float64;
    the delay outputs stay fp32 and K1's plain version receives fp32 only."""
    seen = []
    orig = tfp.fixed_point_plain

    def spy(*args, **kw):
        seen.extend(a.dtype for a in args[:4])
        return orig(*args, **kw)

    monkeypatch.setattr(tfp, "fixed_point_plain", spy)
    p32 = tprec.resolve_precision("fp32")
    agree = total = 0
    for seed in (0, 1, 2, 3):
        legs = {}
        for name, pol, dt in (("fp32", p32, torch.float32), ("bf16", T16, torch.bfloat16),
                              ("fp64", p32, torch.float64)):
            inst, jobs = _gate_case(seed, dt)
            legs[name] = ({"baseline": baseline_policy(inst, jobs, precision=pol),
                           "local": local_policy(inst, jobs)}, jobs.mask)
        m = legs["fp32"][1]
        agree += int((legs["fp32"][0]["baseline"].decision.dst
                      == legs["bf16"][0]["baseline"].decision.dst)[m].sum())
        total += int(m.sum())
        for method in ("baseline", "local"):
            t32, t16, t64 = (float(legs[k][0][method].job_total[m].double().mean())
                             for k in ("fp32", "bf16", "fp64"))
            assert abs(t16 - t32) / t32 <= TAU_RTOL_BF16, (method, t16, t32)
            assert abs(t32 - t64) / t64 <= TAU_RTOL_FP32, (method, t32, t64)
            d = legs["bf16"][0][method].delays
            assert d.job_total.dtype == d.link_mu.dtype == d.link_lambda.dtype \
                == torch.float32
    assert total >= 16 and agree / total >= AGREEMENT_FLOOR
    assert seen and set(seen) <= {torch.float32, torch.float64}
    assert torch.bfloat16 not in seen


# ---- the service, the Evaluator and the simulator under bf16 -------------------


def test_service_bf16_matches_jax():
    """Both services under `precision='bf16'` (float32 base) on the JAX
    serving tests' pool and a 12-request stream, serving the JAX service's
    weights: the same buckets, every request answered once, `dst` agreement
    >= 0.99 and the job totals of agreeing requests within 1e-2; the port
    packs bf16."""
    sizes, seed = [10, 16], 7
    common_kw = dict(seed=seed, dtype="float32", precision="bf16", serve_buckets=2,
                     serve_slots=4, serve_queue_cap=32, serve_deadline_s=60.0)
    t = [100.0]
    clock = lambda: t[0]  # noqa: E731
    jsvc, jpool = j_build_service(JConfig(model_root="/nonexistent-model-root", **common_kw),
                                  pool=jwork.case_pool(sizes, per_size=1, seed=seed),
                                  clock=clock)
    cfg = Config(**common_kw)
    model = tcheb.make_model(cfg, policy=T16)
    model.load_state_dict(tcheb.params_from_jax(jax.device_get(jsvc.executor.variables)))
    tsvc, tpool = tcli.build_service(cfg, pool=twork.case_pool(sizes, per_size=1, seed=seed),
                                     clock=clock, model=model, device="cpu")
    assert tsvc.dtype == torch.bfloat16 and tsvc.precision == T16
    jreqs = list(jwork.request_stream(jpool, 12, seed=11))
    treqs = list(twork.request_stream(tpool, 12, seed=11))
    for jr, tr in zip(jreqs, treqs):
        assert jsvc.submit(jr) and tsvc.submit(tr)
    t[0] += 0.25
    jres = {r.request_id: r for r in jsvc.drain()}
    tres = {r.request_id: r for r in tsvc.drain()}
    assert sorted(tres) == sorted(jres) == list(range(12))
    agree = total = 0
    for rid, tr in tres.items():
        jr = jres[rid]
        assert tr.bucket == jr.bucket and tr.served_by == jr.served_by == "gnn"
        agree += int((tr.dst == jr.dst).sum())
        total += tr.dst.size
        if np.array_equal(tr.dst, jr.dst):
            np.testing.assert_allclose(tr.job_total, np.asarray(jr.job_total, np.float64),
                                       rtol=PORT_VS_JAX_RTOL, atol=0)
    assert agree / total >= AGREEMENT_FLOOR


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from multihop_offload_tpu.cli.datagen import generate_dataset

    d = str(tmp_path_factory.mktemp("data") / "aco_data_ba_tiny")
    generate_dataset(d, gtype="ba", size=2, seed0=500, graph_sizes=[20, 30], verbose=False)
    return d


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_evaluator_bf16_rows_match_jax(tiny, tmp_path, layout):
    """The Evaluator under `precision='bf16'` (float32 base), port against
    JAX with the JAX harness's weights: the same rows; `baseline` and
    `local` `congest_jobs` identical and `tau` within 1e-2, `GNN` likewise
    on >= 99% of rows; the port stores its files as bf16."""
    kw = {**common(tiny, tmp_path, layout=layout), "dtype": "float32", "precision": "bf16"}
    jev = jd.Evaluator(jax_config(**kw))
    want = read_rows(jev.run(verbose=False))
    ev = td.Evaluator(Config(**{**kw, "out": str(tmp_path / "port")}), device="cpu")
    ev.model.load_state_dict(tcheb.params_from_jax(jax.device_get(jev.variables["params"])))
    assert ev.precision == T16 and ev.store == torch.bfloat16
    got = read_rows(ev.run(verbose=False))
    assert len(got) == len(want) == 4 * 4 * 3
    ok = {"GNN": 0, "baseline": 0, "local": 0}
    for g, w in zip(got, want):
        assert (g["filename"], g["Algo"], g["num_jobs"]) == (w["filename"], w["Algo"],
                                                              w["num_jobs"])
        a, b = float(g["tau"]), float(w["tau"])
        ok[g["Algo"]] += int(g["congest_jobs"] == w["congest_jobs"]
                             and abs(a - b) <= PORT_VS_JAX_RTOL * abs(b))
    rows = len(got) // 3
    assert ok["baseline"] == ok["local"] == rows
    assert ok["GNN"] >= AGREEMENT_FLOOR * rows


def test_sim_baseline_bf16_round_bit_for_bit():
    """`make_policy("baseline", precision="bf16")` in both simulators over
    one round of 200 slots under the JAX run's own draws (float64 cases, as
    the simulators keep them; only the APSP narrows): every state field and
    the round's routes identical."""
    pairs = [_case_pair(s) for s in (1, 2)]
    from multihop_offload_tpu.sim import state as jstate
    from multihop_offload_tpu_torch.sim import state as tstate

    jparams = [jstate.build_sim_params(p[1], p[2], margin=4.0) for p in pairs]
    tparams = [tstate.build_sim_params(p[4], p[5], margin=4.0) for p in pairs]
    jspec = jstate.spec_for(pairs[0][1], pairs[0][2], cap=64)
    tspec = tstate.SimSpec(*dataclasses.astuple(jspec))
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    rounds, slots = 1, 200
    jsim = jrun.FleetSim(jspec, jpol.make_policy("baseline", precision="bf16"),
                         rounds=rounds, slots_per_round=slots, dtype=jnp.float64)
    tsim = trun.FleetSim(tspec, tpol.make_policy("baseline", precision="bf16"),
                         rounds=rounds, slots_per_round=slots, dtype=torch.float64)
    jr = jsim.run(jinst.stack_instances([p[1] for p in pairs]),
                  jinst.stack_instances([p[2] for p in pairs]),
                  jinst.stack_instances(jparams), keys)
    tr = tsim.run(tinst.stack_instances([p[4] for p in pairs]),
                  tinst.stack_instances([p[5] for p in pairs]),
                  tinst.stack_instances(tparams), _run_draws(keys, jspec, rounds, slots))
    _eq_state(tr.state, jr.state, tspec.num_queues)
    for f in ("dst", "next_hop", "reach"):
        np.testing.assert_array_equal(getattr(tr.routes, f).numpy(),
                                      np.asarray(getattr(jr.routes, f)), err_msg=f)
    assert (tr.state.delivered.sum(dim=1) > 0).all()


# ---- what still waits, and what now runs under bf16 ----------------------------


def test_bf16_refusals_name_their_roadmap_items(tiny, tmp_path):
    """Under bf16 the Trainer (item 10), K3 (item 11), K4's backward in
    bf16, a TF-format checkpoint (item 4) and the data mesh (item 7) run: both drivers build under bf16 on a 2-device mesh and load the
    checkpoint into their fp32 parameters, `blocked_fw` and the APSP above
    a padded 256 return bf16, and d x of the bf16 propagate is the
    transposed walk's plain version."""
    kw = {**common(tiny, tmp_path), "dtype": "float32", "precision": "bf16"}
    for cls in (td.Evaluator, td.Trainer):
        h = cls(Config(**kw, mesh_data=2), device="cpu", devices=[torch.device("cpu")] * 2)
        assert h.n_dp == 2 and h.precision == T16
    tf_kw = {**kw, "model_root": str(tmp_path / "tf_model")}
    model_dir = Config(**tf_kw).model_dir()
    rng = np.random.default_rng(1)
    dims = [4] + [MODEL["hidden"]] * (MODEL["num_layer"] - 1) + [1]
    tree = {"params": {f"cheb_{i}": {"kernel": rng.normal(size=(MODEL["cheb_k"], a, b)),
                                     "bias": rng.normal(size=(b,))}
                       for i, (a, b) in enumerate(zip(dims, dims[1:]))}}
    save_reference_checkpoint(os.path.join(model_dir, "cp-0000.ckpt"), tree)
    with open(os.path.join(model_dir, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "cp-0000.ckpt"\n')
    for cls in (td.Evaluator, td.Trainer):
        params = cls(Config(**tf_kw), device="cpu").params()
        for k, v in tcheb.params_from_jax(tree).items():
            assert params[k].dtype == torch.float32, k
            assert torch.equal(params[k], v.to(torch.float32)), k
    for cls in (td.Evaluator, td.Trainer):
        assert cls(Config(**kw), device="cpu").precision == T16
    d = torch.zeros((1, 384, 384), dtype=torch.bfloat16)
    assert torch.equal(tmp.blocked_fw(d), d)
    w = torch.full((1, 300, 300), float("inf"), dtype=torch.bfloat16)
    sp = apsp_minplus(w)
    assert sp.dtype == torch.bfloat16 and torch.equal(
        torch.diagonal(sp, dim1=1, dim2=2), torch.zeros((1, 300), dtype=torch.bfloat16))
    _, _, ti, _, _ = bf16_batch([synthetic(12, 1)], "sparse")
    sup = tsparse.sparse_chebyshev_support(ti.sparse.ext, mask=ti.ext_mask,
                                           csr=ti.sparse.ext_csr)
    x = torch.ones(tuple(sup.diag.shape) + (4,), dtype=torch.bfloat16, requires_grad=True)
    out = tcc.chebconv_propagate(sup, x)
    (dx,) = torch.autograd.grad(out.sum(), x)
    e_ = sup.edges
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, tcc.chebconv_transpose_bf16_plain(
        e_.rows, e_.cols, e_.vals, sup.diag, torch.ones_like(x)))
