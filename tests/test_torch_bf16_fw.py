"""PyTorch port, K3 (the blocked Floyd-Warshall APSP) under the bf16
precision policy against the JAX package on the CPU.

A decision path under bf16 whose padded N is in (256, 2048] narrows W to
bf16 before the blocked FW (JAX `precision.py:wrap_apsp` over
`apsp_minplus_pallas`).  Bars:

* K3's plain version in bf16 against the TPU kernel `blocked_fw_call` in
  interpret mode on the same bf16 input, bit for bit, at tile 8 and at the
  128 tile; `apsp_minplus_pallas` (the `'pallas'` route) on a bf16 W at
  N = 300 (padded to 384) against
  `apsp_minplus_pallas(w.astype(bf16), interpret=True)`, bit for bit; the
  sparse chain (K6's plain version on the narrowed delays) the same;
* on the 300-node demo network (`tests/test_torch_large.py`'s draw)
  stored as bf16: `baseline_policy` under bf16 on the `'pallas'` route,
  dense and sparse, against
  the JAX one given `wrap_apsp(partial(apsp_minplus_pallas,
  interpret=True))`: decisions, routes and next hops identical, job
  totals within 1e-2 relative; `forward_env` with the demo's K=3 initial
  weights: `dst` agreement >= 0.99, job totals within 1e-2 on the
  requests whose decisions agree.

The JAX side of the policies is compiled with excess precision off
(`strict_jit`), as in `tests/test_torch_bf16_backward.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.layouts import sparse as jsparse
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.ops.minplus import apsp_minplus_pallas, blocked_fw_call
from multihop_offload_tpu_torch import large_scale
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.env.policies import baseline_policy
from multihop_offload_tpu_torch.graphs import cases as tcases
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.ops import minplus as tmp
from tests.test_torch_bf16_backward import bits, strict_jit
from tests.test_torch_large import _demo_draw
from tests.test_torch_ops import _weights
from tests.test_torch_precision import J16, T16, f32

RTOL = 1e-2
AGREEMENT_FLOOR = 0.99
BF = jnp.bfloat16
_KEY = jax.random.PRNGKey(0)
_BF16_PALLAS_APSP = J16.wrap_apsp(functools.partial(apsp_minplus_pallas, interpret=True))


def _fw_input(seed, b, n, p):
    """(b, n, n) asymmetric distances, an edge with probability p, U(0.1,
    5), +inf elsewhere, zero diagonal, narrowed to bf16 (torch and JAX)."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.uniform(size=(b, n, n)) < p, rng.uniform(0.1, 5.0, (b, n, n)),
                 np.inf).astype(np.float32)
    for k in range(b):
        np.fill_diagonal(d[k], 0.0)
    t = torch.from_numpy(d).to(torch.bfloat16)
    return t, jnp.asarray(f32(t)).astype(BF)


@pytest.mark.parametrize("b,n,tile,p", [(2, 32, 8, 0.4), (3, 40, 8, 0.15), (1, 24, 8, 1.0),
                                        (1, 256, 128, 6 / 256)])
def test_blocked_fw_plain_bf16_bit_identical_to_jax(b, n, tile, p):
    """`blocked_fw_plain` on bf16 against `blocked_fw_call(..., interpret=True)`
    on bf16; it is not the float32 closure narrowed once."""
    d, jd = _fw_input(n, b, n, p)
    got = tmp.blocked_fw_plain(d, tile=tile)
    want = blocked_fw_call(jd, tile=tile, interpret=True)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(bits(got), bits(want))
    if p < 1.0:  # paths of several hops: the roundings along them show
        wide = tmp.blocked_fw_plain(d.float(), tile=tile).to(torch.bfloat16)
        assert not torch.equal(got, wide)


def test_apsp_bf16_at_n300_bit_identical_to_jax_pallas():
    """N = 300 takes the blocked FW (padded to 384) under bf16 as in
    float32, on the CPU through `blocked_fw`'s plain version: dense
    `apsp_minplus_pallas` and the sparse chain (`apsp_minplus_coo` on the narrowed
    delays: W built at the 128-rounded N) equal JAX's narrowed
    `apsp_minplus_pallas` bit for bit."""
    w = _weights(np.random.default_rng(11), 1, 300, 4.0 / 300).astype(np.float32)
    assert tmp.apsp_path(300) == "blocked-fw" and tmp.padded_n(300) == 384
    got = tmp.apsp_minplus_pallas(torch.from_numpy(w).to(torch.bfloat16))
    want = apsp_minplus_pallas(jnp.asarray(w).astype(BF), interpret=True)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(bits(got), bits(want))
    assert torch.equal(got, T16.wrap_apsp(tmp.apsp_minplus_pallas)(torch.from_numpy(w)))
    iu, ju = np.nonzero(np.triu(np.isfinite(w[0]), 1))
    ends = torch.from_numpy(np.stack([iu, ju], 1).astype(np.int32))[None]
    mask = torch.ones((1, iu.size), dtype=torch.bool)
    delays = torch.from_numpy(w[0][iu, ju][None].copy())
    coo = tmp.apsp_minplus_coo(ends, mask, delays.to(torch.bfloat16), 300)
    jw = jsparse.weight_matrix_from_edges(jnp.asarray(ends[0].numpy()),
                                          jnp.asarray(mask[0].numpy()),
                                          jnp.asarray(delays[0].numpy()), 300)
    np.testing.assert_array_equal(bits(coo[0]), bits(_BF16_PALLAS_APSP(jw)))


@pytest.fixture(scope="module")
def er300_bf16():
    """The 300-node demo draw of `tests/test_torch_large.py`, one request,
    built by both packages at bf16 storage, dense and sparse."""
    topo_j, roles, bws, rates, src, rate = _demo_draw(300, 5)
    topo_t = ttopo.build_topology(topo_j.adj)
    rec = tcases.CaseRecord(topo=topo_t, roles=roles, proc_bws=bws, link_rates=rates,
                            seed=5, name="er300")
    out = {}
    for layout in ("dense", "sparse"):
        pad = tcases.pad_for([rec], layout)
        jpad = jinst.PadSpec(pad.n, pad.l, pad.s, pad.j, pad.enn, pad.cnn)
        idt = np.int16 if layout == "sparse" else np.int32
        ti = tinst.build_instance(topo_t, roles, bws, rates, 1000.0, pad, torch.bfloat16,
                                  device="cpu", layout=layout)
        tj = tinst.build_jobset(src, rate, pad.j, dtype=torch.bfloat16, device="cpu",
                                index_dtype=idt)
        ji = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, jpad,
                                  dtype=J16.storage_dtype, device=False, layout=layout)
        jj = jinst.build_jobset(src, rate, jpad.j, dtype=J16.storage_dtype, device=False,
                                index_dtype=idt)
        out[layout] = (tinst.stack_instances([ti]), tinst.stack_instances([tj]),
                       jinst.stack_instances([ji]), jinst.stack_instances([jj]), pad)
    return out


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_baseline_bf16_at_padded_384_matches_jax(er300_bf16, layout):
    ti, tj, bi, bj, pad = er300_bf16[layout]
    assert tmp.apsp_path(pad.n) == "blocked-fw"
    want = strict_jit(jax.vmap(lambda i, j: j_baseline(
        i, j, _KEY, apsp_fn=_BF16_PALLAS_APSP, layout=layout)), bi, bj)
    got = baseline_policy(ti, tj, layout=layout, precision=T16, apsp_impl="pallas")
    for f in ("dst", "is_local"):
        np.testing.assert_array_equal(getattr(got.decision, f).numpy(),
                                      np.asarray(getattr(want.decision, f)), err_msg=f)
    for f in ("seq_slot", "seq_active", "nhop"):
        np.testing.assert_array_equal(f32(getattr(got.routes, f)),
                                      f32(getattr(want.routes, f)), err_msg=f)
    m = tj.mask.numpy()
    assert got.job_total.dtype == torch.float32 and m.sum() > 100
    np.testing.assert_allclose(f32(got.job_total)[m], f32(want.delays.job_total)[m],
                               rtol=RTOL, atol=0)


def test_forward_env_bf16_at_padded_384_matches_jax(er300_bf16):
    ti, tj, bi, bj, _ = er300_bf16["dense"]
    params = tcheb.load_weights(large_scale.MODEL)
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    jmodel = JChebNet(num_layer=5, hidden=32, k=3, param_dtype=jnp.float32,
                      compute_dtype=BF, accum_dtype=jnp.float32)
    tmodel = tcheb.load_model(large_scale.MODEL, device="cpu", policy=T16)
    jout, _ = strict_jit(jax.vmap(lambda i, j: j_forward_env(
        jmodel, variables, i, j, _KEY, apsp_fn=_BF16_PALLAS_APSP)), bi, bj)
    tout, _ = forward_env(tmodel, ti, tj, device="cpu", precision=T16, apsp_impl="pallas")
    m = tj.mask.numpy()
    tdst, jdst = tout.decision.dst.numpy(), np.asarray(jout.decision.dst)
    assert (tdst[m] == jdst[m]).mean() >= AGREEMENT_FLOOR
    if (tdst[m] == jdst[m]).all():
        np.testing.assert_allclose(f32(tout.job_total)[m], f32(jout.delays.job_total)[m],
                                   rtol=RTOL, atol=0)
