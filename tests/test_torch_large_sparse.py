"""PyTorch port of the large path's `--sparse` (`ops/sparse.py`'s
`dense_to_coo`, `coo_matmul`, `coo_propagate`) and its other demo flags,
against the JAX package, float64 on the CPU.

`dense_to_coo` gives JAX's lists; `coo_matmul` is within 1e-12 of JAX's and
of the dense product; a ChebNet over the COO support within 1e-12 of JAX's
`model.clone(propagate=coo_propagate)` and of the port's dense model; the
demo's `forward_env` on a drawn network with the COO support gives JAX's
decisions and routes, its delays within 1e-12; `large_scale --sparse
--device cpu` prints every key the JAX demo prints.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu import ops as jops
from multihop_offload_tpu.agent.actor import default_support as j_default_support
from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu_torch import large_scale
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.graphs import cases as tcases
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.ops import sparse as tsp
from tests.test_torch_large import ROOT, _demo_draw
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

RTOL = 1e-12


def _matrix(seed, n=40, density=0.15, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return rng.normal(size=shape) * (rng.uniform(size=shape) < density)


@pytest.mark.parametrize("seed,pad", [(0, None), (1, 512), (2, None)])
def test_dense_to_coo_and_coo_matmul_match_jax(seed, pad):
    mat = _matrix(seed)
    got = tsp.dense_to_coo(mat, nnz_pad=pad)
    want = jops.dense_to_coo(mat, nnz_pad=pad)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.shape == want.shape == mat.shape
    x = np.random.default_rng(seed + 10).normal(size=(mat.shape[0], 6))
    y = tsp.coo_matmul(got, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.coo_matmul(want, x)), rtol=RTOL,
                               atol=1e-15)
    np.testing.assert_allclose(y.numpy(), mat @ x, rtol=RTOL, atol=1e-14)
    with pytest.raises(ValueError, match="exceed pad"):
        tsp.dense_to_coo(mat, nnz_pad=8)


def test_batched_coo_lists_are_each_matrix_list():
    mats = _matrix(4, batch=3)
    got = tsp.dense_to_coo(mats)
    pad = got.rows.shape[1]
    for b in range(3):
        one = jops.dense_to_coo(mats[b], nnz_pad=pad)
        np.testing.assert_array_equal(got.rows[b].numpy(), np.asarray(one.rows))
        np.testing.assert_array_equal(got.vals[b].numpy(), np.asarray(one.vals))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 40, 4)))
    np.testing.assert_allclose(tsp.coo_propagate(got, x).numpy(),
                               np.einsum("bij,bjf->bif", mats, x.numpy()), rtol=RTOL,
                               atol=1e-14)


@pytest.fixture(scope="module")
def er60():
    """A 60-node demo draw as the port's and JAX's request of one."""
    topo_j, roles, bws, rates, src, rate = _demo_draw(60, 7)
    rec = tcases.CaseRecord(topo=ttopo.build_topology(topo_j.adj), roles=roles,
                            proc_bws=bws, link_rates=rates, seed=7, name="er60")
    case = tcases.LargeCase(rec=rec, job_src=src, job_rate=rate, T=1000.0)
    ti, tj, pad = tcases.large_request(case, dtype=torch.float64, device="cpu")
    jpad = jinst.PadSpec(pad.n, pad.l, pad.s, pad.j)
    ji = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, jpad, dtype=np.float64,
                              device=False)
    jj = jinst.build_jobset(src, rate, jpad.j, dtype=np.float64, device=False)
    return ti, tj, ji, jj


def test_coo_support_forward_env_matches_jax(er60):
    """The demo's `--sparse` at K = 3: the COO support through the ChebNet
    and the decision path, against JAX's and against the dense support."""
    ti, tj, ji, jj = er60
    params = tcheb.load_weights(large_scale.MODEL)
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
    jmodel = JChebNet(num_layer=5, hidden=32, k=3, param_dtype=jnp.float64)
    jsup = jops.dense_to_coo(np.asarray(j_default_support(jmodel, ji)))
    jmodel = jmodel.clone(propagate=jops.coo_propagate)
    jo, ja = jax.jit(lambda v, i, j, s: j_forward_env(jmodel, v, i, j, jax.random.PRNGKey(1),
                                                     support=s))(variables, ji, jj, jsup)

    dense = tcheb.load_model(large_scale.MODEL, dtype=torch.float64, device="cpu")
    tmodel = tcheb.load_model(large_scale.MODEL, dtype=torch.float64, device="cpu")
    sup = large_scale.coo_support(tmodel, ti)
    np.testing.assert_array_equal(sup.rows[0].numpy(), np.asarray(jsup.rows))
    to, ta = forward_env(tmodel, ti, tj, device="cpu", support=sup)
    do, _ = forward_env(dense, ti, tj, device="cpu")
    np.testing.assert_allclose(ta.lam[0].numpy(), np.asarray(ja.lam), rtol=RTOL, atol=1e-14)
    for got in (to, do):
        np.testing.assert_array_equal(got.decision.dst[0].numpy(), np.asarray(jo.decision.dst))
        np.testing.assert_array_equal(got.routes.seq_slot[0].numpy(),
                                      np.asarray(jo.routes.seq_slot))
        np.testing.assert_allclose(got.job_total[0].numpy(), np.asarray(jo.job_total),
                                   rtol=RTOL, atol=0)


def _report(module_main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module_main(argv)
    return json.loads([x for x in out.getvalue().splitlines() if x.startswith("{")][-1])


def test_sparse_flag_prints_the_demo_keys(monkeypatch):
    args = ["--n", "60", "--seed", "7", "--k", "2", "--apsp", "xla", "--sparse",
            "--steps", "1", "--load", "0.2", "--T", "800"]
    spec = importlib.util.spec_from_file_location(
        "large_scale_demo", os.path.join(ROOT, "scripts", "large_scale_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    monkeypatch.setattr(sys, "argv", ["large_scale_demo.py"] + args)
    want = _report(lambda _: demo.main(), None)
    got = _report(large_scale.main, args + ["--device", "cpu"])
    assert set(want) <= set(got), set(want) - set(got)
    for key in ("metric", "n", "links", "ext_slots", "jobs", "gtype", "cheb_k"):
        assert got[key] == want[key], key
    assert got["sparse"] and got["apsp"] == "squaring" and want["apsp"] == "xla"
    assert "apsp_pallas_ms" not in got  # the demo times no kernel on the 'xla' route
