"""PyTorch port of `fp_impl` and the sparse layout's segment-sum fixed point
against the JAX package, float64 on the CPU.

`resolve_fixed_point(impl, l)` gives JAX's path words; the JAX side runs
its Pallas kernel in interpret mode (its own tests' way off a TPU), so its
`'pallas'` path is 'pallas'.  `'auto'` differs where the port's K1 reaches
further than JAX's measured TPU win: at a padded L in (256, 928] the port
takes K1 ('pallas'), JAX the XLA scan ('xla').  Under every value, on both
layouts, mu is within 1e-12 of the JAX function on the same path (the
sparse layout with no core: segment-sum against segment-sum), and the
decisions, routes and hop counts are bit-identical; the Evaluator's rows
under each value match JAX's Evaluator's (`assert_rows_equal`).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.policy import forward_env as j_forward_env
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.env.queueing import interference_fixed_point as j_ifp
from multihop_offload_tpu.ops import fixed_point as jfp
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env.queueing import interference_fixed_point
from multihop_offload_tpu_torch.ops import fixed_point as tfp
from multihop_offload_tpu_torch.ops import sparse as tsp
from tests.test_torch_drivers import (  # noqa: F401
    assert_rows_equal,
    common,
    port_evaluator,
    read_rows,
    tiny,
)
from tests.test_torch_layouts import models, paired_batch, synthetic
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

RTOL = 1e-12
IMPLS = ("xla", "pallas", "auto")
_KEY = jax.random.PRNGKey(0)


def _jax_fp(impl, l):
    return jfp.resolve_fixed_point(impl, l, interpret=True)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("l", [40, 216, 256, 300, 496, 928, 936, 7696])
def test_path_words_match_jax(impl, l):
    fn, path = tfp.resolve_fixed_point(impl, l)
    _, jpath = _jax_fp(impl, l)
    l_pad = -(-l // 128) * 128
    if impl == "auto" and 256 < l_pad and l <= 928:
        # the port's device pick: K1 wherever its shared memory holds A
        assert (path, jpath) == ("pallas", "xla")
    elif impl == "pallas" and l > 928:
        # above K1's cap the scan, reported as JAX reports its fallback
        assert (path, jpath) == ("xla-fallback", "pallas")
    else:
        assert path == jpath
    assert (fn is None) == (path == "xla")
    with pytest.raises(ValueError, match="fp_impl must be xla\\|pallas\\|auto"):
        tfp.resolve_fixed_point("bogus", l)


@pytest.fixture(scope="module", params=["dense", "sparse"])
def batch(request):
    layout = request.param
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in ((14, 1), (22, 2))],
                                       layout, per_network=2)
    return layout, bi, bj, ti, tj, pad


@pytest.mark.parametrize("impl", IMPLS)
def test_fixed_point_matches_jax_on_its_path(batch, impl):
    layout, bi, bj, ti, tj, pad = batch
    rng = np.random.default_rng(7)
    lam = rng.uniform(0.0, 40.0, ti.link_rates.shape) * ti.link_mask.numpy()
    fn, path = tfp.resolve_fixed_point(impl, pad.l)
    jfn, _ = _jax_fp(impl, pad.l)
    if impl == "auto":
        # JAX's off-TPU auto is the XLA scan; hold the port's K1 to the
        # JAX kernel on the path the port took
        jfn = _jax_fp("pallas" if path == "pallas" else "xla", pad.l)[0]
    got = interference_fixed_point(ti, torch.from_numpy(lam), fp_fn=fn, layout=layout)
    want = jax.jit(jax.vmap(lambda i, x: j_ifp(i, x, fp_fn=jfn, layout=layout)))(bi, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    if layout == "sparse" and fn is None:
        # the segment-sum: the same bits on a second call, and never reads
        # the dense conflict matrix
        blank = dataclasses.replace(ti, adj_conflict=torch.full_like(ti.adj_conflict,
                                                                     float("nan")))
        again = interference_fixed_point(blank, torch.from_numpy(lam), layout=layout)
        assert torch.equal(again, got)


@pytest.mark.parametrize("impl", IMPLS)
def test_decisions_routes_and_hops_match_jax(batch, impl):
    layout, bi, bj, ti, tj, pad = batch
    jmodel, variables, tmodel = models(2, 3, 8, pad, layout)
    fn, path = tfp.resolve_fixed_point(impl, pad.l)
    jfn = _jax_fp("pallas" if path == "pallas" else "xla", pad.l)[0]
    keys = jax.random.split(_KEY, bi.adj.shape[0])
    jo, ja = jax.jit(jax.vmap(lambda i, j, k: j_forward_env(
        jmodel, variables, i, j, k, fp_fn=jfn, layout=layout)))(bi, bj, keys)
    to, ta = forward_env(tmodel, ti, tj, device="cpu", layout=layout, fp_fn=fn)
    for f in ("dst", "nhop", "seq_slot", "seq_active"):
        np.testing.assert_array_equal(getattr(to.routes, f).numpy(),
                                      np.asarray(getattr(jo.routes, f)), err_msg=f)
    np.testing.assert_array_equal(to.decision.dst.numpy(), np.asarray(jo.decision.dst))
    np.testing.assert_allclose(ta.link_delay.numpy(), np.asarray(ja.link_delay),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(to.job_total.numpy(), np.asarray(jo.job_total),
                               rtol=1e-10, atol=0)
    # the next-hop tables over the actors' link delays
    from multihop_offload_tpu.env import apsp as japsp
    from multihop_offload_tpu_torch.env.policies import next_hops, shortest_paths

    sp = shortest_paths(ti, ta.link_delay, layout)
    jnh = jax.jit(jax.vmap(lambda i, d: japsp.next_hop_table(
        i.adj, japsp.apsp_minplus(japsp.weight_matrix_from_link_delays(
            i.adj, i.link_index, d)))))(bi, ja.link_delay)
    np.testing.assert_array_equal(next_hops(ti, sp, layout).numpy(), np.asarray(jnh))


def test_coo_matmul_has_the_same_bits_and_gradient_as_a_dense_product():
    """The row-run reduction: a batched COO product against the dense
    product within 1e-12, twice the same bits, and its backward (the
    column runs) equal to the dense transpose's."""
    rng = np.random.default_rng(3)
    mats = rng.uniform(size=(2, 30, 30)) * (rng.uniform(size=(2, 30, 30)) < 0.2)
    coo = tsp.dense_to_coo(mats, round_to=16)
    x = torch.from_numpy(rng.normal(size=(2, 30, 5))).requires_grad_()
    y = tsp.coo_matmul(coo, x)
    assert torch.equal(y, tsp.coo_matmul(coo, x))
    dense = torch.from_numpy(mats)
    np.testing.assert_allclose(y.detach().numpy(), (dense @ x).detach().numpy(),
                               rtol=RTOL, atol=1e-15)
    g = torch.from_numpy(rng.normal(size=(2, 30, 5)))
    (gx,) = torch.autograd.grad(y, x, g)
    np.testing.assert_allclose(gx.numpy(), (dense.transpose(1, 2) @ g).numpy(),
                               rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("impl", IMPLS)
def test_evaluator_rows_match_jax_under_each_value(tiny, tmp_path, impl):
    """The sparse Evaluator under each `fp_impl` against JAX's under the
    same value (JAX's 'pallas' off a TPU is its kernel's XLA reference, the
    dense scan, as the port's K1; its 'auto' the segment-sum)."""
    kw = common(tiny, tmp_path, layout="sparse", fp_impl=impl)
    jev = jd.Evaluator(JConfig(**kw, mesh_data=1))
    want = read_rows(jev.run(files_limit=1, verbose=False))
    ev = port_evaluator(Config(**{**kw, "out": str(tmp_path / "port")}),
                        jev.variables["params"])
    assert ev.fp_path == tfp.resolve_fixed_point(impl, ev.data.pad.l)[1]
    assert jev.fp_path == jfp.resolve_fixed_point(impl, jev.data.pad.l)[1]
    assert_rows_equal(read_rows(ev.run(files_limit=1, verbose=False)), want)

