"""PyTorch port, the backward under the bf16 precision policy against the
JAX package on the CPU: K4's transposed walk in bf16 and `forward_backward`.

* K4's bf16 transposed propagate (`ops.chebconv.chebconv_transpose_bf16_plain`,
  what the card's transposed walk computes) against `jax.vjp` of the JAX
  `_xla_propagate` with bf16 x and fp32 accumulation, bit for bit: on the
  sparse support of a synthetic batch, on random COO lists with pads, and
  through `chebconv_propagate`'s autograd.  JAX's VJP scatter-adds the bf16
  products in bf16, one rounding an add, where its forward sums in fp32.
* `forward_backward` under `precision='bf16'` (float32 base, a random
  3-layer K=2 ChebNet of width 8) against `jax.vmap` of JAX
  `forward_backward` with the JAX policy's `wrap_apsp`, dense and sparse:
  `dst` agreement >= 0.99, routes and hop counts identical where `dst`
  agrees, losses within 1e-2 relative, and each episode's gradient within
  1e-4 of each leaf's largest entry (measured: 4.2e-6) with cosine >=
  0.999.

The JAX side is compiled with XLA's `xla_allow_excess_precision` off
(`strict_jit`), so that it keeps every bf16 rounding its program writes:
with it on (XLA's default) the CPU compiler drops some, and on the sparse
batch here JAX's jitted actor then differs from its own eager actor by up
to 9% in the GNN's output, where the port matches the eager one to 5e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.train_step import forward_backward as j_forward_backward
from multihop_offload_tpu.layouts import sparse as jsparse
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.ops.chebconv import _xla_propagate
from multihop_offload_tpu_torch.agent.train_step import episode_grad_norms, forward_backward
from multihop_offload_tpu_torch.layouts import sparse as tsparse
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.ops import chebconv as tcc
from tests.test_torch_layouts import FP_FN, synthetic
from tests.test_torch_precision import BATCH, J16, T16, bf16_batch, f32

STRICT = {"xla_allow_excess_precision": False}
LOSS_RTOL = 1e-2
GRAD_GAP = 1e-4       # of each leaf's largest entry, per episode (measured 4.2e-6)
GRAD_COSINE = 0.999
AGREEMENT_FLOOR = 0.99
BF = jnp.bfloat16


def strict_jit(fn, *args):
    """`jax.jit(fn)(*args)` compiled with excess precision off: every bf16
    rounding of the program kept."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


@pytest.fixture
def strict_xla(monkeypatch):
    """Every ahead-of-time compile (`Lowered.compile`, which the JAX
    drivers' programs go through) with excess precision off."""
    orig = jax.stages.Lowered.compile

    def compile_strict(self, compiler_options=None, **kw):
        return orig(self, compiler_options={**STRICT, **(compiler_options or {})}, **kw)

    monkeypatch.setattr(jax.stages.Lowered, "compile", compile_strict)


def bits(x) -> np.ndarray:
    """The bf16 bit patterns of a JAX or torch bf16 array (as fp32 bits)."""
    return f32(x).view(np.uint32)


def jax_transpose(rows, cols, vals, diag, x, g):
    """d x of `_xla_propagate` (bf16 x, fp32 accumulation) by `jax.vjp`,
    over a batch of lists."""
    def one(r, c, v, d, xx, gg):
        _, vjp = jax.vjp(lambda xx: _xla_propagate(r, c, v, d, xx, jnp.float32), xx)
        return vjp(gg)[0]

    return jax.vmap(one)(*(jnp.asarray(a) for a in (rows, cols)),
                         *(jnp.asarray(f32(a)).astype(BF) for a in (vals, diag, x, g)))


def _random_lists(seed, b, n, nnz, pads):
    """(B, nnz) random COO lists over n nodes in no order, repeated entries
    included, the last `pads` entries (0, 0, 0)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, (b, nnz)).astype(np.int32)
    cols = rng.integers(0, n, (b, nnz)).astype(np.int32)
    vals = rng.normal(size=(b, nnz)).astype(np.float32)
    rows[:, nnz - pads:] = cols[:, nnz - pads:] = 0
    vals[:, nnz - pads:] = 0.0
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return (torch.from_numpy(rows), torch.from_numpy(cols), bf(vals),
            bf(rng.normal(size=(b, n)).astype(np.float32)))


@pytest.mark.parametrize("b,n,nnz,pads,f", [(2, 300, 4000, 100, 32), (3, 40, 500, 0, 4),
                                            (1, 17, 60, 59, 6)])
def test_transpose_bf16_plain_bit_identical_to_jax_vjp_random(b, n, nnz, pads, f):
    rows, cols, vals, diag = _random_lists(n, b, n, nnz, pads)
    rng = np.random.default_rng(nnz)
    x, g = (torch.from_numpy(rng.normal(size=(b, n, f)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    got = tcc.chebconv_transpose_bf16_plain(rows, cols, vals, diag, g)
    want = jax_transpose(rows, cols, vals, diag, x, g)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(bits(got), bits(want))
    if nnz - pads >= 100:  # it is not the forward's single rounding of an fp32 sum
        once = tcc.chebconv_propagate_plain(cols, rows, vals, diag, g)
        assert int((bits(once) != bits(want)).sum()) >= 0.1 * once.numel()


@pytest.mark.parametrize("f", [4, 32])
def test_transpose_bf16_bit_identical_to_jax_on_a_support(f):
    """On the sparse Chebyshev support of a synthetic batch (pads, CSR
    index): the plain version, and d x through `chebconv_propagate`'s
    autograd on the CPU, equal JAX's VJP bit for bit."""
    _, _, ti, _, _ = bf16_batch([synthetic(n, s) for n, s in BATCH], "sparse", seed=3)
    sup = tcheb.cast_support(tsparse.sparse_chebyshev_support(
        ti.sparse.ext, mask=ti.ext_mask, csr=ti.sparse.ext_csr), torch.bfloat16)
    e_ = sup.edges
    b, e = sup.diag.shape
    rng = np.random.default_rng(f)
    x, g = (torch.from_numpy(rng.normal(size=(b, e, f)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    want = jax_transpose(e_.rows, e_.cols, e_.vals, sup.diag, x, g)
    got = tcc.chebconv_transpose_bf16_plain(e_.rows, e_.cols, e_.vals, sup.diag, g)
    np.testing.assert_array_equal(bits(got), bits(want))
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tcc.chebconv_propagate(sup, xg), xg, g)
    assert dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(dx), bits(want))


def small_models(pad, layout):
    """A random 3-layer K=2 width-8 ChebNet under the bf16 policy in both
    packages, with the same fp32 weights."""
    prop = jsparse.make_sparse_propagate(jnp.float32) if layout == "sparse" else None
    jmodel = JChebNet(num_layer=3, hidden=8, k=2, param_dtype=jnp.float32,
                      compute_dtype=BF, accum_dtype=jnp.float32, propagate=prop)
    params = jax.device_get(JChebNet(num_layer=3, hidden=8, k=2, param_dtype=jnp.float32).init(
        jax.random.PRNGKey(2), jnp.zeros((pad.e, 4)), jnp.zeros((pad.e, pad.e))))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    tmodel = tcheb.ChebNet(num_layer=3, hidden=8, k=2, dtype=torch.float32,
                           propagate=tcheb.layout_propagate(layout),
                           compute_dtype=torch.bfloat16, accum_dtype=torch.float32)
    tmodel.load_state_dict(tcheb.params_from_jax(variables))
    return jmodel, variables, tmodel


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_forward_backward_bf16_matches_jax(layout):
    bi, bj, ti, tj, pad = bf16_batch([synthetic(n, s) for n, s in BATCH], layout, seed=6)
    jmodel, variables, tmodel = small_models(pad, layout)
    jfp = FP_FN if layout == "sparse" else None
    jout = strict_jit(jax.vmap(lambda i, j: j_forward_backward(
        jmodel, variables, i, j, jax.random.PRNGKey(0), fp_fn=jfp, layout=layout,
        apsp_fn=J16.wrap_apsp(None))), bi, bj)
    tout = forward_backward(tmodel, ti, tj, layout=layout, device="cpu", precision=T16)
    mask = tj.mask.numpy()
    tdst, jdst = tout.dst.numpy(), np.asarray(jout.dst)
    assert (tdst[mask] == jdst[mask]).mean() >= AGREEMENT_FLOOR
    same = ~((tdst != jdst) & mask).any(axis=1)  # episodes whose decisions all agree
    assert same.any()
    for f in ("seq_slot", "seq_active", "nhop"):
        np.testing.assert_array_equal(f32(getattr(tout.routes, f))[same],
                                      f32(getattr(jout.routes, f))[same], err_msg=f)
    for name in ("loss_critic", "loss_mse"):
        t, j = getattr(tout, name), getattr(jout, name)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(f32(t)[same], f32(j)[same], rtol=LOSS_RTOL, atol=0,
                                   err_msg=name)
    for name, g in tout.grads.items():
        assert g.dtype == torch.float32, name
        _, i, leaf = name.split(".")
        want = np.asarray(jout.grads["params"][f"cheb_{i}"][leaf], np.float32)
        for ep in np.flatnonzero(same):
            a, w = g[ep].numpy().ravel(), want[ep].ravel()
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(a - w).max() <= GRAD_GAP * scale, (name, ep)
            cos = float(a @ w) / max(np.linalg.norm(a) * np.linalg.norm(w), 1e-30)
            assert cos >= GRAD_COSINE, (name, ep, cos)
    assert episode_grad_norms(tout.grads).dtype == torch.float32
