"""The APSP on the autograd tape (`apsp_minplus(early_stop=False)`, K2 and
K2's backward on the card), against `jax.grad` through the JAX
`env/apsp.py:apsp_minplus(early_stop=False)` on the CPU, float64.

On the CPU the port differentiates its plain squarings (`ops.minplus.
minplus_closure_diff_plain`); torch's `minimum` and `amin` split a tie's
cotangent as JAX's `lax.minimum` and `jnp.min` VJPs do, so the gradient
equals JAX's within 1e-12, ties and the length of the schedule included:
the gradient through a fixed schedule is not that of the shortest-path
costs, and it changes with the number of squarings even after the matrix
has stopped changing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.env import apsp as japsp
from multihop_offload_tpu.layouts import weight_matrix_from_edges as j_wfe
from multihop_offload_tpu_torch.layouts.sparse import weight_matrix_from_edges
from multihop_offload_tpu_torch.ops import minplus as mp

TOL = 1e-12


def _graph(rng, b, n, integer):
    """(b, n, n) symmetric weights: a ring plus each other pair with
    probability 3 / n, U(0.1, 5) or integers in {1, 2} (tie-heavy); +inf
    off the edges."""
    w = np.full((b, n, n), np.inf)
    for k in range(b):
        extra = np.triu(rng.uniform(size=(n, n)) < 3.0 / n, 2)
        iu, ju = np.where(extra)
        pairs = list(zip(iu, ju)) + [(i, (i + 1) % n) for i in range(n)]
        for i, j in pairs:
            v = float(rng.integers(1, 3)) if integer else rng.uniform(0.1, 5.0)
            w[k, i, j] = w[k, j, i] = v
    return w


def _jax_grad(w, c, iters):
    def loss(x):
        sp = jax.vmap(lambda m: japsp.apsp_minplus(m, num_iters=iters, early_stop=False))(x)
        return jnp.sum(jnp.where(jnp.isfinite(sp), sp * c, 0.0)), sp

    (val, sp), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w))
    return float(val), np.asarray(sp), np.asarray(g)


def _port_grad(w, c, iters):
    x = torch.tensor(w, requires_grad=True)
    sp = mp.apsp_minplus(x, num_iters=iters, early_stop=False)
    ct = torch.from_numpy(c)
    val = torch.where(torch.isfinite(sp), sp * ct, 0.0).sum()
    (g,) = torch.autograd.grad(val, x)
    return float(val.detach()), sp.detach().numpy(), g.numpy()


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("integer", [False, True], ids=["random", "ties"])
def test_gradient_equals_jax_grad(n, integer):
    rng = np.random.default_rng(100 * n + integer)
    w = _graph(rng, 2, n, integer)
    c = rng.uniform(0.5, 1.5, (2, n, n))
    iters = mp.squaring_count(n)
    jv, jsp, jg = _jax_grad(w, c, iters)
    tv, tsp, tg = _port_grad(w, c, iters)
    np.testing.assert_array_equal(tsp, jsp)
    assert abs(tv - jv) <= TOL * max(1.0, abs(jv))
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=TOL * max(1.0, np.abs(jg).max()))


def test_schedule_length_is_pinned():
    """Ten nodes, weights in {1, 2}: 4 squarings (the default schedule) and
    8 give different JAX gradients of the same distances; the port follows
    each."""
    rng = np.random.default_rng(7)
    w = _graph(rng, 2, 10, integer=True)
    c = rng.uniform(0.5, 1.5, (2, 10, 10))
    grads = {}
    for iters in (4, 5, 8):
        _, jsp, jg = _jax_grad(w, c, iters)
        _, tsp, tg = _port_grad(w, c, iters)
        np.testing.assert_array_equal(tsp, jsp)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=TOL * max(1.0, np.abs(jg).max()))
        grads[iters] = jg
    assert np.abs(grads[4] - grads[8]).max() > 1e-3  # the schedule changes the answer


def test_unreachable_pairs_give_zero_not_nan():
    """Two components: the pairs across them stay +inf, tie at every k, and
    carry a zero cotangent; the gradient is finite and equals JAX's."""
    rng = np.random.default_rng(3)
    w = _graph(rng, 2, 8, integer=True)
    w[:, :4, 4:] = w[:, 4:, :4] = np.inf
    c = rng.uniform(0.5, 1.5, (2, 8, 8))
    _, jsp, jg = _jax_grad(w, c, mp.squaring_count(8))
    _, tsp, tg = _port_grad(w, c, mp.squaring_count(8))
    assert np.isinf(tsp[:, 0, 7]).all()
    assert np.isfinite(tg).all() and np.isfinite(jg).all()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=TOL * max(1.0, np.abs(jg).max()))


def test_sparse_weight_scatter_min_gradient_matches_jax():
    """The sparse layout's W (`weight_matrix_from_edges`, a scatter-min)
    passes gradients as JAX's `.at[].min()`: to the link that set an entry,
    split evenly where values tie (a down link's +inf against the +inf the
    matrix starts from, padded links at (0, 0))."""
    rng = np.random.default_rng(11)
    n, links = 8, 12
    ends = np.stack([rng.permutation(n)[:2] for _ in range(links)]).astype(np.int32)
    ends = np.unique(np.sort(ends, axis=1), axis=0)
    num = ends.shape[0]
    ends = np.concatenate([ends, np.zeros((2, 2), np.int32)])   # two padded links
    mask = np.arange(num + 2) < num
    delays = rng.uniform(0.5, 2.0, num + 2)
    delays[1] = np.inf                                           # a down link
    c = rng.uniform(0.5, 1.5, (n, n))

    def jloss(dl):
        wm = j_wfe(jnp.asarray(ends), jnp.asarray(mask), dl, n)
        sp = japsp.apsp_minplus(wm, early_stop=False)
        return jnp.sum(jnp.where(jnp.isfinite(sp), sp * c, 0.0))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(delays)))
    x = torch.tensor(delays[None], requires_grad=True)
    wm = weight_matrix_from_edges(torch.from_numpy(ends[None]), torch.from_numpy(mask[None]),
                                  x, n)
    sp = mp.apsp_minplus(wm, early_stop=False)
    loss = torch.where(torch.isfinite(sp), sp * torch.from_numpy(c[None]), 0.0).sum()
    (tg,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(tg.numpy()[0], jg, rtol=0, atol=TOL * max(1.0, np.abs(jg).max()))


def test_early_stop_refuses_reverse_mode():
    """`early_stop=True` (the default) runs the same distances, and reverse
    mode through it raises, as through JAX's `while_loop`."""
    rng = np.random.default_rng(5)
    w = torch.tensor(_graph(rng, 2, 8, integer=False), requires_grad=True)
    fixed = mp.apsp_minplus(w, early_stop=False)
    stopped = mp.apsp_minplus(w)
    assert torch.equal(fixed.detach(), stopped.detach())
    with pytest.raises(RuntimeError, match="early_stop"):
        stopped.sum().backward()
    with pytest.raises(Exception):
        jax.grad(lambda x: jnp.sum(japsp.apsp_minplus(x)))(jnp.asarray(w.detach().numpy()[0]))
