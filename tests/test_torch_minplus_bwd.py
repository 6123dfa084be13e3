"""K2's backward pass for pass in plain torch (`ops.minplus.
minplus_closure_bwd_plain`: the tie pass of every saved slice, then one
fused split and gather a squaring in reverse) on the stack that
`_minplus_closure_saved_plain` builds as K2 forward builds it on the card,
against autograd through the plain squarings (`minplus_closure_diff_plain`)
and `jax.grad` through the JAX `env/apsp.py:apsp_minplus(early_stop=False)`,
float64, within 1e-12 of the largest gradient entry: random weights,
tie-heavy hop weights, +inf pairs, and schedules far past the fixed point
(lead < iters), where the tie data of the fixed point serve every later
squaring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.env import apsp as japsp
from multihop_offload_tpu_torch.ops import minplus as mp
# the module runs `jax.grad` of the JAX APSP eagerly; run before
# `tests/test_obs.py` in one process it left JAX's caches so that the retrace
# counter there saw a trace after steady state
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

TOL = 1e-12


def _graph(rng, b, n, kind):
    """(b, n, n) symmetric weights, +inf off the edges: a ring plus each
    other pair with probability 3 / n; 'random' U(0.1, 5), 'ties' integers
    in {1, 2}, 'hops' all 1 (ties at nearly every k); 'split' as 'ties'
    with the first half of the nodes cut off from the rest (+inf pairs)."""
    w = np.full((b, n, n), np.inf)
    for k in range(b):
        extra = np.triu(rng.uniform(size=(n, n)) < 3.0 / n, 2)
        iu, ju = np.where(extra)
        pairs = list(zip(iu, ju)) + [(i, (i + 1) % n) for i in range(n)]
        for i, j in pairs:
            if kind == "random":
                v = rng.uniform(0.1, 5.0)
            elif kind == "hops":
                v = 1.0
            else:
                v = float(rng.integers(1, 3))
            w[k, i, j] = w[k, j, i] = v
    if kind == "split":
        h = n // 2
        w[:, :h, h:] = w[:, h:, :h] = np.inf
    return w


def _zeroed(w):
    n = w.shape[-1]
    d = torch.from_numpy(w).clone()
    d[:, torch.arange(n), torch.arange(n)] = 0.0
    return d


def _cotangent(sp, c):
    return torch.where(torch.isfinite(sp), torch.from_numpy(c), 0.0)


def _plain_bwd(w, c, iters):
    """(distances, d/dd of sum(sp * c) over the finite entries) by the
    kernel's passes in plain torch, on the stack the CPU builder saves."""
    d = _zeroed(w)
    out, stack, step_elems, lead = mp._minplus_closure_saved_plain(d, iters)
    g = mp.minplus_closure_bwd_plain(stack, step_elems, lead, _cotangent(out, c), iters)
    return out, g, lead


def _autograd_bwd(w, c, iters):
    x = _zeroed(w).requires_grad_()
    sp = mp.minplus_closure_diff_plain(x, iters)
    (g,) = torch.autograd.grad(sp, x, grad_outputs=_cotangent(sp.detach(), c))
    return sp.detach(), g


def _jax_grad(w, c, iters):
    def loss(x):
        sp = jax.vmap(lambda m: japsp.apsp_minplus(m, num_iters=iters, early_stop=False))(x)
        return jnp.sum(jnp.where(jnp.isfinite(sp), sp * c, 0.0))

    return np.asarray(jax.grad(loss)(jnp.asarray(w)))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


CASES = [  # (b, n, kind, iters beyond the default schedule)
    (2, 8, "random", 0), (3, 16, "random", 0), (2, 16, "ties", 0), (2, 13, "hops", 0),
    (2, 10, "split", 0), (3, 10, "ties", 8), (2, 7, "random", 5), (2, 12, "hops", 6),
]
IDS = [f"{b}x{n}-{kind}-plus{extra}" for b, n, kind, extra in CASES]


@pytest.mark.parametrize("b,n,kind,extra", CASES, ids=IDS)
def test_plain_backward_equals_autograd(b, n, kind, extra):
    """The kernel's passes equal autograd through the plain squarings."""
    rng = np.random.default_rng(1000 * n + b + extra)
    w = _graph(rng, b, n, kind)
    c = rng.uniform(0.5, 1.5, (b, n, n))
    iters = mp.squaring_count(n) + extra
    out, g, _ = _plain_bwd(w, c, iters)
    sp, want = _autograd_bwd(w, c, iters)
    assert torch.equal(out, sp)
    assert torch.isfinite(g).all()
    _close(g.numpy(), want.numpy())


@pytest.mark.parametrize("b,n,kind,extra", CASES, ids=IDS)
def test_plain_backward_equals_jax_grad(b, n, kind, extra):
    """... and `jax.grad` through the JAX squarings over the same schedule
    (the gradient of W: the zeroed diagonal takes none)."""
    rng = np.random.default_rng(2000 * n + b + extra)
    w = _graph(rng, b, n, kind)
    c = rng.uniform(0.5, 1.5, (b, n, n))
    iters = mp.squaring_count(n) + extra
    _, g, _ = _plain_bwd(w, c, iters)
    g[:, torch.arange(n), torch.arange(n)] = 0.0
    jg = _jax_grad(w, c, iters)
    assert np.isfinite(jg).all()
    _close(g.numpy(), jg)


def test_saved_stack_matches_the_early_stop():
    """The CPU builder's stack: the result is the plain closure's, `lead`
    counts the leading squarings that changed each matrix (the squarings
    K2's early stop runs, less the one at the fixed point), slice
    min(s, lead[b]) is squaring s's input, and the slices no squaring wrote
    hold NaN."""
    rng = np.random.default_rng(4)
    w = np.concatenate([_graph(rng, 2, 10, "ties"), _graph(rng, 1, 10, "random")])
    d = _zeroed(w)
    iters = 9
    out, stack, step_elems, lead = mp._minplus_closure_saved_plain(d, iters)
    assert torch.equal(out, mp.minplus_closure_plain(d, iters))
    assert step_elems % 64 == 0 and stack.numel() == (iters + 1) * step_elems
    mats = mp._stack_mats(stack, step_elems, 3, 10)
    for b in range(3):
        x = d[b]
        for s in range(iters):
            t = min(s, int(lead[b]))
            assert torch.equal(mats[t, b], x)
            x = mp.minplus_square_plain(x)
        t = int(lead[b])
        assert t < iters  # ten nodes are fixed after at most 4
        # squaring lead[b] runs at the fixed point, changes nothing and
        # writes its slice; the squarings after it skip
        assert torch.equal(mats[t + 1, b], mats[t, b])
        assert torch.isnan(mats[t + 2:, b]).all()
    assert mp.squarings_run_plain(d, iters) == int((lead + 1).clamp(max=iters).sum())


def test_tie_data_of_the_fixed_point_serve_later_squarings():
    """Past the fixed point every squaring's VJP reads the tie data of slice
    lead[b]: 12 squarings of 10-node rings give another gradient than 4
    (the VJP at the fixed point is not the identity), each equal to
    autograd's."""
    rng = np.random.default_rng(0)
    w = _graph(rng, 3, 10, "ties")
    c = rng.uniform(0.5, 1.5, (3, 10, 10))
    _, g12, lead = _plain_bwd(w, c, 12)
    _, g4, _ = _plain_bwd(w, c, 4)
    assert int(lead.max()) < 4
    _close(g12.numpy(), _autograd_bwd(w, c, 12)[1].numpy())
    _close(g4.numpy(), _autograd_bwd(w, c, 4)[1].numpy())
    assert not torch.allclose(g12, g4)


def test_unreachable_pairs_give_zero_not_nan():
    """+inf pairs tie at every k (cnt = N) and carry a zero cotangent; a
    nonzero cotangent there still gives a finite gradient, as autograd's."""
    rng = np.random.default_rng(3)
    w = _graph(rng, 2, 8, "split")
    c = rng.uniform(0.5, 1.5, (2, 8, 8))
    out, g, _ = _plain_bwd(w, c, 3)
    assert np.isinf(out[:, 0, 7].numpy()).all()
    assert torch.isfinite(g).all()
    d = _zeroed(w)
    _, stack, step_elems, lead = mp._minplus_closure_saved_plain(d, 3)
    ones = torch.ones_like(d)
    g1 = mp.minplus_closure_bwd_plain(stack, step_elems, lead, ones, 3)
    x = d.clone().requires_grad_()
    (want,) = torch.autograd.grad(mp.minplus_closure_diff_plain(x, 3), x, grad_outputs=ones)
    assert torch.isfinite(g1).all()
    _close(g1.numpy(), want.numpy())


@pytest.mark.parametrize("diag", [0.25, 3.0])
def test_plain_backward_with_a_positive_diagonal_equals_autograd(diag):
    """A positive diagonal (not what `apsp_minplus` hands over, but what
    `minplus_closure_diff` takes): M may exceed D, and G's direct share
    takes its D < M side; the passes still equal autograd."""
    rng = np.random.default_rng(int(diag * 8))
    w = _graph(rng, 2, 12, "ties")
    d = torch.from_numpy(w).clone()
    d[:, torch.arange(12), torch.arange(12)] = diag
    c = rng.uniform(0.5, 1.5, (2, 12, 12))
    iters = mp.squaring_count(12) + 2
    out, stack, step_elems, lead = mp._minplus_closure_saved_plain(d, iters)
    g = mp.minplus_closure_bwd_plain(stack, step_elems, lead, _cotangent(out, c), iters)
    x = d.clone().requires_grad_()
    sp = mp.minplus_closure_diff_plain(x, iters)
    (want,) = torch.autograd.grad(sp, x, grad_outputs=_cotangent(sp.detach(), c))
    assert torch.equal(out, sp.detach())
    _close(g.numpy(), want.numpy())


def test_bwd_launches_counts_the_tie_pass_and_the_chain():
    assert [mp.bwd_launches(i) for i in (0, 1, 4, 7)] == [0, 2, 5, 8]


def test_cuda_wrapper_checks_its_operands_before_building():
    """Mismatched operands raise before any build (no nvcc needed)."""
    d = _zeroed(_graph(np.random.default_rng(1), 2, 6, "random")).float()
    _, stack, step_elems, lead = mp._minplus_closure_saved_plain(d, 3)
    g = torch.ones_like(d)
    with pytest.raises(ValueError, match="do not match"):
        mp.minplus_closure_bwd_cuda(stack, step_elems, lead.long(), g, 3)
    with pytest.raises(ValueError, match="do not match"):
        mp.minplus_closure_bwd_cuda(stack[:-1], step_elems, lead, g, 3)
    with pytest.raises(ValueError, match="must be"):
        mp.minplus_closure_bwd_cuda(stack, step_elems, lead, g[0], 3)
