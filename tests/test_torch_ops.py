"""PyTorch port, ops/ and env/apsp.py: the plain versions of K1 and K2
against the JAX package, in float64 on the CPU.

K1 (fixed point) within 1e-12 relative of `fixed_point_pallas` (interpret
mode) and `interference_fixed_point_raw`; K2 (min-plus APSP) bit-identical
to `apsp_minplus_pallas` (interpret mode) and `apsp_minplus`; the next-hop
table and hop counts exact.  The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.env import apsp as japsp
from multihop_offload_tpu.env.queueing import interference_fixed_point_raw
from multihop_offload_tpu.ops.fixed_point import fixed_point_pallas
from multihop_offload_tpu.ops.minplus import apsp_minplus_pallas
from multihop_offload_tpu_torch.env import apsp as tapsp
from multihop_offload_tpu_torch.ops import fixed_point as tfp
from multihop_offload_tpu_torch.ops import minplus as tmp


@pytest.fixture(autouse=True, scope="module")
def clear_jax_caches_after_module():
    """Leave JAX's caches as a fresh process has them once the module ends.

    The module runs the JAX reference eagerly at length, which fills JAX's
    cache of eager primitives; a module run after it in the same process
    then sees a primitive it had just run traced again (in
    `tests/test_obs.py`, a retrace counted after steady state).  Other
    `test_torch_*` modules that do the same take this fixture by import."""
    yield
    jax.clear_caches()


def _conflict_batch(rng, b, l, p=0.1):
    a = np.triu((rng.uniform(size=(b, l, l)) < p).astype(np.float64), 1)
    a = a + np.swapaxes(a, 1, 2)
    return (a, rng.uniform(30, 70, (b, l)).round(), a.sum(1),
            rng.uniform(0, 60, (b, l)))


def _weights(rng, b, n, p):
    w = np.full((b, n, n), np.inf)
    for k in range(b):
        iu, ju = np.where(np.triu(rng.uniform(size=(n, n)) < p, 1))
        vals = rng.uniform(0.1, 5.0, iu.size)
        w[k, iu, ju] = w[k, ju, iu] = vals
    return w


@pytest.mark.parametrize("b,l", [(1, 24), (3, 72), (2, 130)])
def test_fixed_point_plain_matches_jax(b, l):
    rng = np.random.default_rng(l)
    args = _conflict_batch(rng, b, l)
    got = tfp.fixed_point(*map(torch.from_numpy, args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    pallas = np.asarray(fixed_point_pallas(*jargs, 10, True))
    raw = np.asarray(interference_fixed_point_raw(*jargs, 10))
    np.testing.assert_allclose(got, pallas, rtol=1e-12)
    np.testing.assert_allclose(got, raw, rtol=1e-12)
    # padded links (rate 1, cf 0, lambda 0, zero rows) stay inert: mu = 1
    pad = [np.pad(x, ((0, 0), (0, 8)) + ((0, 8),) * (x.ndim - 2),
                  constant_values=c) for x, c in zip(args, (0, 1, 0, 0))]
    got_p = tfp.fixed_point(*map(torch.from_numpy, pad)).numpy()
    np.testing.assert_array_equal(got_p[:, :l], got)
    np.testing.assert_array_equal(got_p[:, l:], 1.0)


# a service bucket and the 256-node rung: shapes K1 is timed at on the card.
# (The padding check of the test above is not made here: at L = 496 the
# float64 matmul sums 504 columns in another order than 496, an ulp apart.)
@pytest.mark.parametrize("b,l", [(16, 96), (4, 496)])
def test_fixed_point_plain_matches_jax_at_path_shapes(b, l):
    args = _conflict_batch(np.random.default_rng(l), b, l, p=0.03)
    got = tfp.fixed_point(*map(torch.from_numpy, args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    np.testing.assert_allclose(got, np.asarray(fixed_point_pallas(*jargs, 10, True)),
                               rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(interference_fixed_point_raw(*jargs, 10)),
                               rtol=1e-12)


@pytest.mark.parametrize("b,n,p", [(2, 30, 0.15), (3, 64, 0.06), (1, 150, 0.03)])
def test_apsp_plain_bit_identical_to_jax(b, n, p):
    rng = np.random.default_rng(n)
    w = _weights(rng, b, n, p)
    got = tapsp.apsp_minplus(torch.from_numpy(w)).numpy()
    xla = np.asarray(jax.vmap(japsp.apsp_minplus)(jnp.asarray(w)))
    pallas = np.asarray(apsp_minplus_pallas(jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    w32 = w.astype(np.float32)
    got32 = tapsp.apsp_minplus(torch.from_numpy(w32)).numpy()
    np.testing.assert_array_equal(
        got32, np.asarray(jax.vmap(japsp.apsp_minplus)(jnp.asarray(w32))))


# N at the edges of K2's tile plans (`csrc/minplus.cu`), all on the squaring
# path (257 is on the blocked FW's, held at 300 below)
@pytest.mark.parametrize("b,n", [(3, 1), (3, 2), (7, 8), (7, 9), (4, 55), (4, 57),
                                 (4, 111), (4, 113), (2, 255)])
def test_apsp_plain_bit_identical_to_jax_at_tile_edges(b, n):
    assert tmp.apsp_path(n) == "squaring"
    w = _weights(np.random.default_rng(n), b, n, min(1.0, 3.0 / n))
    got = tapsp.apsp_minplus(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(japsp.apsp_minplus)(jnp.asarray(w))))


def test_minplus_closure_early_stop_equals_full_schedule():
    rng = np.random.default_rng(5)
    d = torch.from_numpy(_weights(rng, 3, 40, 0.08))
    d.diagonal(dim1=1, dim2=2).zero_()
    full = d
    for _ in range(6):
        full = tmp.minplus_square_plain(full)
    np.testing.assert_array_equal(tmp.minplus_closure(d, 6).numpy(), full.numpy())


def _own_closure(x: torch.Tensor, iters: int):
    """One matrix squared until a squaring changes nothing, at most `iters`
    times: (the result, the squarings run, the one that changed nothing
    included)."""
    for ran in range(1, iters + 1):
        nxt = tmp.minplus_square_plain(x)
        if torch.equal(nxt, x):
            return nxt, ran
        x = nxt
    return x, iters


def _closure_input(b, n, p, dtype=np.float64):
    w = _weights(np.random.default_rng(n), b, n, p).astype(dtype)
    d = torch.from_numpy(w.copy())
    d.diagonal(dim1=1, dim2=2).zero_()
    return w, d


@pytest.mark.parametrize("b,n,p,iters", [(5, 24, 0.12, 5), (4, 40, 0.08, 6),
                                         (3, 37, 0.2, 30), (2, 56, 3 / 56, 6)])
def test_squarings_run_plain_equals_a_direct_count(b, n, p, iters):
    _, d = _closure_input(b, n, p)
    want = sum(_own_closure(d[k], iters)[1] for k in range(b))
    assert tmp.squarings_run_plain(d, iters) == want
    assert tmp.squarings_run_plain(d.float(), iters) == sum(
        _own_closure(d[k].float(), iters)[1] for k in range(b))


@pytest.mark.parametrize("b,n,p", [(4, 30, 0.1), (3, 61, 0.05), (2, 128, 0.03)])
def test_per_matrix_early_stop_equals_full_schedule_and_jax(b, n, p):
    """K2 stops each matrix at its own fixed point: the same bits as the
    full schedule of ceil(log2(N - 1)) squarings, as `apsp_minplus` under
    `jax.vmap` and, at N a multiple of 128, as the Pallas kernel."""
    iters = tmp.squaring_count(n)
    for dtype in (np.float64, np.float32):
        w, d = _closure_input(b, n, p, dtype)
        own = torch.stack([_own_closure(d[k], iters)[0] for k in range(b)]).numpy()
        full = d
        for _ in range(iters):
            full = tmp.minplus_square_plain(full)
        np.testing.assert_array_equal(own, full.numpy())
        np.testing.assert_array_equal(
            own, np.asarray(jax.vmap(japsp.apsp_minplus)(jnp.asarray(w))))
        if n % 128 == 0:
            np.testing.assert_array_equal(
                own, np.asarray(apsp_minplus_pallas(jnp.asarray(w), interpret=True)))


@pytest.mark.parametrize("n,seed", [(16, 1), (40, 2)])
def test_next_hop_and_hops_exact(n, seed):
    from multihop_offload_tpu.graphs import generators

    rng = np.random.default_rng(seed)
    adjs = np.stack([generators.barabasi_albert(n, m=2, seed=seed + k)[0]
                     for k in range(3)]).astype(np.float64)
    adjs[2, -3:, :] = adjs[2, :, -3:] = 0  # isolated nodes: all-inf rows
    # integer weights make exact ties common; the lowest neighbour must win
    w = np.where(adjs > 0, rng.integers(1, 4, adjs.shape).astype(np.float64), np.inf)
    w = np.minimum(w, np.swapaxes(w, 1, 2))
    sp = tapsp.apsp_minplus(torch.from_numpy(w))
    jsp = jax.vmap(japsp.apsp_minplus)(jnp.asarray(w))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    nh = tapsp.next_hop_table(torch.from_numpy(adjs), sp)
    jnh = jax.vmap(japsp.next_hop_table)(jnp.asarray(adjs), jsp)
    assert nh.dtype == torch.int32
    np.testing.assert_array_equal(nh.numpy(), np.asarray(jnh))
    np.testing.assert_array_equal(
        tapsp.hop_matrix(torch.from_numpy(adjs)).numpy(),
        np.asarray(jax.vmap(japsp.hop_matrix)(jnp.asarray(adjs))))


def test_next_hop_chunking_is_invisible(monkeypatch):
    rng = np.random.default_rng(3)
    adj = torch.from_numpy((_weights(rng, 5, 20, 0.2) < np.inf).astype(np.float64))
    sp = tapsp.apsp_minplus(torch.where(adj > 0, 1.0, float("inf")).double())
    whole = tapsp.next_hop_table(adj, sp)
    monkeypatch.setattr(tapsp, "_NEXT_HOP_CHUNK_ELEMS", 2 * 20 ** 3)
    np.testing.assert_array_equal(tapsp.next_hop_table(adj, sp).numpy(),
                                  whole.numpy())


def test_weight_matrix_matches_jax():
    from multihop_offload_tpu.graphs import generators

    adj = generators.barabasi_albert(20, m=2, seed=4)[0].astype(np.float64)
    iu, ju = np.nonzero(np.triu(adj, 1))
    li = np.zeros((20, 20), dtype=np.int32)
    li[iu, ju] = li[ju, iu] = np.arange(iu.size)
    delays = np.random.default_rng(0).uniform(0.01, 1.0, (1, iu.size + 4))
    got = tapsp.weight_matrix_from_link_delays(
        torch.from_numpy(adj[None]), torch.from_numpy(li[None]),
        torch.from_numpy(delays))
    expect = japsp.weight_matrix_from_link_delays(
        jnp.asarray(adj), jnp.asarray(li), jnp.asarray(delays[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(expect))


def test_dispatch_refuses_other_devices_and_checks_operands():
    d = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmp.minplus_closure(d, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tfp.fixed_point(d, d[:, 0], d[:, 0], d[:, 0])
    # the CUDA wrappers refuse CPU tensors before touching any kernel
    before = (tfp.fixed_point_cuda.launches, tmp.minplus_closure_cuda.launches)
    x = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError):
        tmp.minplus_closure_cuda(x, 2)
    with pytest.raises(ValueError):
        tfp.fixed_point_cuda(x, x[:, 0], x[:, 0], x[:, 0])
    assert (tfp.fixed_point_cuda.launches,
            tmp.minplus_closure_cuda.launches) == before


# ---- K4, K6 plain versions and K1's gradient ---------------------------------


def _coo_case(rng, b, e, f, p, pad_extra=9):
    """Non-symmetric (B, E, E) matrices as COO in `np.nonzero` order with
    trailing (0, 0, 0) pads, as the sparse layout builds them; a diagonal
    and features."""
    nnz_pad = int(max((rng.uniform(size=(e, e)) < p).sum() for _ in range(4))) * 2
    rows = np.zeros((b, nnz_pad), np.int32)
    cols = np.zeros((b, nnz_pad), np.int32)
    vals = np.zeros((b, nnz_pad))
    for k in range(b):
        r, c = np.nonzero(rng.uniform(size=(e, e)) < p)
        r, c = r[: nnz_pad - pad_extra], c[: nnz_pad - pad_extra]
        rows[k, : r.size], cols[k, : r.size] = r, c
        vals[k, : r.size] = rng.normal(size=r.size)
    return rows, cols, vals, rng.normal(size=(b, e)), 10 * rng.normal(size=(b, e, f))


@pytest.mark.parametrize("b,e,f", [(2, 40, 4), (3, 70, 8)])
def test_chebconv_plain_matches_jax(b, e, f):
    from multihop_offload_tpu.ops.chebconv import _xla_propagate, chebconv_propagate_pallas
    from multihop_offload_tpu_torch.layouts.sparse import SparseSupport
    from multihop_offload_tpu_torch.ops import chebconv as tcc
    from multihop_offload_tpu_torch.ops.sparse import COO

    rng = np.random.default_rng(e)
    rows, cols, vals, diag, x = _coo_case(rng, b, e, f, 0.08)
    g = rng.normal(size=x.shape)
    t = torch.from_numpy
    support = SparseSupport(edges=COO(rows=t(rows), cols=t(cols), vals=t(vals),
                                      shape=(e, e)), diag=t(diag))
    xt = t(x).requires_grad_()
    out = tcc.chebconv_propagate(support, xt)
    (dx,) = torch.autograd.grad(out, xt, t(g))

    def pallas(r, c, v, d, xx):
        return chebconv_propagate_pallas(r, c, v, d, xx, "float64", True)

    def xla(r, c, v, d, xx):
        return _xla_propagate(r, c, v, d, xx, jnp.float64)

    for fn in (pallas, xla):
        want, vjp = jax.vjp(lambda xx: jax.vmap(fn)(rows, cols, vals, diag, xx), jnp.asarray(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b,n,p", [(2, 24, 0.15), (3, 40, 0.08)])
def test_coo_apsp_plain_chain_equals_jax_kernel(b, n, p):
    """K6's plain chain (`weight_matrix_from_edges` -> blocked squarings)
    bit-identical to `apsp_minplus_coo` in interpret mode."""
    from multihop_offload_tpu.ops.minplus import apsp_minplus_coo

    rng = np.random.default_rng(n)
    l_pad = 0
    lists = []
    for _ in range(b):
        iu, ju = np.where(np.triu(rng.uniform(size=(n - 3, n - 3)) < p, 1))
        lists.append(np.stack([iu, ju], 1))
        l_pad = max(l_pad, iu.size + 5)
    ends = np.zeros((b, l_pad, 2), np.int32)
    mask = np.zeros((b, l_pad), bool)
    for k, lk in enumerate(lists):
        ends[k, : len(lk)], mask[k, : len(lk)] = lk, True
    delays = rng.uniform(0.1, 5.0, (b, l_pad))
    got = tmp.apsp_minplus_coo(torch.from_numpy(ends), torch.from_numpy(mask),
                               torch.from_numpy(delays), n)
    want = jax.vmap(lambda e_, m, d: apsp_minplus_coo(e_, m, d, n, interpret=True))(
        ends, mask, delays)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isinf(got).any()  # three isolated nodes stay unreachable


def test_blocked_fw_plain_bit_identical_to_jax_tile8():
    """K3's plain version against `blocked_fw_call` in interpret mode on a
    batched, asymmetric input, as `tests/test_ops.py` builds it."""
    from multihop_offload_tpu.ops.minplus import blocked_fw_call

    rng = np.random.default_rng(3)
    t = 8
    n = 4 * t
    d = rng.uniform(0.1, 5.0, (2, n, n))
    d = np.where(rng.uniform(size=(2, n, n)) < 0.4, d, np.inf)
    for b in range(2):
        np.fill_diagonal(d[b], 0.0)
    got = tmp.blocked_fw_plain(torch.from_numpy(d), tile=t)
    want = blocked_fw_call(jnp.asarray(d), tile=t, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blocked_fw_apsp_bit_identical_to_jax_tile128():
    """`apsp_minplus_pallas` (the `'pallas'` route) at N=300 takes the
    blocked-FW path, pads to 384 and equals `apsp_minplus_pallas(interpret=
    True)` bit for bit; it is not the squarings' result (the two closures
    differ by ulps)."""
    rng = np.random.default_rng(7)
    w = _weights(rng, 1, 300, 4.0 / 300)
    assert tmp.apsp_path(300) == "blocked-fw" and tmp.padded_n(300) == 384
    got = tmp.apsp_minplus_pallas(torch.from_numpy(w)).numpy()
    pallas = np.asarray(apsp_minplus_pallas(jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    squared = np.asarray(jax.vmap(japsp.apsp_minplus)(jnp.asarray(w)))
    assert (got != squared).any()
    finite = np.isfinite(squared)
    np.testing.assert_allclose(got[finite], squared[finite], rtol=1e-12)


def test_blocked_fw_schedule_is_observable():
    """On the K3 gpu test's input (N=384, density 6/N, `default_rng(384)`)
    the 128-tile schedule of `blocked_fw_plain` differs from the 64-tile
    one and from plain FW (one tile of N) in >= 1,000 entries each, and
    equals the TPU kernel `blocked_fw_call` in interpret mode bit for bit:
    a kernel on another tile would not be bit-identical."""
    from multihop_offload_tpu.ops.minplus import blocked_fw_call

    b, n = 2, 384
    rng = np.random.default_rng(n)
    w = np.where(rng.uniform(size=(b, n, n)) < 6.0 / n,
                 rng.uniform(0.1, 5.0, (b, n, n)), np.inf).astype(np.float32)
    for k in range(b):
        np.fill_diagonal(w[k], 0.0)
    d = torch.from_numpy(w)
    got = tmp.blocked_fw_plain(d)
    assert int((got != tmp.blocked_fw_plain(d, 64)).sum()) >= 1000
    assert int((got != tmp.blocked_fw_plain(d, n)).sum()) >= 1000
    want = blocked_fw_call(jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [150, 256, 300, 1000, 2048, 2049, 3000])
def test_apsp_path_follows_jax_dispatch(n):
    from multihop_offload_tpu.ops.minplus import pallas_apsp_path

    want = pallas_apsp_path(n, interpret=True)
    # above 2,048 the JAX package delegates to its XLA squaring
    assert tmp.apsp_path(n) == ("squaring" if want == "xla-fallback" else want)


def test_fixed_point_path_switches_at_the_shared_memory_cap():
    cap = max(l for l in range(1, 2000) if tfp._smem_bytes(l) <= tfp._SMEM_BYTES)
    assert cap == 928
    assert tfp.fixed_point_path(cap) == "k1"
    assert tfp.fixed_point_path(cap + 1) == "scan"
    assert tfp.fixed_point_path(7696) == "scan"


def test_fixed_point_scan_path_equals_k1_path_with_grads():
    """Above the cap the fixed point is the plain scan under native
    autograd: the same values and gradients as the K1 path's autograd
    Function, and `fixed_point_scan.runs` counts it."""
    rng = np.random.default_rng(9)
    args = _conflict_batch(rng, 1, 930, p=0.01)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    before = tfp.fixed_point_scan.runs
    mu = tfp.fixed_point(*ins)
    assert tfp.fixed_point_scan.runs == before + 1
    g = torch.from_numpy(rng.normal(size=mu.shape))
    got = torch.autograd.grad(mu, ins, g)
    ref_ins = [torch.from_numpy(a).requires_grad_() for a in args]
    ref = tfp._FixedPoint.apply(*ref_ins, 10)
    want = torch.autograd.grad(ref, ref_ins, g)
    np.testing.assert_array_equal(mu.detach().numpy(), ref.detach().numpy())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-15)
    jmu = np.asarray(interference_fixed_point_raw(*map(jnp.asarray, args), 10))
    np.testing.assert_allclose(mu.detach().numpy(), jmu, rtol=1e-12)


def test_next_hop_row_chunking_is_invisible(monkeypatch):
    """At large N one (N, N, N) temp is too big: the table is built in
    chunks of source rows, with the same values and lowest-index ties."""
    rng = np.random.default_rng(4)
    adj = torch.from_numpy((_weights(rng, 2, 30, 0.15) < np.inf).astype(np.float64))
    w = torch.where(adj > 0, torch.from_numpy(rng.integers(1, 3, (2, 30, 30)).astype(
        np.float64)), float("inf"))
    sp = tapsp.apsp_minplus(torch.minimum(w, w.transpose(1, 2)))
    whole = tapsp.next_hop_table(adj, sp)
    monkeypatch.setattr(tapsp, "_NEXT_HOP_CHUNK_ELEMS", 7 * 30 * 30)
    np.testing.assert_array_equal(tapsp.next_hop_table(adj, sp).numpy(), whole.numpy())
    jnh = jax.vmap(japsp.next_hop_table)(jnp.asarray(adj.numpy()), jnp.asarray(sp.numpy()))
    np.testing.assert_array_equal(whole.numpy(), np.asarray(jnh))


def test_coo_apsp_blocked_fw_path_equals_jax_kernel():
    """At N=300 the COO-fed APSP is the edge-list build, then the blocked
    FW (`ops/minplus.py:507-515`): bit-identical to `apsp_minplus_coo` in
    interpret mode."""
    from multihop_offload_tpu.ops.minplus import apsp_minplus_coo, coo_apsp_path

    n = 300
    assert coo_apsp_path(n, interpret=True) == "blocked-fw"
    rng = np.random.default_rng(n)
    iu, ju = np.where(np.triu(rng.uniform(size=(n - 2, n - 2)) < 4.0 / n, 1))
    l_pad = iu.size + 6
    ends = np.zeros((1, l_pad, 2), np.int32)
    ends[0, : iu.size] = np.stack([iu, ju], 1)
    mask = np.zeros((1, l_pad), bool)
    mask[0, : iu.size] = True
    delays = rng.uniform(0.1, 5.0, (1, l_pad))
    got = tmp.apsp_minplus_coo(torch.from_numpy(ends), torch.from_numpy(mask),
                               torch.from_numpy(delays), n)
    want = apsp_minplus_coo(ends[0], mask[0], delays[0], n, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("b,l", [(2, 24), (3, 72)])
def test_fixed_point_grad_matches_jax_custom_vjp(b, l):
    """K1's autograd Function (backward: recompute through the plain scan)
    against the JAX custom_vjp (recompute through `_xla_reference`)."""
    rng = np.random.default_rng(l + 1)
    args = _conflict_batch(rng, b, l)
    g = rng.normal(size=(b, l))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    mu = tfp.fixed_point(*ins)
    got = torch.autograd.grad(mu, ins, torch.from_numpy(g))
    for interpret in (False, True):
        _, vjp = jax.vjp(lambda *a: fixed_point_pallas(*a, 10, interpret),
                         *map(jnp.asarray, args))
        for t, j in zip(got, vjp(jnp.asarray(g))):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-10,
                                       atol=1e-10 * np.abs(j).max())


# ---- K5: the ragged propagate's plain version and gradient -------------------

_CHEB_SCALED_TOL = 4.5e-7  # the JAX package's bar for the fused propagates


def _ragged_case(dtype):
    """The JAX ragged test's case (`tests/test_ops.py`: n=12, f=6, 17 live
    entries in random row order, capacity 300, seed 37) as slot 0, and a
    second slot with 5 live entries."""
    rng = np.random.default_rng(37)
    n, f, cap = 12, 6, 300
    rows = np.zeros((2, cap), np.int32)
    cols = np.zeros((2, cap), np.int32)
    vals = np.zeros((2, cap), dtype)
    live = np.array([17, 5], np.int32)
    rows[0, :17] = rng.integers(0, n, 17)
    cols[0, :17] = rng.integers(0, n, 17)
    vals[0, :17] = rng.normal(size=17).astype(dtype)
    diag = rng.normal(size=(2, n)).astype(dtype)
    x = rng.normal(size=(2, n, f)).astype(dtype)
    rows[1, :5] = rng.integers(0, n, 5)
    cols[1, :5] = rng.integers(0, n, 5)
    vals[1, :5] = rng.normal(size=5).astype(dtype)
    return rows, cols, vals, diag, x, live


def test_ragged_plain_matches_jax_kernel():
    """float32: the plain version at the live counts equals itself at the
    capacity bit for bit, gives exactly diag * x at live = 0, and is within
    the scaled 4.5e-7 of the interpret-mode TPU kernel at edge_block 128."""
    from multihop_offload_tpu.ops.chebconv import chebconv_propagate_ragged as jrag
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    rows, cols, vals, diag, x, live = _ragged_case(np.float32)
    t = torch.from_numpy
    args = tuple(map(t, (rows, cols, vals, diag, x)))
    at_live = tcc.chebconv_propagate_ragged(*args, t(live))
    at_cap = tcc.chebconv_propagate_ragged(*args, torch.full((2,), 300, dtype=torch.int32))
    assert torch.equal(at_live, at_cap)
    zero = tcc.chebconv_propagate_ragged(*args, torch.zeros(2, dtype=torch.int32))
    assert torch.equal(zero, t(diag)[..., None] * t(x))
    for k in range(2):
        want = np.asarray(jrag(*(jnp.asarray(a[k]) for a in (rows, cols, vals, diag, x)),
                               jnp.int32(live[k]), "float32", True, 128))
        err = np.abs(at_live[k].numpy() - want).max() / max(1.0, np.abs(want).max())
        assert err <= _CHEB_SCALED_TOL, err


@pytest.mark.parametrize("live0", [0, 17, 300])
def test_ragged_float64_and_grads_match_jax(live0):
    """float64: the port's K5 (plain version on the CPU) within 1e-12 of
    `_xla_propagate`, and its autograd in vals, diag and x within 1e-12 of
    `jax.vjp` of `_xla_propagate` over the full capacity, which is what the
    JAX `_cheb_ragged_bwd` pulls back through."""
    from multihop_offload_tpu.ops.chebconv import _xla_propagate
    from multihop_offload_tpu_torch.layouts.sparse import SparseSupport
    from multihop_offload_tpu_torch.ops import chebconv as tcc
    from multihop_offload_tpu_torch.ops.sparse import COO

    rows, cols, vals, diag, x, live = _ragged_case(np.float64)
    live[0] = live0
    rows[0, live0:], cols[0, live0:], vals[0, live0:] = 0, 0, 0.0  # the inert tail
    g = np.random.default_rng(5).normal(size=x.shape)
    t = torch.from_numpy
    v, d, xx = (t(a).requires_grad_() for a in (vals, diag, x))
    out = tcc.chebconv_propagate_ragged(t(rows), t(cols), v, d, xx, t(live))
    grads = torch.autograd.grad(out, (v, d, xx), t(g))

    def xla(vv, dd, x_):
        return jax.vmap(lambda r, c, a, b_, e: _xla_propagate(r, c, a, b_, e, jnp.float64))(
            rows, cols, vv, dd, x_)

    want, vjp = jax.vjp(xla, jnp.asarray(vals), jnp.asarray(diag), jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    for got, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    # the factory reads the same lists from a support
    support = SparseSupport(edges=COO(rows=t(rows), cols=t(cols), vals=t(vals),
                                      shape=(12, 12)), diag=t(diag))
    prop = tcc.make_fused_propagate_ragged()
    assert torch.equal(prop(support, t(x), t(live)), out.detach())
