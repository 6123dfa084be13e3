"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked `gpu`; every test takes the `cuda` fixture, which skips when no CUDA
card is present (decided inside the fixture, so every collecting worker
sees the same tests).  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import math
import os

import numpy as np
import pytest
import torch

from multihop_offload_tpu_torch.env.apsp import apsp_minplus
from multihop_offload_tpu_torch.ops import fixed_point as tfp
from multihop_offload_tpu_torch.ops import minplus as tmp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _weights(rng, b, n, p):
    w = np.full((b, n, n), np.inf, dtype=np.float32)
    for k in range(b):
        iu, ju = np.where(np.triu(rng.uniform(size=(n, n)) < p, 1))
        vals = rng.uniform(0.1, 5.0, iu.size).astype(np.float32)
        w[k, iu, ju] = w[k, ju, iu] = vals
    return torch.from_numpy(w)


def _executed():
    return tmp.squarings_executed(torch.float32)


# (16, 56) and (64, 112): the service's small bucket and the paper batch;
# the rest sit at the edges of the tile plans (`csrc/minplus.cu`): N = 1 and
# 2, one strip of 8 and one above, either side of 56 (the last strip plan
# and the first 56-row tile), of 112 (the 56- and 64-row tiles) and of 256,
# at odd N with 4-byte copies
@pytest.mark.parametrize("b,n", [(3, 7), (5, 37), (4, 112), (2, 256), (1, 300),
                                 (16, 56), (64, 112), (3, 1), (3, 2), (7, 8), (7, 9),
                                 (4, 55), (4, 57), (4, 111), (4, 113), (2, 255),
                                 (2, 257)])
def test_minplus_kernel_bit_identical(cuda, b, n):
    w = _weights(np.random.default_rng(n), b, n, 3.0 / n).to(cuda)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=cuda), 0.0, w)
    # the squaring schedule of apsp_minplus: ceil(log2(N-1)) squarings at
    # most (more can still lower an entry by an ulp: fp addition is not
    # associative, so the closure is not a fixed point bit for bit); K2
    # squares at any N, though apsp_minplus takes K3 above a padded 256
    iters = max(1, math.ceil(math.log2(max(n - 1, 2))))
    before = tmp.minplus_closure_cuda.launches
    got = tmp.minplus_closure(d, iters)
    assert tmp.minplus_closure_cuda.launches == before + iters  # a launch per squaring
    expect = tmp.minplus_closure(d.cpu(), iters)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), expect)
    if tmp.apsp_path(n) == "squaring":
        assert torch.equal(apsp_minplus(w), got)
    plain = tmp.minplus_closure_plain(d, iters)
    assert torch.equal(got, plain)


def test_minplus_kernel_leaves_input_and_stops_early(cuda):
    w = _weights(np.random.default_rng(1), 4, 64, 0.2).to(cuda)
    d = torch.where(torch.eye(64, dtype=torch.bool, device=cuda), 0.0, w)
    keep = d.clone()
    counter0 = _executed()
    out = tmp.minplus_closure_cuda(d, 30)
    torch.cuda.synchronize()
    assert torch.equal(d, keep)
    assert torch.equal(out, tmp.minplus_closure_plain(d, 30))
    ran = _executed() - counter0
    assert 4 <= ran < 4 * 30  # converged matrices skip the rest of the schedule
    assert ran == tmp.squarings_run_plain(d, 30)


@pytest.mark.parametrize("b,n", [(16, 56), (64, 112)])
def test_minplus_kernel_executed_equals_plain_count(cuda, b, n):
    """The service's small bucket and the paper batch: the squarings the
    device early stop runs are exactly those the plain count finds."""
    w = _weights(np.random.default_rng(n), b, n, 3.0 / n).to(cuda)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=cuda), 0.0, w)
    iters = tmp.squaring_count(n)
    counter0 = _executed()
    out = tmp.minplus_closure_cuda(d, iters)
    torch.cuda.synchronize()
    assert _executed() - counter0 == tmp.squarings_run_plain(d, iters)
    assert torch.equal(out, tmp.minplus_closure_plain(d, iters))


def test_minplus_squarings_counted_on_every_card(cuda):
    """K2 on two cards in turn, back and forth: each card keeps its own
    counter, and the squarings summed over them equal the plain count of
    every call (a counter kept for one card only would count the last)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    counter0, want = _executed(), 0
    for i, (b, n) in enumerate([(16, 56), (64, 112), (16, 56), (5, 37)]):
        w = _weights(np.random.default_rng(100 + i), b, n, 3.0 / n)
        d = torch.where(torch.eye(n, dtype=torch.bool), 0.0, w)
        iters = tmp.squaring_count(n)
        out = tmp.minplus_closure_cuda(d.to(cards[i % 2]), iters)
        assert torch.equal(out.cpu(), tmp.minplus_closure_plain(d, iters))
        want += tmp.squarings_run_plain(d, iters)
    assert set(cards) <= set(tmp.minplus_closure_cuda.executed)
    assert _executed() - counter0 == want


@pytest.mark.parametrize("b,n", [(64, 112), (4, 256), (16, 56), (16, 112), (1, 1024),
                                 (5, 37)])
def test_minplus_tile_plan_follows_n(cuda, b, n):
    """At the paths' shapes the tiles cover N to the granule of 8, and a
    squaring has at least 112 blocks or one for each 8-row strip."""
    plan = tmp.tile_plan(b, n)
    rows, cols = plan["tile_rows"], plan["tile_cols"]
    assert plan["blocks"] == b * math.ceil(n / rows) * math.ceil(n / cols)
    assert rows * math.ceil(n / rows) == cols * math.ceil(n / cols) == 8 * math.ceil(n / 8)
    assert plan["blocks"] >= min(112, b * math.ceil(n / 8))


def _device_ops(fn, reps: int = 5) -> dict:
    """Device records (kernels, copies, memsets) by name per call of `fn`,
    from a `torch.profiler` trace of `reps` calls.  The trace can lose
    records, so a window is traced again, up to 5 times, until every
    name's count is a whole multiple of `reps` and K2 is among them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.key_averages():
            if "CUDA" in str(getattr(e, "device_type", "")) and e.self_device_time_total > 0:
                ops[e.key] = ops.get(e.key, 0) + e.count
        if any("minplus" in k for k in ops) and all(c % reps == 0 for c in ops.values()):
            return {k: c // reps for k, c in ops.items()}
    raise AssertionError(f"five traces of {reps} calls lost device records: {ops}")


def test_apsp_minplus_hands_its_temporary_to_k2(cuda, monkeypatch):
    """On the card the dense APSP gives K2 its fresh `torch.where` result as
    the first buffer: its weights stay as they were, and a call runs one
    device operation fewer than with `minplus_closure`'s copy."""
    b, n = 8, 112
    w = _weights(np.random.default_rng(11), b, n, 3.0 / n).to(cuda)
    keep = w.clone()
    iters = tmp.squaring_count(n)
    before = tmp.minplus_closure_cuda.launches
    got = apsp_minplus(w)
    torch.cuda.synchronize()
    assert tmp.minplus_closure_cuda.launches == before + iters
    assert torch.equal(w, keep)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=cuda), 0.0, w)
    assert torch.equal(got, tmp.minplus_closure_plain(d, iters))
    owned = _device_ops(lambda: apsp_minplus(w))
    closure = tmp.minplus_closure
    monkeypatch.setattr(tmp, "minplus_closure", lambda x, k, owned=False: closure(x, k))
    copied = _device_ops(lambda: apsp_minplus(w))
    assert torch.equal(apsp_minplus(w), got)
    k2 = [sum(c for k, c in ops.items() if "minplus" in k) for ops in (owned, copied)]
    assert k2 == [iters, iters]
    assert sum(owned.values()) == sum(copied.values()) - 1
    assert torch.equal(w, keep)


def test_minplus_kernel_large_batch_long_schedule(cuda):
    """2,000 matrices over 30 squarings (8,000 blocks a launch, 240,000 in
    all): every matrix stops at its own fixed point, long before the last
    squaring."""
    w = _weights(np.random.default_rng(40), 2000, 40, 3.0 / 40).to(cuda)
    d = torch.where(torch.eye(40, dtype=torch.bool, device=cuda), 0.0, w)
    before, counter0 = tmp.minplus_closure_cuda.launches, _executed()
    out = tmp.minplus_closure_cuda(d, 30)
    torch.cuda.synchronize()
    assert tmp.minplus_closure_cuda.launches == before + 30
    assert torch.equal(out, tmp.minplus_closure_plain(d, 30))
    assert _executed() - counter0 == tmp.squarings_run_plain(d, 30)


def _fp_operands(b, l, p=None, device="cpu"):
    """A symmetric 0/1 conflict matrix with an edge at probability p (8 / l
    by default), rates U(30, 70) rounded, lambdas U(0, 60), cf its row sums."""
    rng = np.random.default_rng(l)
    p = 8.0 / l if p is None else p
    a = np.triu((rng.uniform(size=(b, l, l)) < p).astype(np.float32), 1)
    a = a + np.swapaxes(a, 1, 2)
    rates = rng.uniform(30, 70, (b, l)).round().astype(np.float32)
    lam = rng.uniform(0, 60, (b, l)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (a, rates, a.sum(1), lam)]


# (16, 96) and (16, 216): the service's buckets; (3, 215): odd L, so rows
# and instances start off 16-byte boundaries; (2, 216) at density 0.5:
# every word crowded; (1, 504) at 0.5: the lists past their room, so the
# kernel walks the bitmask; (1, 1): the smallest
@pytest.mark.parametrize("b,l,p", [(2, 24, None), (64, 216, None), (4, 504, None),
                                   (1, 928, None), (16, 96, None), (16, 216, None),
                                   (3, 215, None), (2, 216, 0.5), (1, 504, 0.5),
                                   (1, 1, None)])
def test_fixed_point_kernel_matches_plain(cuda, b, l, p):
    args = _fp_operands(b, l, p, cuda)
    before = tfp.fixed_point_cuda.launches
    got = tfp.fixed_point(*args)
    expect = tfp.fixed_point_plain(*args)
    torch.cuda.synchronize()
    assert tfp.fixed_point_cuda.launches == before + 1
    rel = ((got - expect).abs() / expect.abs()).max().item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("b,l,p", [(64, 216, None), (3, 215, None), (1, 504, 0.5)])
def test_fixed_point_kernel_zero_rounds_is_mu0(cuda, b, l, p):
    adj, rates, cf, lam = _fp_operands(b, l, p, cuda)
    got = tfp.fixed_point_cuda(adj, rates, cf, lam, num_iters=0)
    assert torch.equal(got, rates / (cf + 1.0))


@pytest.mark.parametrize("b,l,p", [(64, 216, None), (1, 928, None), (1, 504, 0.5)])
def test_fixed_point_kernel_is_deterministic(cuda, b, l, p):
    args = _fp_operands(b, l, p, cuda)
    first = tfp.fixed_point_cuda(*args)
    assert torch.equal(tfp.fixed_point_cuda(*args), first)


def test_fixed_point_kernel_checks_operands(cuda):
    x = torch.zeros((1, 8, 8), device=cuda)
    with pytest.raises(TypeError):
        tfp.fixed_point_cuda(x.double(), x[:, 0].double(), x[:, 0].double(),
                             x[:, 0].double())
    with pytest.raises(ValueError):
        tfp.fixed_point_cuda(x, x[:, 0], x[:, 0], x[:, :4, 0])
    with pytest.raises(ValueError):
        tfp.fixed_point_cuda(x.transpose(1, 2), x[:, 0], x[:, 0], x[:, 0])
    big = torch.zeros((1, 929, 929), device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        tfp.fixed_point_cuda(big, big[:, 0], big[:, 0], big[:, 0])


def test_eval_methods_card_matches_cpu(cuda):
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.train.driver import eval_methods

    inst, jobs, _ = request_batch(load_cases("paper")[2:6], 2, seed=1,
                                  device="cpu")
    model = load_model("SCRATCH800_decay0.99", device="cpu")
    cpu = eval_methods(model, inst, jobs, device="cpu")
    card = eval_methods(model, inst, jobs, device=cuda)
    m = jobs.mask
    for c, g in zip(cpu, card):
        assert torch.isfinite(g.cpu()[m]).all()
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=0)


# ---- K4 (sparse ChebConv propagate) and K6 (COO-fed APSP) -------------------

SCALED_TOL = 4.5e-7  # the JAX package's bar for the fused propagate


def _scaled_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()


def _sparse_batch(group, per_network, cases=slice(None)):
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch

    return request_batch(load_cases(group)[cases], per_network, seed=0,
                         device="cpu", layout="sparse")


def _random_coo(rng, b, e, nnz_pad, p):
    """Non-symmetric random supports as the sparse Instance builder lists
    them (real entries sorted by row, pads after them), with their CSR
    index: the transposed walk of the backward reads a list that is not
    sorted by column."""
    from multihop_offload_tpu_torch._records import stack_records
    from multihop_offload_tpu_torch.layouts.sparse import (
        SparseSupport,
        _coo_from_dense_np,
        csr_index,
    )

    coos = []
    for _ in range(b):
        mat = np.where(rng.uniform(size=(e, e)) < p, rng.normal(size=(e, e)), 0.0)
        coos.append(_coo_from_dense_np(mat, nnz_pad, np.float32))
    return SparseSupport(edges=stack_records(coos),
                         diag=torch.from_numpy(rng.normal(size=(b, e)).astype(np.float32)),
                         csr=stack_records([csr_index(c) for c in coos]))


def _check_propagate(cuda, support, f, seed):
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    rng = np.random.default_rng(seed)
    b, e = support.diag.shape
    x = torch.from_numpy((10 * rng.normal(size=(b, e, f))).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, e, f)).astype(np.float32))
    sup = support.to(cuda)
    xc = x.to(cuda).requires_grad_()
    before = tcc.chebconv_propagate_cuda.launches
    out = tcc.chebconv_propagate(sup, xc)
    (dx,) = torch.autograd.grad(out, xc, g.to(cuda))
    torch.cuda.synchronize()
    assert tcc.chebconv_propagate_cuda.launches == before + 2  # forward + backward
    xp = x.to(cuda).requires_grad_()
    e_ = sup.edges
    ref = tcc.chebconv_propagate_plain(e_.rows, e_.cols, e_.vals, sup.diag, xp)
    (dx_ref,) = torch.autograd.grad(ref, xp, g.to(cuda))
    assert _scaled_err(out, ref) <= SCALED_TOL
    assert _scaled_err(dx, dx_ref) <= SCALED_TOL
    # against the CPU's sequential sum the forward is bit-identical
    cpu = tcc.chebconv_propagate_plain(support.edges.rows, support.edges.cols,
                                       support.edges.vals, support.diag, x)
    assert torch.equal(out.detach().cpu(), cpu)


@pytest.mark.parametrize("f", [4, 32])
@pytest.mark.parametrize("group,per_network", [("paper", 4), ("rung256", 1)])
def test_chebconv_kernel_matches_plain(cuda, group, per_network, f):
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support

    inst, _, _ = _sparse_batch(group, per_network, slice(0, 16))
    support = sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                       csr=inst.sparse.ext_csr)
    _check_propagate(cuda, support, f, seed=f)


def test_chebconv_kernel_nonsymmetric_unsorted(cuda):
    support = _random_coo(np.random.default_rng(3), 5, 70, 600, 0.08)
    _check_propagate(cuda, support, 7, seed=3)


def _check_coo_apsp(cuda, inst, delays):
    from multihop_offload_tpu_torch.ops import minplus as tmp

    n = inst.num_pad_nodes
    ends, mask = inst.link_ends.to(cuda), inst.link_mask.to(cuda)
    d = delays.to(cuda)
    before = (tmp.apsp_coo_cuda.launches, tmp.minplus_closure_cuda.launches)
    got = tmp.apsp_minplus_coo(ends, mask, d, n)
    plain_card = tmp.apsp_coo_plain(ends, mask, d, n)
    torch.cuda.synchronize()
    # one build, then K2's schedule of squarings
    assert (tmp.apsp_coo_cuda.launches - before[0],
            tmp.minplus_closure_cuda.launches - before[1]) == (1, tmp.squaring_count(n))
    assert torch.equal(got, plain_card)
    assert torch.equal(got.cpu(), tmp.apsp_coo_plain(inst.link_ends, inst.link_mask,
                                                      delays, n))


@pytest.mark.parametrize("group,per_network", [("paper", 4), ("rung256", 1)])
def test_coo_apsp_kernel_bit_identical(cuda, group, per_network):
    inst, _, _ = _sparse_batch(group, per_network, slice(0, 16))
    _check_coo_apsp(cuda, inst, 1.0 / inst.link_rates)
    rng = np.random.default_rng(7)
    noisy = inst.link_rates * torch.from_numpy(
        rng.uniform(0.5, 2.0, tuple(inst.link_rates.shape)).astype(np.float32))
    _check_coo_apsp(cuda, inst, 1.0 / noisy)


def _fw_input(b, n, symmetric=False, density=None):
    """(b, n, n) float32: an edge with probability `density` (6 / n by
    default), weights U(0.1, 5), +inf elsewhere, zero diagonal, from
    `default_rng(n)`."""
    rng = np.random.default_rng(n)
    p = 6.0 / n if density is None else density
    w = np.where(rng.uniform(size=(b, n, n)) < p,
                 rng.uniform(0.1, 5.0, (b, n, n)), np.inf).astype(np.float32)
    if symmetric:
        w = np.minimum(w, np.swapaxes(w, 1, 2))
    d = torch.from_numpy(w)
    d.diagonal(dim1=1, dim2=2).zero_()
    return d


@pytest.mark.parametrize("b,n,symmetric,density", [
    (2, 384, False, None), (1, 1024, True, None),
    (3, 128, False, None),   # the pivot alone: one launch per call
    (1, 2048, True, None),   # the cap
    (2, 384, False, 0.5),    # dense: nearly every step lowers entries
    (1, 384, False, 0.0),    # all +inf off the diagonal: inf + inf stays inf
])
def test_blocked_fw_kernel_bit_identical(cuda, b, n, symmetric, density):
    d = _fw_input(b, n, symmetric, density)
    dc = d.to(cuda)
    before = tmp.blocked_fw_cuda.launches
    got = tmp.blocked_fw_cuda(dc)
    plain = tmp.blocked_fw_plain(dc)
    torch.cuda.synchronize()
    # pivot, panels and outer per pivot block; the pivot alone at N = 128
    assert tmp.blocked_fw_cuda.launches - before == (3 * (n // 128) if n > 128 else 1)
    assert torch.equal(dc.cpu(), d)  # the input is not written
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), tmp.blocked_fw_plain(d))
    if density == 0.0:
        assert torch.equal(got.cpu(), d)


def test_blocked_fw_kernel_follows_the_128_schedule(cuda):
    """On the first case's input the kernel equals the plain version on
    128 tiles and differs from it on 64 tiles: this input shows a change
    of schedule."""
    d = _fw_input(2, 384)
    got = tmp.blocked_fw_cuda(d.to(cuda)).cpu()
    assert torch.equal(got, tmp.blocked_fw_plain(d))
    assert int((got != tmp.blocked_fw_plain(d, 64)).sum()) >= 1000


def test_apsp_takes_blocked_fw_above_256(cuda):
    """The `'pallas'` route (`apsp_minplus_pallas`) at N=300 pads to 384 and
    runs K3, not K2; the COO-fed APSP there is K6's build, then K3."""
    w = _weights(np.random.default_rng(4), 2, 300, 4.0 / 300)
    before = (tmp.blocked_fw_cuda.launches, tmp.minplus_closure_cuda.launches)
    got = tmp.apsp_minplus_pallas(w.to(cuda))
    torch.cuda.synchronize()
    assert (tmp.blocked_fw_cuda.launches - before[0],
            tmp.minplus_closure_cuda.launches - before[1]) == (9, 0)
    assert torch.equal(got.cpu(), tmp.apsp_minplus_pallas(w))
    iu, ju = np.nonzero(np.triu(np.isfinite(w[0].numpy()), 1))
    ends = torch.from_numpy(np.stack([iu, ju], 1).astype(np.int32))[None]
    mask = torch.ones((1, iu.size), dtype=torch.bool)
    delays = w[0][iu, ju][None].contiguous()
    k6 = tmp.apsp_coo_cuda.launches
    coo = tmp.apsp_minplus_coo(ends.to(cuda), mask.to(cuda), delays.to(cuda), 300)
    torch.cuda.synchronize()
    assert tmp.apsp_coo_cuda.launches - k6 == 1
    assert torch.equal(coo.cpu(), tmp.apsp_coo_plain(ends, mask, delays, 300))
    assert torch.equal(coo.cpu(), got[:1].cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_apsp_route_squares_at_padded_384(cuda, dtype):
    """The default route (`apsp_impl='xla'`: `apsp_minplus`, and
    `apsp_coo_squaring` from the link list) at N = 300, which the blocked
    FW would pad to 384, launches K2 (and K6's build) and no K3, and equals
    the plain squarings bit for bit; `shortest_paths` under the default
    `Config` takes it."""
    from multihop_offload_tpu_torch.config import Config

    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    w = _weights(np.random.default_rng(4), 2, 300, 4.0 / 300).to(dtype)
    counters = (tmp.minplus_closure_cuda, tmp.blocked_fw_cuda, tmp.apsp_coo_cuda)
    launches = lambda: tuple(getattr(c, "launches" + sfx) for c in counters)  # noqa: E731
    before = launches()
    fn, path = tmp.resolve_apsp(Config().apsp_impl, 300)
    got = fn(w.to(cuda))
    torch.cuda.synchronize()
    assert path == "squaring" and fn is apsp_minplus
    assert tuple(a - b for a, b in zip(launches(), before)) == (tmp.squaring_count(300), 0, 0)
    assert torch.equal(got.cpu(), apsp_minplus(w)) and got.dtype == dtype
    iu, ju = np.nonzero(np.triu(np.isfinite(w[0].float().numpy()), 1))
    ends = torch.from_numpy(np.stack([iu, ju], 1).astype(np.int32))[None]
    mask = torch.ones((1, iu.size), dtype=torch.bool)
    delays = w[0][iu, ju][None].contiguous()
    before = launches()
    coo = tmp.apsp_coo_squaring(ends.to(cuda), mask.to(cuda), delays.to(cuda), 300)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launches(), before)) == (tmp.squaring_count(300), 0, 1)
    assert torch.equal(coo.cpu(), got[:1].cpu())


def test_large_l_fixed_point_takes_the_scan(cuda):
    l = 1000
    rng = np.random.default_rng(l)
    a = np.triu((rng.uniform(size=(1, l, l)) < 8.0 / l).astype(np.float32), 1)
    a = a + np.swapaxes(a, 1, 2)
    rates = rng.uniform(30, 70, (1, l)).round().astype(np.float32)
    lam = rng.uniform(0, 60, (1, l)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (a, rates, a.sum(1), lam)]
    assert tfp.fixed_point_path(l) == "scan"
    before = (tfp.fixed_point_cuda.launches, tfp.fixed_point_scan.runs)
    lam_g = args[3].clone().requires_grad_()
    mu = tfp.fixed_point(*args[:3], lam_g)
    (g,) = torch.autograd.grad(mu.sum(), lam_g)
    torch.cuda.synchronize()
    assert (tfp.fixed_point_cuda.launches - before[0],
            tfp.fixed_point_scan.runs - before[1]) == (0, 1)
    assert torch.equal(mu.detach(), tfp.fixed_point_plain(*args))
    assert torch.isfinite(g).all()


def test_sparse_train_step_launches_k1_k4_k6(cuda):
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import chebconv as tcc
    from multihop_offload_tpu_torch.ops import minplus as tmp
    from multihop_offload_tpu_torch.train.driver import train_init, train_step

    inst, jobs, _ = _sparse_batch("paper", 2, slice(2, 6))
    cfg = Config(layout="sparse", batch=8, memory_size=16)
    model = load_model("SPECTRAL_K2", device=cuda, layout="sparse")
    state = train_init(model, cfg, device=cuda)
    before = [p.detach().clone() for p in model.parameters()]
    counts = (tfp.fixed_point_cuda.launches, tcc.chebconv_propagate_cuda.launches,
              tmp.apsp_coo_cuda.launches)
    rep = train_step(model, state, inst, jobs, cfg,
                     gen=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    torch.cuda.synchronize()
    after = (tfp.fixed_point_cuda.launches, tcc.chebconv_propagate_cuda.launches,
             tmp.apsp_coo_cuda.launches)
    # K1: actor, empirical evaluator, critic; K4: 5 forward + 4 backward; K6: 1
    assert [a - b for a, b in zip(after, counts)] == [3, 9, 1]
    assert rep.replayed and torch.isfinite(rep.loss_critic).all()
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


# ---- K5 (ragged ChebConv propagate) and the service on the card ------------


def _ragged_lists(rng, b, e, cap, shuffle):
    """(B, cap) lists of a random non-symmetric support per slot: a live
    prefix of each slot's own length (rows sorted, or shuffled), the
    inert (0, 0, 0) tail after it; diag and the live counts."""
    rows = np.zeros((b, cap), np.int32)
    cols = np.zeros((b, cap), np.int32)
    vals = np.zeros((b, cap), np.float32)
    live = np.zeros((b,), np.int32)
    for k in range(b):
        r, c = np.nonzero(rng.uniform(size=(e, e)) < rng.uniform(0.005, 0.03))
        n = min(r.size, cap)
        order = rng.permutation(n) if shuffle else np.arange(n)
        rows[k, :n], cols[k, :n] = r[:n][order], c[:n][order]
        vals[k, :n] = rng.normal(size=n)
        live[k] = n
    diag = rng.normal(size=(b, e)).astype(np.float32)
    return tuple(map(torch.from_numpy, (rows, cols, vals, diag, live)))


@pytest.mark.parametrize("f", [4, 6, 32, 40])
@pytest.mark.parametrize("shuffle", [False, True])
def test_chebconv_ragged_kernel_matches_plain(cuda, f, shuffle):
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    rng = np.random.default_rng(f)
    rows, cols, vals, diag, live = _ragged_lists(rng, 16, 328, 4096, shuffle)
    x = torch.from_numpy((10 * rng.normal(size=(16, 328, f))).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(16, 328, f)).astype(np.float32))
    dev = [t.to(cuda) for t in (rows, cols, vals, diag, x, live)]
    before = (tcc.ragged_index_cuda.launches, tcc.chebconv_propagate_cuda.launches)
    xk = dev[4].clone().requires_grad_()
    out = tcc.chebconv_propagate_ragged(*dev[:4], xk, dev[5])
    (dx,) = torch.autograd.grad(out, xk, g.to(cuda))
    torch.cuda.synchronize()
    # one sort, then the walk forward and the walk backward
    assert (tcc.ragged_index_cuda.launches - before[0],
            tcc.chebconv_propagate_cuda.launches - before[1]) == (1, 2)
    xp = dev[4].clone().requires_grad_()
    ref = tcc.chebconv_propagate_ragged_plain(*dev[:4], xp, dev[5])
    (dx_ref,) = torch.autograd.grad(ref, xp, g.to(cuda))
    assert _scaled_err(out, ref) <= SCALED_TOL
    assert _scaled_err(dx, dx_ref) <= SCALED_TOL
    # the CPU's sequential sum in list order, bit for bit
    cpu = tcc.chebconv_propagate_ragged_plain(rows, cols, vals, diag, x, live)
    assert torch.equal(out.detach().cpu(), cpu)
    # the inert tail: live equals capacity bit for bit; live 0 is diag * x
    cap = torch.full_like(dev[5], 4096)
    full = tcc.chebconv_propagate_ragged_cuda(*dev[:5], cap)
    assert torch.equal(full, out.detach())
    zero = tcc.chebconv_propagate_ragged_cuda(*dev[:5], torch.zeros_like(dev[5]))
    assert torch.equal(zero, dev[3][..., None] * dev[4])


def test_chebconv_ragged_kernel_checks_operands(cuda):
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    rows, cols, vals, diag, live = (t.to(cuda) for t in _ragged_lists(
        np.random.default_rng(0), 2, 40, 128, True))
    x = torch.zeros((2, 40, 3), device=cuda)
    with pytest.raises(TypeError, match="nnz_live"):
        tcc.chebconv_propagate_ragged_cuda(rows, cols, vals, diag, x, live.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        tcc.chebconv_propagate_ragged_cuda(rows, cols, vals, diag, x, live.cpu())


def _sort_cases():
    """name -> (rows, cols, live, E) CPU tensors for the sort kernel."""
    rng = np.random.default_rng(9)
    out = {}
    rows, cols, _, _, live = _ragged_lists(rng, 16, 328, 5248, False)
    out["service-sorted"] = (rows, cols, live, 328)
    rows, cols, _, _, live = _ragged_lists(rng, 16, 328, 5248, True)
    out["service-permuted"] = (rows, cols, live, 328)
    out["service-capacity"] = (rows, cols, torch.full_like(live, 5248), 328)
    out["service-zero"] = (rows, cols, torch.zeros_like(live), 328)
    rows, cols, _, _, live = _ragged_lists(rng, 64, 328, 4096, True)
    out["paper-batch"] = (rows, cols, live, 328)
    rows, cols, _, _, live = _ragged_lists(rng, 4, 752, 9984, True)
    out["rung256"] = (rows, cols, live, 752)
    # slots that start off a 16-byte boundary (cap 301: head and tail
    # entries around the bulk copy), live counts of every residue mod 4,
    # and live rows out of [0, E)
    rows, cols, _, _, live = _ragged_lists(rng, 8, 40, 301, True)
    live = torch.tensor([0, 1, 2, 3, 5, 150, 299, 301], dtype=torch.int32)
    rows[3, 1], rows[6, 7], cols[6, 8] = -1, 40, 999
    out["unaligned"] = (rows, cols, live, 40)
    r = np.random.default_rng(37)  # the JAX ragged test's case
    rows = torch.zeros((1, 300), dtype=torch.int32)
    cols = torch.zeros((1, 300), dtype=torch.int32)
    rows[0, :17] = torch.from_numpy(r.integers(0, 12, 17).astype(np.int32))
    cols[0, :17] = torch.from_numpy(r.integers(0, 12, 17).astype(np.int32))
    out["jax-ragged"] = (rows, cols, torch.tensor([17], dtype=torch.int32), 12)
    return out


@pytest.mark.parametrize("name", ["service-sorted", "service-permuted", "service-capacity",
                                  "service-zero", "paper-batch", "rung256", "unaligned",
                                  "jax-ragged"])
def test_ragged_index_kernel_equals_plain(cuda, name):
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    rows, cols, live, e = _sort_cases()[name]
    before = tcc.ragged_index_cuda.launches
    got = tcc.ragged_index_cuda(rows.to(cuda), cols.to(cuda), live.to(cuda), e)
    torch.cuda.synchronize()
    assert tcc.ragged_index_cuda.launches == before + 1
    want = tcc.ragged_index_plain(rows, cols, live, e)
    for field in ("row_ptr", "row_order", "col_ptr", "col_order"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


def test_chebconv_ragged_launches_one_sort_and_the_walks(cuda):
    """K5's forward is one sort and one walk; its backward one more walk
    over the column index the forward sorted, and no second sort."""
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    rng = np.random.default_rng(2)
    rows, cols, vals, diag, live = (t.to(cuda) for t in _ragged_lists(
        rng, 16, 328, 5248, True))
    x = torch.randn((16, 328, 32), device=cuda, requires_grad=True)

    def counts():
        return tcc.ragged_index_cuda.launches, tcc.chebconv_propagate_cuda.launches

    c0 = counts()
    with torch.no_grad():
        tcc.chebconv_propagate_ragged(rows, cols, vals, diag, x, live)
    c1 = counts()
    out = tcc.chebconv_propagate_ragged(rows, cols, vals, diag, x, live)
    c2 = counts()
    out.sum().backward()
    torch.cuda.synchronize()
    c3 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [1, 1]
    assert [b - a for a, b in zip(c1, c2)] == [1, 1]
    assert [b - a for a, b in zip(c2, c3)] == [0, 1]
    assert torch.isfinite(x.grad).all()


def test_ragged_index_kernel_raises_above_its_caps(cuda):
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    before = tcc.ragged_index_cuda.launches
    live = torch.zeros(1, dtype=torch.int32, device=cuda)
    ok = torch.zeros((1, tcc.RAGGED_MAX_CAP), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="caps"):
        tcc.ragged_index_cuda(ok, ok, live, tcc.RAGGED_MAX_ROWS + 1)
    big = torch.zeros((1, tcc.RAGGED_MAX_CAP + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="caps"):
        tcc.ragged_index_cuda(big, big, live, 8)
    x = torch.zeros((1, tcc.RAGGED_MAX_ROWS + 1, 4), device=cuda)
    with pytest.raises(ValueError, match="caps"):
        tcc.chebconv_propagate_ragged_cuda(ok, ok, ok.float(), x[..., 0], x, live)
    assert tcc.ragged_index_cuda.launches == before
    # at the caps it runs, and equals its plain version
    got = tcc.ragged_index_cuda(ok, ok, torch.full_like(live, 7), tcc.RAGGED_MAX_ROWS)
    want = tcc.ragged_index_plain(ok.cpu(), ok.cpu(), torch.full((1,), 7, dtype=torch.int32),
                                  tcc.RAGGED_MAX_ROWS)
    torch.cuda.synchronize()
    assert torch.equal(got.row_order.cpu(), want.row_order)
    assert torch.equal(got.col_ptr.cpu(), want.col_ptr)


def test_service_card_matches_cpu(cuda):
    """The dense service on the card: K1 and K2 launch, every admitted
    request is answered once, and decisions equal the CPU service's."""
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.serve.placement import PlacementPlan
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream

    cfg = Config(serve_slots=4, serve_queue_cap=64, serve_deadline_s=60.0,
                 serve_model="SCRATCH800_decay0.99", serve_ragged=True,
                 serve_overlap=True)
    pool = case_pool([20, 50], per_size=2, seed=0)
    reqs = list(request_stream(pool, 12, seed=1))
    out = {}
    for dev in ("cpu", cuda):
        svc, _ = build_service(cfg, pool=pool, device=dev)
        reset_kernel_counts()
        for r in reqs:
            assert svc.submit(r)
        res = svc.drain()
        torch.cuda.synchronize()
        out[str(dev)] = {r.request_id: r for r in res}
        assert sorted(out[str(dev)]) == list(range(12))
        counts = kernel_counts()
        if dev == cuda:
            assert counts["fixed_point"] > 0 and counts["minplus"] > 0
    for rid, c in out["cuda"].items():
        p = out["cpu"][rid]
        assert np.array_equal(c.dst, p.dst) and np.array_equal(c.is_local, p.is_local)
        np.testing.assert_allclose(c.job_total, p.job_total, rtol=1e-4)


def test_evaluator_file_on_card_matches_cpu(cuda, tmp_path):
    """One file of the committed paper dataset through the Evaluator on the
    card and on the CPU (float32, the model of record): the same 30 rows,
    `congest_jobs` identical and `tau`, `gnn_bl_ratio` and `gap_2_bl`
    each within rtol 1e-4 (`runtime` excluded)."""
    import csv

    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET
    from multihop_offload_tpu_torch.models.chebconv import load_weights, params_from_jax
    from multihop_offload_tpu_torch.train.driver import Evaluator

    rows = {}
    for dev in ("cuda", "cpu"):
        cfg = Config(datapath=PAPER_DATASET, out=str(tmp_path / dev),
                     model_root=str(tmp_path / "model"), arrival_scale=0.15)
        ev = Evaluator(cfg, device=dev)
        ev.model.load_state_dict(params_from_jax(load_weights("SCRATCH800_decay0.99")))
        with open(ev.run(files_limit=1, verbose=False), newline="") as f:
            rows[dev] = list(csv.DictReader(f))
    assert len(rows["cuda"]) == len(rows["cpu"]) == 30
    floats = ("runtime", "tau", "gnn_bl_ratio", "gap_2_bl")
    for got, want in zip(rows["cuda"], rows["cpu"]):
        assert {k: v for k, v in got.items() if k not in floats} == \
            {k: v for k, v in want.items() if k not in floats}
        for k in floats[1:]:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["baseline", "local", "gnn"])
def test_sim_card_matches_cpu_under_injected_draws(cuda, kind):
    """The `cli.sim` smoke's fleet (2 lanes of BA(8), 2 rounds x 150
    slots, a link failing at mid-horizon) built on the CPU, run on the CPU
    and on the card under the same injected draws: `baseline` and `local`
    leave every SimState counter identical, `gnn` offloads in every round
    on the CPU and agrees on >= 99% of its decisions; each run conserves
    packets with device metrics equal to its state, and the card runs K2
    (`squaring_count` launches a round) and, for `gnn`, K1 (one launch a
    round)."""
    from multihop_offload_tpu_torch.cli.sim import (
        build_scenarios,
        fields_that_differ,
        offload_share,
        run_on,
        uniform_draws,
    )
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.sim.state import conservation_gap
    from multihop_offload_tpu_torch.sim.step import DM_GENERATED

    cfg = Config(sim_policy=kind, sim_fleet=2, sim_nodes=8, sim_jobs=3, sim_rounds=2,
                 sim_slots=150, sim_util=0.4, sim_cap=64, sim_fail_links=1)
    scen = build_scenarios(cfg, "cpu")
    spec = scen["sim"].spec
    draws = uniform_draws(spec, 2, cfg.sim_rounds, cfg.sim_slots, seed=5)
    runs = []
    for dev in ("cpu", cuda):
        reset_kernel_counts()
        sim, run, rounds = run_on(cfg, scen, dev, draws)
        torch.cuda.synchronize()
        runs.append((run.state.to("cpu"), torch.stack([r[0] for r in rounds]),
                     kernel_counts(), sim.last_devmetrics))
    cpu, card = runs
    for st, _, _, flushed in (card, cpu):
        assert (conservation_gap(st) == 0).all()
        assert flushed[DM_GENERATED] == int(st.generated.sum()) > 0
    if kind == "gnn":
        assert min(offload_share(d, scen["jobss"]) for d in cpu[1]) > 0
        assert (card[1] == cpu[1]).double().mean() >= 0.99
    else:
        assert fields_that_differ(card[0], cpu[0]) == []
    per_round = {"local": 0, "baseline": tmp.squaring_count(spec.num_nodes),
                 "gnn": tmp.squaring_count(spec.num_nodes)}[kind]
    assert card[2]["minplus"] == cfg.sim_rounds * per_round
    assert card[2]["fixed_point"] == (cfg.sim_rounds if kind == "gnn" else 0)


# ---- the bf16 precision policy: K2, K6, K4 and K3 in bf16 ---------------------

BF16_ULP = 2.0 ** -8  # one bf16 unit in the last place, relative


def _bf16_weights(b, n):
    """`_weights` narrowed to bf16 with its zero diagonal (the APSP input
    of the bf16 leg)."""
    w = _weights(np.random.default_rng(n), b, n, 3.0 / n)
    d = torch.where(torch.eye(n, dtype=torch.bool), 0.0, w)
    return d.to(torch.bfloat16)


# K2's templates (`csrc/minplus.cuh`), the same in both element types:
# tile rows, tile columns, threads, k-groups, slice depth, stages
_K2_TEMPLATES = {"56x56": (56, 56, 224, 2, 32, 2), "56x28": (56, 28, 224, 4, 64, 2),
                 "64x64": (64, 64, 256, 2, 32, 3), "64x32": (64, 32, 256, 4, 64, 2)}
# the decision paths' (B, N) under bf16 (the paper batch, the service's two
# buckets, the rung's N = 256, the route cell's 304), odd N and one shape
# for every plan the launcher can pick, with the template and the bytes a
# bf16 copy moves there: 16 (tensor copies on the 56 x 56 and 64-row
# tiles), 8 where the rows or the 56 x 28 tile's columns are 8-byte
# multiples, 4 at even N, 2 (plain loads) at odd N
_K2_BF16_PLANS = {(64, 112): ("56x56", 16), (16, 56): ("strip", 16), (16, 112): ("56x28", 8),
                  (4, 256): ("64x32", 16), (4, 304): ("64x32", 16), (16, 256): ("64x64", 16),
                  (5, 37): ("strip", 2), (3, 1): ("strip", 2), (4, 33): ("strip", 2),
                  (7, 9): ("strip", 2), (4, 20): ("strip", 8), (4, 32): ("strip", 16),
                  (4, 46): ("strip", 4), (2, 64): ("strip", 16), (2, 257): ("64x32", 2)}


def _expected_plan(n, name, copy):
    """The plan fields `tmp.tile_plan` reports for template `name` at N
    (the strips: 8 x N rounded up to 8, 8 k-groups, one stage of 64)."""
    if name == "strip":
        tn = 8 * math.ceil(n / 8)
        rows, cols, threads, groups, depth, stages = 8, tn, 4 * tn, 8, 64, 1
    else:
        rows, cols, threads, groups, depth, stages = _K2_TEMPLATES[name]
    return {"tile_rows": rows, "tile_cols": cols, "threads": threads, "k_groups": groups,
            "slice": depth, "stages": stages, "copy_bytes": copy,
            "tensor_copies": int(copy == 16 and name in ("56x56", "64x64", "64x32"))}


@pytest.mark.parametrize("b,n", list(_K2_BF16_PLANS))
def test_minplus_bf16_kernel_bit_identical(cuda, b, n):
    """K2 in bf16 equals `minplus_closure_plain` in bf16 bit for bit, with a
    launch per squaring, the squarings run of `squarings_run_plain`, and the
    plan the launcher reports for the bf16 launch the template expected for
    the shape."""
    name, copy = _K2_BF16_PLANS[(b, n)]
    plan, want = tmp.tile_plan(b, n, torch.bfloat16), _expected_plan(n, name, copy)
    assert {k: plan[k] for k in want} == want
    assert plan["blocks"] == b * math.ceil(n / plan["tile_rows"]) * math.ceil(
        n / plan["tile_cols"])
    d = _bf16_weights(b, n)
    iters = tmp.squaring_count(n)
    launches = (tmp.minplus_closure_cuda.launches_bf16, tmp.minplus_closure_cuda.launches)
    ex0 = tmp.squarings_executed(torch.bfloat16)
    got = tmp.minplus_closure(d.to(cuda), iters)
    torch.cuda.synchronize()
    assert (tmp.minplus_closure_cuda.launches_bf16 - launches[0],
            tmp.minplus_closure_cuda.launches - launches[1]) == (iters, 0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), tmp.minplus_closure_plain(d, iters))
    assert torch.equal(got, tmp.minplus_closure_plain(d.to(cuda), iters))
    ran = tmp.squarings_executed(torch.bfloat16) - ex0
    assert ran == tmp.squarings_run_plain(d, iters)


@pytest.mark.parametrize("group,per_network", [("paper", 4), ("rung256", 1)])
def test_coo_apsp_bf16_kernel_bit_identical(cuda, group, per_network):
    inst, _, _ = _sparse_batch(group, per_network, slice(0, 16))
    n = inst.num_pad_nodes
    rng = np.random.default_rng(11)
    noisy = inst.link_rates * torch.from_numpy(
        rng.uniform(0.5, 2.0, tuple(inst.link_rates.shape)).astype(np.float32))
    for delays in (1.0 / inst.link_rates, 1.0 / noisy):
        d = delays.to(torch.bfloat16)
        ends, mask = inst.link_ends.to(cuda), inst.link_mask.to(cuda)
        before = (tmp.apsp_coo_cuda.launches_bf16, tmp.minplus_closure_cuda.launches_bf16,
                  tmp.apsp_coo_cuda.launches)
        got = tmp.apsp_minplus_coo(ends, mask, d.to(cuda), n)
        torch.cuda.synchronize()
        assert (tmp.apsp_coo_cuda.launches_bf16 - before[0],
                tmp.minplus_closure_cuda.launches_bf16 - before[1],
                tmp.apsp_coo_cuda.launches - before[2]) == (1, tmp.squaring_count(n), 0)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, tmp.apsp_coo_plain(ends, mask, d.to(cuda), n))
        assert torch.equal(got.cpu(), tmp.apsp_coo_plain(inst.link_ends, inst.link_mask,
                                                          d, n))


def _within_one_ulp(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= BF16_ULP * want.abs() + 1e-6).all())


@pytest.mark.parametrize("f", [4, 32])
@pytest.mark.parametrize("group,per_network", [("paper", 4), ("rung256", 1)])
def test_chebconv_bf16_kernel_within_one_ulp(cuda, group, per_network, f):
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.models.chebconv import cast_support
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    inst, _, _ = _sparse_batch(group, per_network, slice(0, 16))
    support = cast_support(sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                                    csr=inst.sparse.ext_csr),
                           torch.bfloat16)
    b, e = support.diag.shape
    rng = np.random.default_rng(f)
    x = torch.from_numpy(rng.normal(size=(b, e, f)).astype(np.float32)).to(torch.bfloat16)
    sup = support.to(cuda)
    before = (tcc.chebconv_propagate_cuda.launches_bf16, tcc.chebconv_propagate_cuda.launches)
    got = tcc.chebconv_propagate(sup, x.to(cuda))
    again = tcc.chebconv_propagate(sup, x.to(cuda))
    torch.cuda.synchronize()
    assert (tcc.chebconv_propagate_cuda.launches_bf16 - before[0],
            tcc.chebconv_propagate_cuda.launches - before[1]) == (2, 0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    e_ = sup.edges
    plain = tcc.chebconv_propagate_plain(e_.rows, e_.cols, e_.vals, sup.diag, x.to(cuda))
    cpu = tcc.chebconv_propagate_plain(support.edges.rows, support.edges.cols,
                                       support.edges.vals, support.diag, x)
    assert _within_one_ulp(got, plain) and _within_one_ulp(got.cpu(), cpu)


def _bf16_support(group, per_network, cases):
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.models.chebconv import cast_support

    inst, _, _ = _sparse_batch(group, per_network, cases)
    return cast_support(sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                                 csr=inst.sparse.ext_csr), torch.bfloat16)


# the Trainer's shapes: (64, 328, 32) and (16, 328, 4) on the paper batch,
# the rung, and the random non-symmetric lists (not sorted by column)
@pytest.mark.parametrize("case,f", [("paper", 32), ("paper16", 4), ("rung256", 32),
                                    ("random", 7)])
def test_chebconv_bf16_transposed_kernel_bit_identical(cuda, case, f):
    """K4's bf16 transposed walk equals `chebconv_transpose_bf16_plain` bit
    for bit, on the card and on the CPU, on every one of 3 calls, and is
    what `chebconv_propagate`'s backward launches on bf16 (one launch,
    counted in `launches_bf16_t`)."""
    from multihop_offload_tpu_torch.models.chebconv import cast_support
    from multihop_offload_tpu_torch.ops import chebconv as tcc

    if case == "random":
        support = cast_support(_random_coo(np.random.default_rng(5), 5, 70, 600, 0.08),
                               torch.bfloat16)
    else:
        support = _bf16_support(*{"paper": ("paper", 4, slice(0, 16)),
                                  "paper16": ("paper", 1, slice(0, 16)),
                                  "rung256": ("rung256", 1, slice(0, 16))}[case])
    b, e = support.diag.shape
    rng = np.random.default_rng(f)
    x, g = (torch.from_numpy(rng.normal(size=(b, e, f)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    sup = support.to(cuda)
    e_, csr = sup.edges, sup.csr
    gc = g.to(cuda)
    before = (tcc.chebconv_propagate_cuda.launches_bf16_t,
              tcc.chebconv_propagate_cuda.launches_bf16, tcc.chebconv_propagate_cuda.launches)
    got = [tcc.chebconv_propagate_cuda(csr.col_ptr, csr.col_order, e_.rows, e_.vals,
                                       sup.diag, gc) for _ in range(3)]
    torch.cuda.synchronize()
    assert (tcc.chebconv_propagate_cuda.launches_bf16_t - before[0],
            tcc.chebconv_propagate_cuda.launches_bf16 - before[1],
            tcc.chebconv_propagate_cuda.launches - before[2]) == (3, 0, 0)
    plain = tcc.chebconv_transpose_bf16_plain(e_.rows, e_.cols, e_.vals, sup.diag, gc)
    cpu = tcc.chebconv_transpose_bf16_plain(support.edges.rows, support.edges.cols,
                                            support.edges.vals, support.diag, g)
    for out in got:
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, plain) and torch.equal(out.cpu(), cpu)
    # through autograd: one forward and one transposed launch
    xc = x.to(cuda).requires_grad_()
    before = (tcc.chebconv_propagate_cuda.launches_bf16,
              tcc.chebconv_propagate_cuda.launches_bf16_t)
    (dx,) = torch.autograd.grad(tcc.chebconv_propagate(sup, xc), xc, gc)
    torch.cuda.synchronize()
    assert (tcc.chebconv_propagate_cuda.launches_bf16 - before[0],
            tcc.chebconv_propagate_cuda.launches_bf16_t - before[1]) == (1, 1)
    assert torch.equal(dx, plain)


@pytest.mark.parametrize("b,n,density", [(2, 384, None), (1, 1024, None), (3, 128, None),
                                         (2, 384, 0.5), (1, 384, 0.0), (2, 512, None)])
def test_blocked_fw_bf16_kernel_bit_identical(cuda, b, n, density):
    """K3 in bf16 equals `blocked_fw_plain` in bf16 bit for bit, on the card
    and on the CPU, on each of 2 calls; 3 N / 128 launches a call (the
    pivot alone at N = 128), counted in `launches_bf16`; the input is not
    written."""
    d = _fw_input(b, n, symmetric=n == 1024, density=density).to(torch.bfloat16)
    dc = d.to(cuda)
    before = (tmp.blocked_fw_cuda.launches_bf16, tmp.blocked_fw_cuda.launches)
    got = [tmp.blocked_fw_cuda(dc) for _ in range(2)]
    plain = tmp.blocked_fw_plain(dc)
    torch.cuda.synchronize()
    per_call = 3 * (n // 128) if n > 128 else 1
    assert (tmp.blocked_fw_cuda.launches_bf16 - before[0],
            tmp.blocked_fw_cuda.launches - before[1]) == (2 * per_call, 0)
    assert torch.equal(dc.cpu(), d)
    cpu = tmp.blocked_fw_plain(d)
    for out in got:
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, plain) and torch.equal(out.cpu(), cpu)
    if density == 0.0:
        assert torch.equal(got[0].cpu(), d)


@pytest.mark.parametrize("b,n", list(_K2_BF16_PLANS))
def test_minplus_fp32_kernel_bit_identical_at_the_bf16_shapes(cuda, b, n):
    """The float32 K2, which shares its body and plans with the bf16 one,
    stays bit-identical to its plain closure at the bf16 test's shapes, on
    the same template, and runs the squarings `squarings_run_plain` counts."""
    name, _ = _K2_BF16_PLANS[(b, n)]
    plan = tmp.tile_plan(b, n)
    want = _expected_plan(n, name, 16 if n % 4 == 0 else 4)
    assert {k: plan[k] for k in want} == want
    d = _bf16_weights(b, n).float()
    iters = tmp.squaring_count(n)
    counter0 = _executed()
    got = tmp.minplus_closure(d.to(cuda), iters)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tmp.minplus_closure_plain(d, iters))
    assert _executed() - counter0 == tmp.squarings_run_plain(d, iters)


@pytest.mark.parametrize("b,n,density", [(2, 384, None), (1, 1024, None), (3, 128, None),
                                         (2, 384, 0.5), (1, 384, 0.0), (2, 512, None)])
def test_blocked_fw_fp32_kernel_bit_identical_at_the_bf16_shapes(cuda, b, n, density):
    """The float32 K3, which shares its body with the bf16 one, stays
    bit-identical to `blocked_fw_plain` at the bf16 test's shapes."""
    d = _fw_input(b, n, symmetric=n == 1024, density=density)
    got = tmp.blocked_fw_cuda(d.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tmp.blocked_fw_plain(d))


def test_apsp_takes_blocked_fw_bf16_above_256(cuda):
    """Under bf16 the `'pallas'` route at N = 300 pads to 384 and runs K3 in
    bf16 (9 launches); the COO-fed APSP is K6's bf16 build at the
    128-rounded N, then K3 in bf16; both equal their plain versions bit for
    bit."""
    w = torch.from_numpy(_weights(np.random.default_rng(4), 1, 300, 4.0 / 300).numpy())
    wb = w.to(torch.bfloat16)
    before = (tmp.blocked_fw_cuda.launches_bf16, tmp.minplus_closure_cuda.launches_bf16)
    got = tmp.apsp_minplus_pallas(wb.to(cuda))
    torch.cuda.synchronize()
    assert (tmp.blocked_fw_cuda.launches_bf16 - before[0],
            tmp.minplus_closure_cuda.launches_bf16 - before[1]) == (9, 0)
    assert got.dtype == torch.bfloat16 and torch.equal(got.cpu(), tmp.apsp_minplus_pallas(wb))
    iu, ju = np.nonzero(np.triu(np.isfinite(w[0].numpy()), 1))
    ends = torch.from_numpy(np.stack([iu, ju], 1).astype(np.int32))[None]
    mask = torch.ones((1, iu.size), dtype=torch.bool)
    delays = w[0][iu, ju][None].contiguous().to(torch.bfloat16)
    before = (tmp.apsp_coo_cuda.launches_bf16, tmp.blocked_fw_cuda.launches_bf16)
    coo = tmp.apsp_minplus_coo(ends.to(cuda), mask.to(cuda), delays.to(cuda), 300)
    torch.cuda.synchronize()
    assert (tmp.apsp_coo_cuda.launches_bf16 - before[0],
            tmp.blocked_fw_cuda.launches_bf16 - before[1]) == (1, 9)
    assert torch.equal(coo.cpu(), tmp.apsp_coo_plain(ends, mask, delays, 300))
    assert torch.equal(coo.cpu(), got.cpu())


def test_bf16_sparse_train_step_launches_the_bf16_kernels(cuda):
    """`train_step` under the bf16 policy on the sparse layout (SPECTRAL_K2,
    8 episodes): K1 3 (on fp32: actor, empirical evaluator, critic), K4's
    bf16 forward 5 (one a layer), its transposed walk 4 (layer 0 needs no
    d x), K6 in bf16 1 with its squarings; no float32 K4, K6 or K2; finite
    losses, the parameters changed and still fp32."""
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.precision import resolve_precision
    from multihop_offload_tpu_torch.train.driver import train_init, train_step

    pol = resolve_precision("bf16")
    inst, jobs, _ = request_batch(load_cases("paper")[2:6], 2, seed=0, device="cpu",
                                  layout="sparse", dtype=pol.storage_dtype)
    cfg = Config(layout="sparse", batch=8, memory_size=16, precision="bf16")
    model = load_model("SPECTRAL_K2", device=cuda, layout="sparse", policy=pol)
    state = train_init(model, cfg, device=cuda)
    before = [p.detach().clone() for p in model.parameters()]
    reset_kernel_counts()
    rep = train_step(model, state, inst, jobs, cfg,
                     gen=torch.Generator(device=cuda).manual_seed(0), device=cuda,
                     precision=pol)
    torch.cuda.synchronize()
    c = kernel_counts()
    assert (c["fixed_point"], c["chebconv_bf16"], c["chebconv_bf16_t"], c["coo_apsp_bf16"],
            c["chebconv"], c["coo_apsp"], c["minplus"]) == (3, 5, 4, 1, 0, 0, 0)
    assert c["minplus_bf16"] == tmp.squaring_count(inst.num_pad_nodes)
    assert rep.replayed and torch.isfinite(rep.loss_critic).all()
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("layout,model", [("dense", "SCRATCH800_decay0.99"),
                                          ("sparse", "SPECTRAL_K2")])
def test_bf16_eval_methods_card_matches_cpu(cuda, layout, model):
    """`eval_methods` under the bf16 policy on 8 paper networks x 2 job
    sets, card against CPU: every baseline and local request's job totals,
    and >= 99% of the GNN's, within 1e-2 relative, fp32 out; K1 launched
    (on fp32), the float32 K2 not, K2 in bf16 (dense) or K4 and K6 in bf16
    (sparse) launched."""
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.precision import resolve_precision
    from multihop_offload_tpu_torch.train.driver import eval_methods

    pol = resolve_precision("bf16")
    inst, jobs, _ = request_batch(load_cases("paper")[:8], 2, seed=0, device="cpu",
                                  layout=layout, dtype=pol.storage_dtype)
    outs = {}
    for dev in ("cpu", cuda):
        m = load_model(model, device=dev, layout=layout, policy=pol)
        reset_kernel_counts()
        outs[str(dev)] = [t.cpu() for t in eval_methods(m, inst, jobs, device=dev,
                                                         layout=layout, precision=pol)]
        torch.cuda.synchronize()
        counts = kernel_counts()
    assert counts["fixed_point"] > 0 and counts["minplus"] == 0
    if layout == "sparse":
        assert counts["coo_apsp_bf16"] > 0 and counts["chebconv_bf16"] > 0
    else:
        assert counts["minplus_bf16"] > 0
    mask = jobs.mask
    for i, name in enumerate(("baseline", "local", "gnn")):
        got, want = outs["cuda"][i], outs["cpu"][i]
        assert got.dtype == torch.float32
        close = ((got - want).abs() <= 1e-2 * want.abs()) | ~mask
        share = close.all(dim=1).double().mean().item()
        assert share >= (1.0 if name != "gnn" else 0.99), (name, share)


# ---- the dataset generator's files and mho-serve's wiring on the card ---------


def _serve_on(device, root, **kw):
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.serve.workload import case_pool

    cfg = Config(serve_slots=16, serve_deadline_s=60.0, serve_model="SCRATCH800_decay0.99",
                 model_root=str(root), **kw)
    svc, _ = build_service(cfg, pool=case_pool([20, 50, 80, 110], per_size=2, seed=0),
                           device=device)
    return cfg, svc


def _answers(svc, reqs, one_by_one=False):
    out = {}
    for batch in ([[r] for r in reqs] if one_by_one else [reqs]):
        for r in batch:
            assert svc.submit(r)
        out.update({x.request_id: x for x in svc.drain()})
    return out


def _pool_requests(n, seed):
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream

    pool = case_pool([20, 50, 80, 110], per_size=2, seed=0)
    return list(request_stream(pool, n, seed=seed, arrival_scale=0.15))


def test_gpu_hot_reload_swaps_like_a_fresh_service(cuda, tmp_path):
    """A checkpoint swapped in between ticks on the card serves what a
    fresh card service built on it serves, bit for bit; the CPU service
    on it agrees (dst >= 0.99, job_total rtol 1e-4 where decisions agree)."""
    from multihop_offload_tpu_torch.train import checkpoints as ckpt

    cfg, svc = _serve_on(cuda, tmp_path)
    reqs = _pool_requests(48, seed=3)
    _answers(svc, reqs[:16])
    params = {k: v.detach().cpu() * 1.25 for k, v in svc.executor.model.state_dict().items()}
    ckpt.save_checkpoint(os.path.join(cfg.model_dir(), "torch"), 1,
                         {"params": params, "step": 1})
    before = tfp.fixed_point_cuda.launches, tmp.minplus_closure_cuda.launches
    assert svc.hot_reload(cfg.model_dir()) == 1
    swapped = _answers(svc, reqs[16:])
    assert tfp.fixed_point_cuda.launches > before[0]
    assert tmp.minplus_closure_cuda.launches > before[1]
    _, fresh = _serve_on(cuda, tmp_path)
    assert fresh.executor.loaded_step == 1
    again = _answers(fresh, reqs[16:])
    _, cpu = _serve_on("cpu", tmp_path)
    on_cpu = _answers(cpu, reqs[16:])
    n = agree = 0
    for rid, r in swapped.items():
        for f in ("dst", "is_local", "delay_est", "job_total"):
            assert np.array_equal(getattr(r, f), getattr(again[rid], f))
        same = np.array_equal(r.dst, on_cpu[rid].dst)
        n += r.dst.size
        agree += int((r.dst == on_cpu[rid].dst).sum())
        if same:
            np.testing.assert_allclose(r.job_total, on_cpu[rid].job_total, rtol=1e-4)
    assert agree / n >= 0.99


def test_gpu_prob_answers_do_not_depend_on_batching(cuda, tmp_path):
    """prob=True on the card: each request's answer is the same served
    among 16 in one tick and served alone."""
    _, svc = _serve_on(cuda, tmp_path, prob=True, seed=7)
    reqs = [r for r in _pool_requests(400, seed=5)
            if svc.buckets.bucket_for(*r.sizes) == 1][:16]
    together = _answers(svc, reqs)
    alone = _answers(svc, reqs, one_by_one=True)
    assert sorted(together) == sorted(alone) and len(together) == 16
    for rid, r in together.items():
        for f in ("dst", "is_local", "delay_est", "job_total"):
            assert np.array_equal(getattr(r, f), getattr(alone[rid], f))


def test_gpu_evaluator_on_regenerated_dataset(cuda, tmp_path):
    """The paper dataset written again on this host (no networkx needed)
    gives the Evaluator on the card the rows of the committed files."""
    import csv

    from multihop_offload_tpu_torch.cli.datagen import generate_dataset
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET
    from multihop_offload_tpu_torch.models.chebconv import load_weights, params_from_jax
    from multihop_offload_tpu_torch.train.driver import Evaluator

    d = str(tmp_path / "paper")
    generate_dataset(d, "ba", size=2, seed0=500, verbose=False)
    rows = []
    for tag, datapath in (("regen", d), ("committed", PAPER_DATASET)):
        cfg = Config(datapath=datapath, out=str(tmp_path / tag), model_root=str(tmp_path / "m"),
                     arrival_scale=0.15, T=1000, num_instances=10)
        ev = Evaluator(cfg, device=cuda)
        ev.model.load_state_dict(params_from_jax(load_weights("SCRATCH800_decay0.99")))
        with open(ev.run(files_limit=2, verbose=False), newline="") as f:
            rows.append(list(csv.DictReader(f)))
    assert len(rows[0]) == len(rows[1]) == 60
    floats = ("tau", "gap_2_bl", "gnn_bl_ratio")
    for a, b in zip(*rows):
        assert {k: v for k, v in a.items() if k not in floats + ("runtime",)} == \
            {k: v for k, v in b.items() if k not in floats + ("runtime",)}
        np.testing.assert_allclose([float(a[k]) for k in floats],
                                   [float(b[k]) for k in floats], rtol=1e-6)


def test_serve_devices_two_ids_on_one_card_raise(cuda):
    """`serve_devices = "0,1"` on a machine with one card raises JAX's
    "not present" error instead of falling back; `serve_mesh = 2` likewise
    (two shards on one card take `devices=[cuda:0] * 2`)."""
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.serve.workload import case_pool

    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one CUDA card")
    pool = case_pool([10, 16], per_size=1, seed=0)
    with pytest.raises(ValueError, match=r"serve_devices \[1\] not present"):
        build_service(Config(serve_devices="0,1"), pool=pool)
    with pytest.raises(ValueError, match="CUDA devices present"):
        build_service(Config(serve_mesh=2), pool=pool)


def test_sharded_service_on_the_card_decides_as_one_device(cuda):
    """The service over `[cuda:0] * 2` against the one-device service on
    the card: every request answered once, identical decisions, floats
    within 1e-4, K1 and K2 launched twice as often (once per shard), the
    same squarings."""
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.serve.placement import PlacementPlan
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream

    cfg = Config(serve_slots=4, serve_queue_cap=64, serve_deadline_s=60.0,
                 serve_model="SCRATCH800_decay0.99", serve_replan_ticks=10**9)
    pool = case_pool([20, 50], per_size=2, seed=0)
    reqs = list(request_stream(pool, 12, seed=1))
    out, counts = {}, {}
    for tag, kw in (("one", {"device": cuda}), ("sharded", {"devices": [cuda] * 2})):
        svc, _ = build_service(cfg, pool=pool, **kw)
        if tag == "sharded":  # both buckets over both fleet members
            svc.executor.set_placement(PlacementPlan(((0, 1),) * len(svc.buckets)))
        reset_kernel_counts()
        for r in reqs:
            assert svc.submit(r)
        res = svc.drain()
        torch.cuda.synchronize()
        counts[tag] = kernel_counts()
        out[tag] = {r.request_id: r for r in res}
        assert sorted(out[tag]) == list(range(12))
    assert svc.executor.last_devices_used == 2
    for k in ("fixed_point", "minplus"):
        assert counts["sharded"][k] == 2 * counts["one"][k] > 0
    assert counts["sharded"]["squarings"] == counts["one"]["squarings"] > 0
    for rid, a in out["sharded"].items():
        b = out["one"][rid]
        np.testing.assert_array_equal(a.dst, b.dst)
        np.testing.assert_array_equal(a.is_local, b.is_local)
        assert (a.served_by, a.bucket) == (b.served_by, b.bucket) and a.shard in ("0", "1")
        np.testing.assert_allclose(a.job_total, b.job_total, rtol=1e-4)


def test_gpu_loop_smoke_promotes_and_rolls_back(cuda, tmp_path):
    """`mho-loop --smoke` on the card: capture over rotated segments,
    refit (K1, K2), validate, canary, promote, the injected regression,
    rollback; the run's launches include K1 and K2."""
    from multihop_offload_tpu_torch.cli import loop as loop_cli
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts

    reset_kernel_counts()
    out = loop_cli.run_smoke(Config(seed=0), device=cuda, tmp=str(tmp_path))
    torch.cuda.synchronize()
    counts = kernel_counts()
    assert out["ok"] and out["device"].startswith("cuda")
    assert out["cycles"][0]["promoted_step"] == 2 and out["cycles"][0]["rollback_step"] == 3
    assert counts["fixed_point"] > 0 and counts["minplus"] > 0


def test_gpu_refit_matches_cpu(cuda, tmp_path):
    """Two refit steps on the card from captured outcomes: the candidate
    within 1e-4 (scaled) of the same refit on the CPU, K1 and K2 launched."""
    import dataclasses

    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch.cli import loop as loop_cli
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.loop.experience import read_outcomes
    from multihop_offload_tpu_torch.loop.refit import refit

    cfg = dataclasses.replace(loop_cli.smoke_config(Config(seed=0), str(tmp_path)),
                              learning_rate=1e-3, serve_model="SCRATCH800_decay0.99")
    runlog = obs.start_run(cfg, role="loop")
    try:
        svc, pool = build_service(cfg, device=cuda)
        loop_cli._capture_window(cfg, svc, pool, 8, 0)
    finally:
        obs.finish_run(runlog)
    outcomes = read_outcomes(cfg.obs_log)
    assert len(outcomes) == 8
    champion = {k: v.detach().clone() for k, v in svc.executor.model.state_dict().items()}
    reset_kernel_counts()
    card, info = refit(svc.executor.model, {"params": champion}, outcomes, cfg, device=cuda)
    torch.cuda.synchronize()
    counts = kernel_counts()
    cpu, _ = refit(svc.executor.model.cpu(), {"params": champion}, outcomes, cfg,
                   device="cpu")
    assert counts["fixed_point"] > 0 and counts["minplus"] > 0 and info["skipped_updates"] == 0
    for k, v in cpu["params"].items():
        err = float((card["params"][k].cpu() - v).abs().max() / v.abs().max().clamp_min(1e-30))
        assert err <= 1e-4, (k, err)


# ---- K2's backward (csrc/minplus_bwd.cu) -------------------------------------


def _diff_grads(w, c, iters, fn):
    """d/dW of sum(sp * c) over the finite entries, sp = `fn(zeroed W)`."""
    x = w.clone().requires_grad_()
    d = torch.where(torch.eye(w.shape[-1], dtype=torch.bool, device=w.device), 0.0, x)
    sp = fn(d.contiguous(), iters)
    ct = torch.where(torch.isfinite(sp), c, 0.0)
    (g,) = torch.autograd.grad(sp, x, grad_outputs=ct)
    return sp.detach(), g


def _hops(b, n, seed):
    """A tie-heavy matrix: hop weights 1 on a ring plus random chords."""
    rng = np.random.default_rng(seed)
    w = np.full((b, n, n), np.inf, dtype=np.float32)
    for k in range(b):
        pairs = [(i, (i + 1) % n) for i in range(n)]
        iu, ju = np.where(np.triu(rng.uniform(size=(n, n)) < 2.0 / n, 2))
        for i, j in list(zip(iu, ju)) + pairs:
            w[k, i, j] = w[k, j, i] = 1.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("b,n,ties", [(4, 16, False), (4, 112, False), (16, 112, False),
                                      (4, 112, True), (3, 7, False), (5, 37, False),
                                      (2, 256, False), (4, 64, True)])
def test_minplus_backward_kernel_matches_plain(cuda, b, n, ties):
    """K2 forward and K2's backward (the autograd Function of
    `minplus_closure_diff`) against autograd through the plain squarings
    on the same card tensors: the distances bit for bit, the gradient
    within 1e-5 of its largest entry, the same bits on a second call,
    `bwd_launches(iters)` launches (the first squaring's tie pass, one fused
    split-and-gather a squaring)."""
    w = (_hops(b, n, n) if ties else _weights(np.random.default_rng(n), b, n, 3.0 / n))
    w = w.to(cuda)
    c = torch.from_numpy(np.random.default_rng(n + 1).uniform(0.5, 1.5, (b, n, n))
                         .astype(np.float32)).to(cuda)
    iters = tmp.squaring_count(n)
    before = tmp.minplus_closure_bwd_cuda.launches
    sp, g = _diff_grads(w, c, iters, tmp.minplus_closure_diff)
    assert tmp.minplus_closure_bwd_cuda.launches == before + tmp.bwd_launches(iters)
    _, again = _diff_grads(w, c, iters, tmp.minplus_closure_diff)
    sp_ref, g_ref = _diff_grads(w, c, iters, tmp.minplus_closure_diff_plain)
    torch.cuda.synchronize()
    assert torch.equal(sp, sp_ref)
    assert torch.equal(g, again)
    assert torch.isfinite(g).all()
    scale = float(g_ref.abs().max())
    assert float((g - g_ref).abs().max()) <= 1e-5 * max(scale, 1e-30)


def test_minplus_backward_through_skipped_squarings(cuda):
    """A schedule far past the fixed point (12 squarings of 10-node rings
    with weights in {1, 2}, fixed after 3): K2 skips the squarings after
    it, and the backward still takes every squaring's VJP at the fixed
    point, as the plain version does (and 4 squarings give another
    gradient)."""
    rng = np.random.default_rng(0)
    n = 10
    w = np.full((3, n, n), np.inf, dtype=np.float32)
    for k in range(3):
        for i in range(n):
            w[k, i, (i + 1) % n] = w[k, (i + 1) % n, i] = float(rng.integers(1, 3))
    w = torch.from_numpy(w).to(cuda)
    c = torch.from_numpy(rng.uniform(0.5, 1.5, (3, n, n)).astype(np.float32)).to(cuda)
    ex0 = _executed()
    sp, g = _diff_grads(w, c, 12, tmp.minplus_closure_diff)
    assert _executed() - ex0 == 3 * 4  # squarings 4-11 of every matrix ran no tile
    sp_ref, g_ref = _diff_grads(w, c, 12, tmp.minplus_closure_diff_plain)
    _, g4 = _diff_grads(w, c, 4, tmp.minplus_closure_diff_plain)
    assert torch.equal(sp, sp_ref)
    assert float((g - g_ref).abs().max()) <= 1e-5 * float(g_ref.abs().max())
    assert not torch.allclose(g_ref, g4)  # the VJP at the fixed point is not the identity


@pytest.mark.parametrize("b,n,ties,extra,diag", [(4, 16, False, 0, 0.0), (4, 112, False, 0, 0.0),
                                                 (16, 112, False, 0, 0.0), (4, 112, True, 0, 0.0),
                                                 (5, 37, False, 3, 0.0), (3, 10, True, 8, 0.0),
                                                 (4, 112, True, 0, 0.25), (3, 37, False, 2, 0.5)])
def test_minplus_backward_kernel_matches_plain_passes(cuda, b, n, ties, extra, diag):
    """K2's backward alone on the stack K2 forward saves, against the same
    passes in plain torch (`minplus_closure_bwd_plain`: the tie data, then
    the fused split and gather a squaring, on the tie data of slice
    min(s, lead[b])) on the same card tensors, within 1e-5 of the largest entry,
    also `extra` squarings past the default schedule, and with a positive
    diagonal `diag` (M may exceed D there: the tie pass takes its general
    form, and G's direct share its D < M side)."""
    w = (_hops(b, n, n) if ties else _weights(np.random.default_rng(n), b, n, 3.0 / n))
    d = torch.where(torch.eye(n, dtype=torch.bool), diag, w).contiguous().to(cuda)
    iters = tmp.squaring_count(n) + extra
    out, stack, step_elems, lead = tmp._minplus_closure_saved(d, iters)
    c = torch.from_numpy(np.random.default_rng(n + 2).uniform(0.5, 1.5, (b, n, n))
                         .astype(np.float32)).to(cuda)
    ct = torch.where(torch.isfinite(out), c, 0.0)
    before = tmp.minplus_closure_bwd_cuda.launches
    g = tmp.minplus_closure_bwd_cuda(stack, step_elems, lead, ct, iters)
    assert tmp.minplus_closure_bwd_cuda.launches == before + tmp.bwd_launches(iters)
    want = tmp.minplus_closure_bwd_plain(stack, step_elems, lead, ct, iters)
    torch.cuda.synchronize()
    assert torch.isfinite(g).all()
    assert float((g - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1e-30)


def test_gpu_rl_train_step_launches_k2_backward(cuda):
    """One `RLTrainer` step on the card and on the CPU (the CPU smoke's
    fleet, fleet 2, at a temperature on the cost table's scale, where the
    gradient flows) under the same injected draws: K1, K2 and K2's
    backward launch, the gradient is nonzero, each lane whose choices all
    agree has the CPU's gradient within 1e-3 of its norm, and the update
    is applied and finite."""
    import dataclasses

    from multihop_offload_tpu_torch.cli import rl as rl_cli
    from multihop_offload_tpu_torch.cli.sim import uniform_draws
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.rl import RLTrainer
    from multihop_offload_tpu_torch.rl.rollout import gumbel_noise
    from multihop_offload_tpu_torch.sim.runner import InjectedDraws

    cfg = dataclasses.replace(Config(), **{**rl_cli.SMOKE, "rl_fleet": 2, "rl_slots": 20,
                                           "rl_temp": 1000.0})
    fleet = rl_cli.build_fleet(cfg, "cpu")
    insts, jobss, paramss, spec, _ = fleet
    model = rl_cli.make_rl_model(cfg, insts, jobss)
    draws = uniform_draws(spec, cfg.rl_fleet, cfg.rl_rounds, cfg.rl_slots, seed=5)
    gumbel = gumbel_noise([torch.Generator().manual_seed(6)],
                          (cfg.rl_fleet, cfg.rl_rounds, spec.num_jobs,
                           insts.servers.shape[1] + 1), torch.float32, "cpu")

    def step(where):
        import copy

        tr = RLTrainer(cfg, copy.deepcopy(model).to(where), spec, devmetrics=False)
        before = {k: v.clone() for k, v in tr.params.items()}
        reset_kernel_counts()
        out = tr.train_step(*(x.to(where) for x in fleet[:3]),
                            InjectedDraws(*[x.to(where) for x in draws]),
                            gumbel=gumbel.to(where))
        return tr, before, out, kernel_counts()

    _, _, ref, _ = step("cpu")
    tr, before, out, counts = step(cuda)
    assert counts["fixed_point"] == cfg.rl_rounds
    assert counts["minplus"] == cfg.rl_rounds * tmp.squaring_count(spec.num_nodes)
    assert counts["minplus_bwd"] == cfg.rl_rounds * tmp.bwd_launches(
        tmp.squaring_count(spec.num_nodes))
    assert float(ref.grad_norms.min()) > 0
    agree = (out.dsts.cpu() == ref.dsts).flatten(1).all(dim=1)
    assert agree.any()
    for i in torch.nonzero(agree).flatten().tolist():
        diff = sum(float((out.grads[k][i].cpu() - g[i]).pow(2).sum())
                   for k, g in ref.grads.items())
        norm = sum(float(g[i].pow(2).sum()) for g in ref.grads.values())
        assert diff ** 0.5 <= 1e-3 * norm ** 0.5
    assert out.skipped == 0 and all(torch.isfinite(v).all() for v in tr.params.values())
    assert any(not torch.equal(before[k], v) for k, v in tr.params.items())


# ---- the scenario matrix (scenarios/) ----------------------------------------


def test_gpu_energy_matrix_leg_matches_cpu(cuda):
    """One matrix leg under the energy objective (`grid_energy`, 2 lanes, 2
    segments of 80 slots) on the card and on the CPU under the same
    injected uniforms: conservation exact, K1 and K2 launched as often as
    the plain versions are called on the CPU, and every lane's counts and
    `dst` equal the CPU's."""
    import chip_smoke
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.large_scale import kernel_counts, reset_kernel_counts
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.scenarios.matrix import run_matrix, uniform_draws

    registry().reset()  # one queue-depth histogram cap a process
    shapes = dict(scenario_fleet=2, scenario_segments=2, scenario_rounds=1,
                  scenario_slots=80)

    def run(dev):
        return run_matrix(Config(), False, device=dev, names=["grid_energy"], shapes=shapes,
                          draws=uniform_draws(3, dev))["scenarios"][0]

    reset_kernel_counts()
    card = run(cuda)
    counts = kernel_counts()
    cpu, plain = chip_smoke.count_plain(lambda: run("cpu"))
    assert card["conservation_ok"] and cpu["conservation_ok"]
    for key in ("fixed_point", "minplus"):
        assert counts[key] == plain[key] > 0, (key, counts, plain)
    for kind, row in card["sim"].items():
        assert row["per_lane"] == cpu["sim"][kind]["per_lane"], kind
