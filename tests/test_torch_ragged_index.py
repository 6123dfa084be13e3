"""PyTorch port, K5's index: the plain version of the on-card stable sort
(`ops/chebconv.py:ragged_index_plain`) and of the row walk it feeds
(`chebconv_walk_plain`), on the CPU.

The sort must equal numpy's stable argsort exactly, agree with the host
CSR index of the sparse layout (`layouts/sparse.py:csr_index`) on
row-sorted lists, and, walked by the plain walk, give K5's plain version
bit for bit (float32) and the JAX package's `_xla_propagate` within 1e-12
(float64).  The CUDA kernels are held against these plain versions on the
card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu_torch.ops import chebconv as tcc
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401


def _numpy_index(keys, live, num_rows):
    """(ptr, order) of one slot by numpy: keys past live, or out of
    [0, num_rows), sort last as num_rows; stable argsort."""
    k = np.where((np.arange(keys.size) < live) & (keys >= 0) & (keys < num_rows),
                 keys, num_rows)
    ptr = np.zeros(num_rows + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(k, minlength=num_rows + 1))[:num_rows]
    return ptr, np.argsort(k, kind="stable")


def _lists(rng, b, e, cap, shuffle, live_mode, empty_rows=True):
    """(B, cap) lists: each slot a random support's entries in `np.nonzero`
    order (rows sorted) or permuted, the inert (0, 0, 0) tail after them;
    with `empty_rows` a third of the rows hold no entry."""
    rows = np.zeros((b, cap), np.int32)
    cols = np.zeros((b, cap), np.int32)
    vals = np.zeros((b, cap), np.float64)
    real = np.zeros(b, np.int32)
    for k in range(b):
        mat = rng.uniform(size=(e, e)) < min(0.9, 0.6 * cap / (e * e))
        if empty_rows:
            mat[rng.permutation(e)[: e // 3]] = False
        r, c = np.nonzero(mat)
        n = min(r.size, cap)
        order = rng.permutation(n) if shuffle else np.arange(n)
        rows[k, :n], cols[k, :n] = r[:n][order], c[:n][order]
        vals[k, :n] = rng.normal(size=n)
        real[k] = n
    live = {"zero": np.zeros(b, np.int32), "partial": real // 2,
            "real": real, "capacity": np.full(b, cap, np.int32)}[live_mode]
    return rows, cols, vals, live


def _jax_ragged_case():
    """The JAX ragged test's case (`tests/test_ops.py`: n=12, 17 live
    entries in random row order, capacity 300, seed 37)."""
    rng = np.random.default_rng(37)
    rows = np.zeros((1, 300), np.int32)
    cols = np.zeros((1, 300), np.int32)
    vals = np.zeros((1, 300), np.float64)
    rows[0, :17] = rng.integers(0, 12, 17)
    cols[0, :17] = rng.integers(0, 12, 17)
    vals[0, :17] = rng.normal(size=17)
    return rows, cols, vals, np.array([17], np.int32), 12


def _case(name):
    if name == "jax-ragged":
        return _jax_ragged_case()
    if name == "service":  # the sparse service's bucket 1: 16 slots, E=328, cap 5,248
        return _lists(np.random.default_rng(16), 16, 328, 5248, True, "real") + (328,)
    order, live_mode = name.split("-")
    rng = np.random.default_rng(len(name))
    return _lists(rng, 4, 40, 256, order == "permuted", live_mode) + (40,)


CASES = [f"{o}-{m}" for o in ("sorted", "permuted")
         for m in ("zero", "partial", "real", "capacity")] + ["service", "jax-ragged"]


@pytest.mark.parametrize("name", CASES)
def test_ragged_index_plain_is_numpys_stable_argsort(name):
    rows, cols, _, live, e = _case(name)
    idx = tcc.ragged_index_plain(torch.from_numpy(rows), torch.from_numpy(cols),
                                 torch.from_numpy(live), e)
    for field in ("row_ptr", "row_order", "col_ptr", "col_order"):
        assert getattr(idx, field).dtype == torch.int32
    for k in range(rows.shape[0]):
        for keys, ptr, order in ((rows, idx.row_ptr, idx.row_order),
                                 (cols, idx.col_ptr, idx.col_order)):
            want_ptr, want_order = _numpy_index(keys[k], live[k], e)
            np.testing.assert_array_equal(ptr[k].numpy(), want_ptr)
            np.testing.assert_array_equal(order[k].numpy(), want_order)


def test_ragged_index_plain_puts_out_of_range_keys_last():
    """A live entry whose row is out of [0, E) sorts with the tail, in list
    order: the walk, which stops at ptr[E], never reads it."""
    rows = torch.tensor([[3, -1, 0, 7, 3, 2, 0, 0]], dtype=torch.int32)
    cols = torch.tensor([[0, 1, 2, 3, 9, 5, 0, 0]], dtype=torch.int32)
    idx = tcc.ragged_index_plain(rows, cols, torch.tensor([6], dtype=torch.int32), 4)
    assert idx.row_ptr.tolist() == [[0, 1, 1, 2, 4]]
    assert idx.row_order.tolist() == [[2, 5, 0, 4, 1, 3, 6, 7]]
    assert idx.col_ptr.tolist() == [[0, 1, 2, 3, 4]]
    assert idx.col_order.tolist() == [[0, 1, 2, 3, 4, 5, 6, 7]]


def test_ragged_index_plain_matches_host_csr_on_row_sorted_lists():
    """On lists whose real entries come first, sorted by row (the sparse
    layout's lists), the sort at the real count is the host CSR index."""
    from multihop_offload_tpu_torch._records import stack_records
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.layouts.sparse import _coo_from_dense_np, csr_index

    rng = np.random.default_rng(11)
    coos = [_coo_from_dense_np(np.where(rng.uniform(size=(50, 50)) < 0.1,
                                        rng.normal(size=(50, 50)), 0.0), 400, np.float32)
            for _ in range(3)]
    random = (stack_records(coos), stack_records([csr_index(c) for c in coos]))
    inst, _, _ = request_batch(load_cases("paper")[:3], 1, seed=0, device="cpu",
                               layout="sparse")
    for coo, csr in (random, (inst.sparse.ext, inst.sparse.ext_csr)):
        live = (coo.vals != 0).sum(1).to(torch.int32)
        idx = tcc.ragged_index_plain(coo.rows, coo.cols, live, csr.row_ptr.shape[1] - 1)
        assert torch.equal(idx.row_ptr, csr.row_ptr)
        assert torch.equal(idx.col_ptr, csr.col_ptr)
        for k, n in enumerate(live.tolist()):
            assert torch.equal(idx.col_order[k, :n], csr.col_order[k, :n])
            assert torch.equal(idx.row_order[k, :n], torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("name", ["sorted-partial", "permuted-real", "permuted-capacity",
                                  "service", "jax-ragged"])
@pytest.mark.parametrize("f", [4, 32])
def test_walk_over_the_sort_is_k5_plain_bit_for_bit(name, f):
    """float32: the plain walk over the sort's row index gives K5's plain
    version bit for bit, and over its column index the propagate of the
    swapped list (what the backward's d x walks)."""
    rows, cols, vals, live, e = _case(name)
    rng = np.random.default_rng(f)
    b = rows.shape[0]
    t = torch.from_numpy
    r, c, lv = t(rows), t(cols), t(live)
    v = t(vals.astype(np.float32))
    diag = t(rng.normal(size=(b, e)).astype(np.float32))
    x = t((10 * rng.normal(size=(b, e, f))).astype(np.float32))
    idx = tcc.ragged_index_plain(r, c, lv, e)
    got = tcc.chebconv_walk_plain(idx.row_ptr, idx.row_order, c, v, diag, x)
    assert torch.equal(got, tcc.chebconv_propagate_ragged_plain(r, c, v, diag, x, lv))
    got_t = tcc.chebconv_walk_plain(idx.col_ptr, idx.col_order, r, v, diag, x)
    assert torch.equal(got_t, tcc.chebconv_propagate_ragged_plain(c, r, v, diag, x, lv))


@pytest.mark.parametrize("name", ["permuted-partial", "service", "jax-ragged"])
def test_walk_over_the_sort_matches_jax_float64(name):
    """float64: the walk over the sort within 1e-12 of the JAX package's
    `_xla_propagate` over the live prefix (the tail masked inert)."""
    from multihop_offload_tpu.ops.chebconv import _xla_propagate

    rows, cols, vals, live, e = _case(name)
    rng = np.random.default_rng(5)
    b = rows.shape[0]
    diag = rng.normal(size=(b, e))
    x = rng.normal(size=(b, e, 6))
    keep = np.arange(rows.shape[1]) < live[:, None]
    mr, mc, mv = np.where(keep, rows, 0), np.where(keep, cols, 0), np.where(keep, vals, 0.0)
    t = torch.from_numpy
    idx = tcc.ragged_index_plain(t(rows), t(cols), t(live), e)
    got = tcc.chebconv_walk_plain(idx.row_ptr, idx.row_order, t(cols), t(vals), t(diag), t(x))
    want = jax.vmap(lambda r_, c_, v_, d_, x_: _xla_propagate(r_, c_, v_, d_, x_, jnp.float64))(
        mr, mc, mv, diag, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_walk_plain_over_host_csr_is_k4_plain():
    """The walk's plain version over K4's host CSR index: the forward
    (order null) and the transposed walk through col_order equal
    `propagate_edges` of the list and of the swapped list."""
    from multihop_offload_tpu_torch._records import stack_records
    from multihop_offload_tpu_torch.layouts.sparse import _coo_from_dense_np, csr_index

    rng = np.random.default_rng(3)
    coos = [_coo_from_dense_np(np.where(rng.uniform(size=(70, 70)) < 0.08,
                                        rng.normal(size=(70, 70)), 0.0), 600, np.float32)
            for _ in range(5)]
    coo = stack_records(coos)
    csr = stack_records([csr_index(c) for c in coos])
    diag = torch.from_numpy(rng.normal(size=(5, 70)).astype(np.float32))
    x = torch.from_numpy((10 * rng.normal(size=(5, 70, 7))).astype(np.float32))
    fwd = tcc.chebconv_walk_plain(csr.row_ptr, None, coo.cols, coo.vals, diag, x)
    assert torch.equal(fwd, tcc.chebconv_propagate_plain(coo.rows, coo.cols, coo.vals, diag, x))
    bwd = tcc.chebconv_walk_plain(csr.col_ptr, csr.col_order, coo.rows, coo.vals, diag, x)
    assert torch.equal(bwd, tcc.chebconv_propagate_plain(coo.cols, coo.rows, coo.vals, diag, x))


def test_sort_wrapper_refuses_cpu_tensors_and_sizes_above_its_caps():
    rows, cols, _, live, e = _case("permuted-real")
    r, c, lv = (torch.from_numpy(a) for a in (rows, cols, live))
    before = (tcc.ragged_index_cuda.launches, tcc.chebconv_propagate_cuda.launches)
    with pytest.raises(ValueError, match="one CUDA device"):
        tcc.ragged_index_cuda(r, c, lv, e)
    with pytest.raises(ValueError, match="caps"):
        tcc.ragged_index_cuda(r, c, lv, tcc.RAGGED_MAX_ROWS + 1)
    big = torch.zeros((1, tcc.RAGGED_MAX_CAP + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="caps"):
        tcc.ragged_index_cuda(big, big, torch.zeros(1, dtype=torch.int32), e)
    x = torch.zeros((rows.shape[0], e, 3))
    with pytest.raises(ValueError, match="one CUDA device"):
        tcc.chebconv_propagate_ragged_cuda(r, c, torch.zeros(rows.shape), x[..., 0], x, lv)
    assert (tcc.ragged_index_cuda.launches, tcc.chebconv_propagate_cuda.launches) == before
