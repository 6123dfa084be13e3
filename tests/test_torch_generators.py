"""PyTorch port, the graph generators and cuts without networkx, against
the JAX package (which draws with networkx 3.6.1) on the CPU.

- every family of `generate` at seeds 0-4 and n in {20, 50, 110}: the
  adjacency bit for bit, and positions exactly where the family has them;
- a draw that takes the densify-and-retry path: `DisconnectedGraphWarning`
  in both packages and the same (denser, connected) adjacency;
- `generate`'s errors and the families' own, message for message;
- `spring_positions` against the JAX function (which calls
  `nx.spring_layout`) within 1e-12 at n = 50 (the force iteration) and
  n = 520 (the energy form, scipy's L-BFGS-B), and its `.npy` cache;
- `minimum_node_cut` and `stoer_wagner` against networkx's cut sets,
  cut values and partition lists, in order, on 30 BA, WS and ER graphs.
"""

import warnings

import networkx as nx
import numpy as np
import pytest

from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu_torch.graphs import cuts
from multihop_offload_tpu_torch.graphs import generators as tgen

FAMILIES = ("ba", "grp", "ws", "er", "poisson", "grid", "corridor", "two_tier")
POS_TOL = 1e-12


def _draw(mod, *args, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = mod.generate(*args, **kw)
    return out, [w.category.__name__ for w in caught]


@pytest.mark.parametrize("n", (20, 50, 110))
@pytest.mark.parametrize("family", FAMILIES)
def test_generate_equals_jax(family, n):
    for seed in range(5):
        (a, pa), wa = _draw(tgen, family, n, seed)
        (b, pb), wb = _draw(jgen, family, n, seed)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=f"{family} n={n} seed={seed}")
        assert wa == wb
        if pb is None:
            assert pa is None
        else:
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("family,kw", (("er", {"degree": 1.5}),
                                       ("grp", {"p_in": 0.02, "p_out": 0.005})))
def test_retry_path_warns_and_matches(family, kw):
    (a, _), wa = _draw(tgen, family, 50, 0, **kw)
    (b, _), wb = _draw(jgen, family, 50, 0, **kw)
    assert wa == wb == ["DisconnectedGraphWarning"]
    np.testing.assert_array_equal(a, b)
    assert tgen._is_connected(a)


def _error(mod, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(Exception) as ei:
            mod.generate(*args, **kw)
    return str(ei.value)


@pytest.mark.parametrize("args,kw", [
    (("mesh", 20, 0), {}),
    (("ws", 20, 0), {"m": 3}),
    (("er", 20, 0), {"k": 3}),
    (("ba", 20, 0), {"p": 0.1}),
    (("grid", 20, 0), {"aspect": 0.0}),
    (("corridor", 20, 0), {"width": 0}),
    (("two_tier", 5, 0), {"core": 5}),
    (("ba", 3, 0), {"m": 3}),
    (("grp", 10, 0), {}),
    (("ws", 5, 0), {"k": 6}),
])
def test_generate_errors_equal_jax(args, kw):
    assert _error(tgen, *args, **kw) == _error(jgen, *args, **kw)


def test_generate_legacy_m_and_registry():
    a, _ = tgen.generate("BA", 30, 4, m=3)
    b, _ = jgen.generate("ba", 30, 4, m=3)
    np.testing.assert_array_equal(a, b)
    a, pa = tgen.generate("poisson", 30, 4, m=6)
    b, pb = jgen.generate("poisson", 30, 4, m=6)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pa, pb)
    assert sorted(tgen.GENERATORS) == sorted(jgen.GENERATORS)
    for name in tgen.GENERATORS:
        np.testing.assert_array_equal(tgen.GENERATORS[name](24, 2)[0],
                                      jgen.GENERATORS[name](24, 2)[0])
    a, pa, nb = tgen.connected_poisson_disk(40, seed=3)
    b, pb, nb_j = jgen.connected_poisson_disk(40, seed=3)
    np.testing.assert_array_equal(a, b)
    assert nb == nb_j


@pytest.mark.parametrize("n,family", ((50, "ba"), (520, "ba")))
def test_spring_positions_equal_jax(n, family, tmp_path):
    adj, _ = tgen.generate(family, n, 7)
    got = tgen.spring_positions(adj, seed=7)
    want = jgen.spring_positions(adj, seed=7)
    assert got.shape == want.shape == (n, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_TOL)
    # the cache: written once, read back, recomputed when fresh
    cached = tgen.spring_positions(adj, seed=7, cache_dir=str(tmp_path), name="g")
    np.testing.assert_array_equal(cached, got)
    assert (tmp_path / "g.npy").exists()
    np.save(tmp_path / "g.npy", np.zeros((n, 2)))
    assert not tgen.spring_positions(adj, seed=7, cache_dir=str(tmp_path), name="g").any()
    again = tgen.spring_positions(adj, seed=7, cache_dir=str(tmp_path), name="g",
                                  fresh=True)
    np.testing.assert_array_equal(again, got)


def test_spring_positions_tiny_graphs():
    np.testing.assert_array_equal(tgen.spring_positions(np.zeros((1, 1), np.uint8), seed=0),
                                  jgen.spring_positions(np.zeros((1, 1), np.uint8), seed=0))
    adj = np.array([[0, 1], [1, 0]], np.uint8)
    np.testing.assert_allclose(tgen.spring_positions(adj, seed=1),
                               jgen.spring_positions(adj, seed=1), rtol=0, atol=POS_TOL)


@pytest.mark.parametrize("family", ("ba", "ws", "er"))
def test_cuts_equal_networkx(family):
    for i in range(10):
        n = 20 + 9 * i
        adj, _ = tgen.generate(family, n, 100 + i)
        g = nx.from_numpy_array(adj)
        assert cuts.minimum_node_cut(adj) == nx.minimum_node_cut(g)
        value, partition = cuts.stoer_wagner(adj)
        want_value, want_partition = nx.stoer_wagner(g)
        assert value == want_value
        assert partition == want_partition  # the same lists, in the same order


def test_cuts_refuse_as_networkx():
    adj = np.zeros((4, 4), np.uint8)
    adj[0, 1] = adj[1, 0] = adj[2, 3] = adj[3, 2] = 1
    with pytest.raises(ValueError, match="Input graph is not connected"):
        cuts.minimum_node_cut(adj)
    with pytest.raises(ValueError, match="graph is not connected"):
        cuts.stoer_wagner(adj)
    with pytest.raises(ValueError, match="less than two nodes"):
        cuts.stoer_wagner(np.zeros((1, 1), np.uint8))
    # a complete graph: no s-t cut, the neighbours of the min-degree node
    k5 = np.ones((5, 5), np.uint8) - np.eye(5, dtype=np.uint8)
    assert cuts.minimum_node_cut(k5) == nx.minimum_node_cut(nx.from_numpy_array(k5))
