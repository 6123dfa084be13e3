"""PyTorch port of `graphs/mobility.py` and `unit_disk_adjacency` against
the JAX package's functions: under the same `np.random.Generator` the
same positions, adjacencies, topologies and link maps, bit for bit."""

import dataclasses

import numpy as np
import pytest

from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu.graphs import mobility as jmob
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu_torch.graphs import generators as tgen
from multihop_offload_tpu_torch.graphs import mobility as tmob
from multihop_offload_tpu_torch.graphs import topology as ttopo


def _eq_topo(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed,radius", [(0, 1.0), (1, 0.7), (2, 1.5), (3, 0.0)])
def test_unit_disk_adjacency_matches_jax(seed, radius):
    pos = np.random.default_rng(seed).uniform(0, 3, (25, 2))
    got = tgen.unit_disk_adjacency(pos, radius)
    want = jgen.unit_disk_adjacency(pos, radius)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_random_walk_and_topology_update_match_jax(seed):
    """Three mobility steps from a connected Poisson graph: the same moved
    positions and adjacency each step, the same rebuilt topology and link
    map, and per-link state carried the same way."""
    adj, pos, _ = jgen.connected_poisson_disk(16, seed=seed)
    jt, tt = jtopo.build_topology(adj, pos=pos), ttopo.build_topology(adj, pos=pos)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jpos, tpos = pos, pos.copy()
    for _ in range(3):
        jpos, jadj = jmob.random_walk(jpos, n_moving=5, step_std=0.3, rng=jr)
        tpos, tadj = tmob.random_walk(tpos, n_moving=5, step_std=0.3, rng=tr)
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(tadj, jadj)
        jnew, jmap = jmob.topology_update(jt, jadj, pos=jpos)
        tnew, tmap = tmob.topology_update(tt, tadj, pos=tpos)
        _eq_topo(tnew, jnew)
        np.testing.assert_array_equal(tmap, jmap)
        state = np.random.default_rng(seed).uniform(size=(jt.num_links, 3))
        np.testing.assert_array_equal(tmob.migrate_link_state(tmap, state, fill=-1.0),
                                      jmob.migrate_link_state(jmap, state, fill=-1.0))
        jt, tt = jnew, tnew


def test_random_walk_degenerate_inputs_match_jax():
    """No movers, no step, no nodes: the positions come back unchanged;
    a disconnected input raises in both packages."""
    pos = np.random.default_rng(1).uniform(0, 2, (9, 2))
    for kw in ({"n_moving": 0}, {"step_std": 0.0}):
        got = tmob.random_walk(pos, rng=np.random.default_rng(0), **kw)
        want = jmob.random_walk(pos, rng=np.random.default_rng(0), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    empty = np.zeros((0, 2))
    assert tmob.random_walk(empty)[1].shape == jmob.random_walk(empty)[1].shape == (0, 0)
    far = np.array([[0.0, 0.0], [10.0, 10.0], [20.0, 0.0]])
    for mod in (tmob, jmob):
        with pytest.raises(RuntimeError, match="no connected perturbation"):
            mod.random_walk(far, n_moving=1, step_std=0.01, max_tries=3,
                            rng=np.random.default_rng(0))
