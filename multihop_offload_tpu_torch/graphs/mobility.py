"""Node mobility: position jitter + topology rebuild.

Port of `multihop_offload_tpu/graphs/mobility.py` (host NumPy): under the
same `np.random.Generator` every function gives the JAX function's output.
`random_walk` jitters a random subset of node positions until the
unit-disk graph stays connected; `topology_update` rebuilds the topology
and maps each new canonical link to its old id, so that per-link state
(`migrate_link_state`, `sim.state.migrate_sim_state`) can follow it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from multihop_offload_tpu_torch.graphs.generators import unit_disk_adjacency
from multihop_offload_tpu_torch.graphs.topology import Topology, build_topology


def random_walk(
    pos: np.ndarray,
    n_moving: int = 10,
    step_std: float = 0.1,
    radius: float = 1.0,
    bounds: Optional[Tuple[float, float]] = None,
    rng: Optional[np.random.Generator] = None,
    max_tries: int = 1000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Jitter `n_moving` random nodes by N(0, step_std), clipped to
    `bounds` (default the positions' range), until the unit-disk graph is
    connected; returns (new_pos, new_adj).

    An empty fleet, no movers or a zero step return the positions
    unchanged; an exhausted retry budget falls back to the unmoved graph
    when that one is connected.  Only an input that is already
    disconnected raises."""
    rng = rng or np.random.default_rng()  # nondet-ok(explicit caller opt-in: no rng passed)
    n = pos.shape[0]
    if n == 0:
        return pos.copy(), np.zeros((0, 0), dtype=np.uint8)
    if n_moving <= 0 or step_std <= 0.0:
        return pos.copy(), unit_disk_adjacency(pos, radius)
    lo, hi = bounds if bounds is not None else (pos.min(), pos.max())
    for _ in range(max_tries):
        moving = rng.choice(n, size=min(n_moving, n), replace=False)
        cand = pos.copy()
        cand[moving] += rng.normal(0.0, step_std, (moving.size, 2))
        cand = cand.clip(lo, hi)
        adj = unit_disk_adjacency(cand, radius)
        if build_topology(adj).connected:
            return cand, adj
    adj = unit_disk_adjacency(pos, radius)
    if build_topology(adj).connected:
        return pos.copy(), adj
    raise RuntimeError("random_walk: no connected perturbation found")


def topology_update(
    old: Topology, new_adj: np.ndarray, pos: Optional[np.ndarray] = None,
    cf_radius: float = 0.0,
) -> Tuple[Topology, np.ndarray]:
    """(new_topo, link_map): link_map[i] is the old canonical id of new
    link i, or -1 for a link that is new."""
    new_topo = build_topology(new_adj, pos=pos, cf_radius=cf_radius)
    link_map = np.full((new_topo.num_links,), -1, dtype=np.int64)
    for i, (u, v) in enumerate(new_topo.link_ends):
        if u < old.n and v < old.n:
            j = old.link_index[u, v]
            if j >= 0:
                link_map[i] = j
    return new_topo, link_map


def migrate_link_state(
    link_map: np.ndarray, old_state: np.ndarray, fill=0.0
) -> np.ndarray:
    """Carry a per-link array (first axis: links) across a topology
    update; new links get `fill`."""
    new_state = np.full((link_map.shape[0],) + old_state.shape[1:], fill,
                        dtype=old_state.dtype)
    keep = link_map >= 0
    new_state[keep] = old_state[link_map[keep]]
    return new_state
