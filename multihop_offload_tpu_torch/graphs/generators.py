"""Host-side random-topology generators.

Port of `multihop_offload_tpu/graphs/generators.py:barabasi_albert`, the one
generator the serving workload calls (`serve/workload.py:synthetic_case`).
The card's machine has no networkx, so the graph is grown here with the
standard library alone, draw for draw as networkx 3.6.1's
`barabasi_albert_graph` grows it with an integer seed:

- `random.Random(seed)` is the generator (networkx's `py_random_state`);
- the initial graph is the star on m + 1 nodes, hub 0;
- `repeated_nodes` lists every node once per incident edge, in node order;
- each new node draws m distinct targets with `rng.choice` into a `set`,
  and the set's own iteration order extends `repeated_nodes`, as
  `_random_subset` does.

The adjacency equals the JAX function's (`_to_adj`) bit for bit.
`unit_disk_adjacency` (JAX `:130`), which the mobility model calls, is the
same scipy rule.  The other generators of that module are not ported yet.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
from scipy.spatial import distance_matrix


def barabasi_albert(n: int, m: int = 2, seed: int = 0) -> Tuple[np.ndarray, None]:
    """BA preferential attachment: ``(adj, None)`` with ``adj`` an (n, n)
    uint8 symmetric 0/1 matrix with zero diagonal."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabási–Albert network must have m >= 1 and m < n, "
                         f"m = {m}, n = {n}")
    rng = random.Random(seed)
    adj = np.zeros((n, n), dtype=np.uint8)
    adj[0, 1:m + 1] = 1
    adj[1:m + 1, 0] = 1
    repeated_nodes = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets: set = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated_nodes))
        for t in targets:
            adj[source, t] = 1
            adj[t, source] = 1
        repeated_nodes.extend(targets)
        repeated_nodes.extend([source] * m)
    return adj, None


def unit_disk_adjacency(pos: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """(n, n) uint8 adjacency of the unit-disk graph over 2-D points: an
    edge where two points lie within `radius`, no self-loops (the
    reference's mobility and Poisson-generator rule)."""
    adj = (distance_matrix(pos, pos) <= radius).astype(np.uint8)
    np.fill_diagonal(adj, 0)
    return adj
